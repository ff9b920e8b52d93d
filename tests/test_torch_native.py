"""Port vs reference: the host Adam library and its binding.

Both packages build the same C++ source with the same flags, so the port's
HostAdam must equal the JAX package's bit for bit; against its plain torch
version it agrees within 1e-6 of each array's largest value (float32 order
of operations; fused multiply-adds in the library).
"""

import importlib
import time

import numpy as np
import pytest
import torch

from clm_gs_tpu.utils import native as jnative
from clm_gs_tpu_torch import _build
from clm_gs_tpu_torch.utils import native as tnative

N, SEED = 9000, 3  # more than 4096 indices: the library splits them over threads


def reference_native():
    """The JAX package's native module with its libraries loaded. Each test
    process that imports the module builds the libraries when they are
    missing, so one process can read a file while another's build is
    writing it, and then falls back to numpy for good; loading again finds
    the finished file."""
    for _ in range(30):
        if jnative.have_native_adam() and jnative.have_native_tsp():
            return jnative
        time.sleep(1.0)
        importlib.reload(jnative)
    raise RuntimeError("the JAX package's native libraries do not load")


# Every test process imports this module while collecting, before it runs
# any test: a process that lost the race above is repaired for the whole
# suite, the JAX package's own offload tests included.
reference_native()


def _arrays(rng, n, cols):
    return {
        "params": rng.normal(size=(n, cols)).astype(np.float32),
        "grads": rng.normal(size=(n, cols)).astype(np.float32),
        "exp_avg": (0.01 * rng.normal(size=(n, cols))).astype(np.float32),
        "exp_avg_sq": rng.uniform(1e-4, 1e-2, (n, cols)).astype(np.float32),
        "lr": rng.uniform(1e-4, 1e-2, cols).astype(np.float32),
    }


@pytest.mark.parametrize("cols", [1, 3, 4, 48])
def test_host_adam_equals_reference_exactly(cols):
    """Sparse and dense steps, grow, and grad zeroing."""
    reference_native()
    rng = np.random.RandomState(SEED + cols)
    a = _arrays(rng, N, cols)
    j = jnative.HostAdam(N, cols, a["lr"], betas=(0.9, 0.999), eps=1e-15)
    t = tnative.HostAdam(N, cols, torch.from_numpy(a["lr"]))
    jp, jg = a["params"].copy(), a["grads"].copy()
    tp, tg = torch.from_numpy(a["params"].copy()), torch.from_numpy(a["grads"].copy())
    j.exp_avg, j.exp_avg_sq = a["exp_avg"].copy(), a["exp_avg_sq"].copy()
    t.exp_avg = torch.from_numpy(a["exp_avg"].copy())
    t.exp_avg_sq = torch.from_numpy(a["exp_avg_sq"].copy())

    def same():
        np.testing.assert_array_equal(tp.numpy(), jp)
        np.testing.assert_array_equal(tg.numpy(), jg)
        np.testing.assert_array_equal(t.exp_avg.numpy(), j.exp_avg)
        np.testing.assert_array_equal(t.exp_avg_sq.numpy(), j.exp_avg_sq)

    idx = np.sort(rng.choice(N, 5000, replace=False)).astype(np.int32)
    for step in (1, 2, 7):
        j.sparse_step(jp, jg, idx, grad_scale=0.25, step=step)
        t.sparse_step(tp, tg, torch.from_numpy(idx), grad_scale=0.25, step=step)
        same()
        assert not tg.numpy()[idx].any() and tg.numpy().any()
        jg[:] = tg.numpy()[:] = rng.normal(size=(N, cols)).astype(np.float32)
    j.dense_step(jp, jg, N - 10, grad_scale=1.0 / 3, step=8)
    t.dense_step(tp, tg, N - 10, grad_scale=1.0 / 3, step=8)
    same()
    j.grow(N + 500)
    t.grow(N + 500)
    jp = np.concatenate([jp, np.ones((500, cols), np.float32)])
    jg = np.concatenate([jg, rng.normal(size=(500, cols)).astype(np.float32)])
    tp, tg = torch.from_numpy(jp.copy()), torch.from_numpy(jg.copy())
    same()
    idx = np.arange(N - 100, N + 500, dtype=np.int32)
    j.sparse_step(jp, jg, idx, step=9)
    t.sparse_step(tp, tg, idx, step=9)
    same()


@pytest.mark.parametrize("dense", [False, True])
def test_host_adam_matches_plain(dense):
    rng = np.random.RandomState(SEED)
    a = _arrays(rng, N, 48)
    t = tnative.HostAdam(N, 48, torch.from_numpy(a["lr"]), betas=(0.81, 0.998001),
                         eps=1e-15 / 2)
    p = {k: torch.from_numpy(a[k].copy()) for k in ("params", "grads")}
    ref = {k: torch.from_numpy(a[k].copy())
           for k in ("params", "grads", "exp_avg", "exp_avg_sq")}
    t.exp_avg, t.exp_avg_sq = ref["exp_avg"].clone(), ref["exp_avg_sq"].clone()
    idx = (torch.arange(N - 7, dtype=torch.int32) if dense
           else torch.from_numpy(np.sort(rng.choice(N, 4500, replace=False))
                                 .astype(np.int32)))
    for step in (1, 2, 5):
        if dense:
            t.dense_step(p["params"], p["grads"], N - 7, grad_scale=0.5, step=step)
        else:
            t.sparse_step(p["params"], p["grads"], idx, grad_scale=0.5, step=step)
        tnative.host_adam_step_plain(
            ref["params"], ref["grads"], ref["exp_avg"], ref["exp_avg_sq"], idx,
            torch.from_numpy(a["lr"]), t.betas, t.eps, 0.5, step)
        for got, want in ((p["params"], ref["params"]), (t.exp_avg, ref["exp_avg"]),
                          (t.exp_avg_sq, ref["exp_avg_sq"])):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                       atol=1e-6 * want.abs().max().item())
        torch.testing.assert_close(p["grads"], ref["grads"], rtol=0, atol=0)
        fresh = torch.from_numpy(rng.normal(size=(N, 48)).astype(np.float32))
        p["grads"].copy_(fresh)
        ref["grads"].copy_(fresh)


def _bad_inputs():
    base = torch.zeros(64, 4)
    return {
        "transposed": torch.zeros(4, 64).T,
        "column_slice": torch.zeros(64, 8)[:, :4],
        "float64": base.double(),
        "wrong_rows": torch.zeros(63, 4),
    }


@pytest.mark.parametrize("kind", sorted(_bad_inputs()))
@pytest.mark.parametrize("which", ["params", "grads"])
def test_bad_buffer_raises(kind, which):
    """A view the library would misread, another dtype or shape raises
    before the library sees a pointer; the buffers stay untouched."""
    adam = tnative.HostAdam(64, 4, torch.ones(4))
    bufs = {"params": torch.zeros(64, 4), "grads": torch.ones(64, 4)}
    bufs[which] = _bad_inputs()[kind]
    before = {k: v.clone() for k, v in bufs.items()}
    with pytest.raises(ValueError):
        adam.sparse_step(bufs["params"], bufs["grads"], torch.arange(8), step=1)
    for k in bufs:
        assert torch.equal(bufs[k], before[k])


def test_opacity_column_view_is_accepted():
    """(C,) opacity viewed as (C, 1) is contiguous and goes through."""
    adam = tnative.HostAdam(5000, 1, torch.full((1,), 0.1))
    op = torch.zeros(5000)
    g = torch.ones(5000)
    adam.sparse_step(op.view(5000, 1), g.view(5000, 1), torch.arange(5000), step=1)
    assert torch.allclose(op, torch.full((5000,), -0.1)) and not g.any()


def test_indices_out_of_range_raise():
    adam = tnative.HostAdam(16, 3, torch.ones(3))
    p, g = torch.zeros(16, 3), torch.zeros(16, 3)
    for idx in ([0, 16], [-1, 2]):
        with pytest.raises(ValueError, match="out of range"):
            adam.sparse_step(p, g, torch.tensor(idx), step=1)


def test_host_threads_override(monkeypatch):
    monkeypatch.delenv("CLMGS_HOST_THREADS", raising=False)
    assert 1 <= tnative.host_threads() <= 4
    monkeypatch.setenv("CLMGS_HOST_THREADS", "7")
    assert tnative.host_threads() == 7 == jnative.host_threads()


def test_failed_host_build_raises(tmp_path):
    (tmp_path / "broken_adam.cpp").write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="failed"):
        _build.build_host("broken_adam", src_dir=tmp_path)
    assert not (_build.BUILD / "libbroken_adam.so").exists()


# ---- the clm_offload bindings: each against its plain twin and the JAX
# package's binding (tests/test_aux.py), exactly ----

def _same(got, *wants):
    for want in wants:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("n", [1, 2, 5, 12])
def test_find_tour_matches_plain_and_reference(n):
    reference_native()
    rng = np.random.RandomState(n)
    a = rng.randint(0, 1000, (n, n))
    dist = (a + a.T).astype(np.int32)
    got = tnative.find_tour(torch.from_numpy(dist), time_budget_s=10.0)
    assert got.dtype == torch.int32 and sorted(got.tolist()) == list(range(n))
    _same(got, tnative.find_tour_plain(torch.from_numpy(dist)),
          jnative.find_tour(dist, time_budget_s=10.0))


def test_find_tour_converges_at_64_cameras():
    """A bsz-64 batch's order does not depend on the time budget: up to 64
    cameras the 2-opt runs to convergence, also under a budget that would
    cut it (the reference's own tour, given time to converge)."""
    reference_native()
    grid = np.stack(np.meshgrid(np.arange(8), np.arange(8)), -1).reshape(-1, 2)
    a = np.abs(grid[:, None] - grid[None]).sum(-1) * 1000
    a = a + np.random.RandomState(64).randint(0, 50, (64, 64))
    dist = np.minimum(a, a.T).astype(np.int32)
    got = tnative.find_tour(torch.from_numpy(dist), time_budget_s=1e-9)
    _same(got, tnative.find_tour(torch.from_numpy(dist)),
          tnative.find_tour_plain(torch.from_numpy(dist)),
          jnative.find_tour(dist, time_budget_s=10.0))


def test_gather_and_scatter_rows_match_plain_and_reference():
    reference_native()
    rng = np.random.RandomState(SEED)
    buf = rng.normal(size=(N, 48)).astype(np.float32)
    idx = rng.choice(N, 5000, replace=False).astype(np.int32)
    tb = torch.from_numpy(buf.copy())
    out = torch.empty(5000, 48)
    assert tnative.gather_rows(tb, torch.from_numpy(idx), out=out) is out
    _same(out, tnative.gather_rows_plain(tb, idx), jnative.gather_rows(buf, idx))
    rows = rng.normal(size=(5000, 48)).astype(np.float32)
    for accumulate in (True, False):
        t, p, j = tb.clone(), tb.clone(), buf.copy()
        tnative.scatter_add_rows(t, torch.from_numpy(rows), torch.from_numpy(idx),
                                 accumulate)
        tnative.scatter_add_rows_plain(p, torch.from_numpy(rows), idx, accumulate)
        jnative.scatter_add_rows(j, rows, idx, accumulate)
        _same(t, p, j)


def test_finish_set_primitives_match_plain_and_reference():
    """stamp_rows, nonzero_stamp (both modes) and counting_sort_perm."""
    reference_native()
    rng = np.random.RandomState(2)
    C, B = 300_001, 9
    t_lu = torch.full((C,), -1, dtype=torch.int16)
    p_lu, j_lu = t_lu.clone(), np.full(C, -1, np.int16)
    for s in range(B):
        ids = np.sort(rng.choice(C, 40_000, replace=False)).astype(np.int32)
        tnative.stamp_rows(t_lu, torch.from_numpy(ids), s)
        tnative.stamp_rows_plain(p_lu, ids, s)
        assert jnative.stamp_rows(j_lu, ids, s)
    _same(t_lu, p_lu, j_lu)
    alive = rng.rand(C) < 0.5
    t_alive = torch.from_numpy(alive)
    for mode in (0, 1):
        got = tnative.nonzero_stamp(t_lu, t_alive, mode)
        assert got.dtype == torch.int32
        _same(got, tnative.nonzero_stamp_plain(t_lu, t_alive, mode),
              jnative.nonzero_stamp(j_lu, alive, mode))
    keys = rng.randint(0, 17, 100_001).astype(np.int16)
    perm, counts = tnative.counting_sort_perm(torch.from_numpy(keys), 17)
    p_perm, p_counts = tnative.counting_sort_perm_plain(torch.from_numpy(keys), 17)
    j_perm, j_counts = jnative.counting_sort_perm(keys, 17)
    assert perm.dtype == torch.int32 and counts.dtype == torch.int64
    _same(perm, p_perm, j_perm)
    _same(counts, p_counts, j_counts)


@pytest.mark.parametrize("na,nb", [(0, 5), (5, 0), (0, 0), (1000, 1300), (4096, 4096)])
def test_classify_sorted_matches_plain_and_reference(na, nb):
    reference_native()
    rng = np.random.RandomState(11 + na + nb)
    a = np.sort(rng.choice(10_000, size=na, replace=False)).astype(np.int32)
    b = np.sort(rng.choice(10_000, size=nb, replace=False)).astype(np.int32)
    got = tnative.classify_sorted(torch.from_numpy(a), torch.from_numpy(b))
    plain = tnative.classify_sorted_plain(torch.from_numpy(a), torch.from_numpy(b))
    for g, p, j in zip(got, plain, jnative.classify_sorted(a, b)):
        assert g.dtype == torch.int32
        _same(g, p, j)


def _bad_binding_calls():
    """Calls that hand a library a buffer it would misread, another dtype or
    shape, or an id out of range."""
    buf, ids = torch.zeros(64, 48), torch.arange(8, dtype=torch.int32)
    lu = torch.full((64,), -1, dtype=torch.int16)
    return {
        "gather_transposed": lambda: tnative.gather_rows(torch.zeros(48, 64).T, ids),
        "gather_float64": lambda: tnative.gather_rows(buf.double(), ids),
        "gather_id_out_of_range": lambda: tnative.gather_rows(buf, torch.tensor([0, 64])),
        "gather_out_shape": lambda: tnative.gather_rows(buf, ids, out=torch.empty(7, 48)),
        "scatter_rows_shape": lambda: tnative.scatter_add_rows(buf, torch.ones(7, 48), ids),
        "scatter_column_slice": lambda: tnative.scatter_add_rows(
            torch.zeros(64, 96)[:, :48], torch.ones(8, 48), ids),
        "scatter_negative_id": lambda: tnative.scatter_add_rows(
            buf, torch.ones(2, 48), torch.tensor([-1, 3])),
        "stamp_int32_stamps": lambda: tnative.stamp_rows(lu.int(), ids, 0),
        "stamp_id_out_of_range": lambda: tnative.stamp_rows(lu, torch.tensor([64]), 0),
        "stamp_pos_outside_int16": lambda: tnative.stamp_rows(lu, ids, 2**15),
        "nonzero_alive_uint8": lambda: tnative.nonzero_stamp(
            lu, torch.ones(64, dtype=torch.uint8), 1),
        "nonzero_no_alive": lambda: tnative.nonzero_stamp(lu, None, 1),
        "nonzero_mode": lambda: tnative.nonzero_stamp(lu, None, 2),
        "sort_key_out_of_range": lambda: tnative.counting_sort_perm(
            torch.tensor([0, 3], dtype=torch.int16), 3),
        "sort_int32_keys": lambda: tnative.counting_sort_perm(torch.tensor([0, 1]), 3),
        "classify_int64": lambda: tnative.classify_sorted(torch.arange(3), ids),
        "classify_strided": lambda: tnative.classify_sorted(ids[::2], ids),
        "tour_not_square": lambda: tnative.find_tour(torch.zeros(3, 4, dtype=torch.int32)),
        "tour_float": lambda: tnative.find_tour(torch.zeros(3, 3)),
        "tour_on_numpy": lambda: tnative.find_tour(np.zeros((3, 3), np.int32)),
    }


@pytest.mark.parametrize("kind", sorted(_bad_binding_calls()))
def test_binding_checks_raise(kind):
    with pytest.raises(ValueError):
        _bad_binding_calls()[kind]()
