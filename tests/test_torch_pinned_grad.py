"""The D2H half of the --pinned_host transport: the card's scatter-add of SH
gradient rows into the pinned host gradient buffer (utils/hostmem.py
`scatter_add_rows_pinned`, `PinnedGradBuffer`; csrc/pinned_scatter.cu)
against the JAX package's `PinnedGradBuffer` (clm_gs_tpu/utils/hostmem.py:135,
kind="device", as tests/test_hostmem.py runs it on the CPU) and both
packages' `native.scatter_add_rows`.

A scatter-add of unique ids adds one row into each target, so the plain
version equals the references to the bit; the JAX test's within-call
duplicates, which only the plain version takes (the kernel has no atomics),
are summed in another order there and held to rtol 1e-6. One clm batch
with --pinned_host (the gather and the scatter on the card's side) equals
the same batch without it to the bit: losses, the host SH rows, both
moments, and the host gradients a batch under --stop_update_param leaves.

The cases marked `cuda` need the card and skip elsewhere; the reference is
imported only by the CPU cases, so on the card run
``python -m pytest tests/test_torch_pinned_grad.py --noconftest -q -m cuda``.
"""

import numpy as np
import pytest
import torch

from clm_gs_tpu_torch import _build
from clm_gs_tpu_torch.optim import AdamConfig
from clm_gs_tpu_torch.strategies import clm_offload as t_clm
from clm_gs_tpu_torch.utils import hostmem, native, pinned_probe

torch.set_num_threads(1)


def _rows(n, seed):
    return np.random.RandomState(seed).rand(n, 48).astype(np.float32)


def _unique_ids(n, rows, seed, dtype=np.int32):
    return np.random.RandomState(seed).permutation(rows)[:n].astype(dtype)


def test_grad_buffer_matches_reference():
    """Three offloads of unique ids that repeat across calls, with more
    gradient rows than ids (only the prefix is added), then reset_rows:
    equal to the reference's buffer to the bit."""
    import jax.numpy as jnp

    from clm_gs_tpu.utils import hostmem as j_hostmem

    ref = j_hostmem.PinnedGradBuffer((64, 48), kind="device")
    got = hostmem.PinnedGradBuffer((64, 48), device="cpu")
    for k in range(3):
        g = _rows(12, seed=10 + k)
        idx = _unique_ids(9, 20, seed=k)  # rows 0..19: repeats across the calls
        ref.offload(jnp.asarray(g), idx)
        got.offload(torch.from_numpy(g), idx)
    np.testing.assert_array_equal(got.to_numpy(), ref.to_numpy())
    assert np.count_nonzero(got.to_numpy().any(axis=1)) > 9
    reset = np.array([3, 17, 40], np.int32)
    ref.reset_rows(reset)
    got.reset_rows(reset)
    np.testing.assert_array_equal(got.to_numpy(), ref.to_numpy())
    assert not got.to_numpy()[reset].any()


def test_grad_buffer_duplicates_match_reference():
    """tests/test_hostmem.py:102-119's case: duplicate target rows within a
    call and across three calls, against the reference's buffer and
    native.scatter_add_rows (rtol 1e-6, as there)."""
    import jax.numpy as jnp

    from clm_gs_tpu.utils import hostmem as j_hostmem, native as j_native

    rng = np.random.RandomState(2)
    want = np.zeros((64, 48), np.float32)
    ref = j_hostmem.PinnedGradBuffer((64, 48), kind="device")
    got = hostmem.PinnedGradBuffer((64, 48), device="cpu")
    for _ in range(3):
        g = rng.rand(8, 48).astype(np.float32)
        idx = rng.randint(0, 64, size=5).astype(np.int32)
        j_native.scatter_add_rows(want, g[:5], idx, accumulate=True)
        ref.offload(jnp.asarray(g), idx)
        got.offload(torch.from_numpy(g), idx)
    np.testing.assert_allclose(got.to_numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(got.to_numpy(), ref.to_numpy(), rtol=1e-6)


def test_grad_buffer_reset_rows():
    """tests/test_hostmem.py:122-128's case."""
    buf = hostmem.PinnedGradBuffer((16, 48), device="cpu")
    buf.offload(torch.ones((4, 48)), np.array([1, 2], np.int32))
    buf.reset_rows(np.array([1], np.int32))
    out = buf.to_numpy()
    assert out[1].sum() == 0.0 and out[2].sum() == 48.0
    buf.offload(torch.ones((4, 48)), np.array([], np.int32))  # nothing to add
    buf.reset_rows(np.array([], np.int32))
    np.testing.assert_array_equal(buf.to_numpy(), out)


@pytest.mark.parametrize("accumulate", [True, False])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_plain_equals_native_scatter(accumulate, dtype):
    """scatter_add_rows_pinned_plain against both packages'
    native.scatter_add_rows on unique ids: equal to the bit, adding or
    storing; CPU rows take the plain version."""
    from clm_gs_tpu.utils import native as j_native

    base = _rows(300, seed=1)
    g = _rows(120, seed=2)
    idx = _unique_ids(120, 300, seed=3)
    got = torch.from_numpy(base.copy())
    hostmem.scatter_add_rows_pinned_plain(got, torch.from_numpy(g),
                                          torch.from_numpy(idx).to(dtype), accumulate)
    want = base.copy()
    j_native.scatter_add_rows(want, g, idx, accumulate=accumulate)
    np.testing.assert_array_equal(got.numpy(), want)
    port = torch.from_numpy(base.copy())
    native.scatter_add_rows(port, torch.from_numpy(g), torch.from_numpy(idx),
                            accumulate=accumulate)
    np.testing.assert_array_equal(got.numpy(), port.numpy())
    disp = torch.from_numpy(base.copy())
    hostmem.scatter_add_rows_pinned(disp, torch.from_numpy(g), torch.from_numpy(idx),
                                    accumulate)
    np.testing.assert_array_equal(disp.numpy(), want)


@pytest.mark.parametrize("bad", ["float64", "cols", "noncontiguous", "rows_on_cpu"])
def test_bad_arguments_raise(bad):
    table = torch.from_numpy(_rows(64, seed=0))
    g, ids = torch.ones(4, 48), torch.arange(4)
    if bad == "rows_on_cpu":
        with pytest.raises(ValueError, match="rows on the card"):
            hostmem.scatter_add_rows_pinned_cuda(table, g, ids)
        return
    table = {"float64": table.double(), "cols": table[:, :47].contiguous(),
             "noncontiguous": table[::2]}[bad]
    with pytest.raises(ValueError, match="grad_host"):
        hostmem.scatter_add_rows_pinned(table, g, ids)


def _batch(pinned, retention, stop_update):
    """One clm batch from seeded moments on the CPU (tests/test_torch_pinned.py
    `_start`); the card path may neither gather nor scatter on the host."""
    from tests.test_torch_naive import T_BG, T_LRS, _cams
    from tests.test_torch_pinned import _no_host_gather, _no_host_scatter, _start
    from tests.test_torch_train_step import _inputs
    from tests.test_train_synthetic import H, W

    state_np, opt_np, gts = _inputs()
    cfg, state, opt, ctx = _start(state_np, opt_np, pinned, retention)
    cfg.debug.stop_update_param = stop_update
    with pytest.MonkeyPatch.context() as mp:
        if pinned:
            mp.setattr(native, "gather_rows", _no_host_gather)
            mp.setattr(native, "scatter_add_rows", _no_host_scatter)
        try:
            state, opt, ctx, out = t_clm.train_one_batch(
                state, opt, ctx, _cams(), torch.from_numpy(gts), 3, T_LRS, AdamConfig(),
                T_BG, W, H, cfg)
        finally:
            ctx.close()
    return {"losses": out.losses.numpy(), "sh_host": ctx.sh_host.numpy(),
            "exp_avg": ctx.adam.exp_avg.numpy(), "exp_avg_sq": ctx.adam.exp_avg_sq.numpy(),
            "sh_grad_host": ctx.sh_grad_host.numpy(), "xyz": state.params.xyz.numpy()}


@pytest.mark.parametrize("retention", [True, False])
@pytest.mark.parametrize("stop_update", [False, True])
def test_card_scatter_batch_equals_host_scatter_batch(retention, stop_update):
    """With updates the host Adam consumes (and zeroes) every gradient row;
    under --stop_update_param the host gradients stay as the batch's
    scatter-adds left them, so they are compared too."""
    host = _batch(False, retention, stop_update)
    card = _batch(True, retention, stop_update)
    for k in host:
        np.testing.assert_array_equal(card[k], host[k], err_msg=k)
    assert bool(host["sh_grad_host"].any()) is stop_update


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("n_store", [0, 1, 57, 120])
def test_plain_store_split_equals_store_then_add(dtype, n_store):
    """The plain scatter with n_store: the first n_store rows stored (into
    zero slots), the rest added, in one call, equal to the bit to a store
    call of the first rows and an adding call of the rest; a -0.0 stored
    into a zero slot comes out as the add's +0.0."""
    base = _rows(300, seed=4)
    g = _rows(120, seed=5)
    g[0, :3] = -0.0
    idx = torch.from_numpy(_unique_ids(120, 300, seed=6)).to(dtype)
    base[idx[:n_store].long().numpy()] = 0.0
    got = torch.from_numpy(base.copy())
    hostmem.scatter_add_rows_pinned(got, torch.from_numpy(g), idx, n_store=n_store)
    want = torch.from_numpy(base.copy())
    hostmem.scatter_add_rows_pinned_plain(want, torch.from_numpy(g[:n_store]), idx[:n_store],
                                          accumulate=False)
    hostmem.scatter_add_rows_pinned_plain(want, torch.from_numpy(g[n_store:]), idx[n_store:])
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    added = torch.from_numpy(base.copy())
    hostmem.scatter_add_rows_pinned_plain(added, torch.from_numpy(g), idx)
    assert got.numpy().tobytes() == added.numpy().tobytes()
    assert not torch.signbit(got[idx[0].long(), :3]).any() or n_store == 0
    with pytest.raises(ValueError, match="n_store"):
        hostmem.scatter_add_rows_pinned_plain(got, torch.from_numpy(g), idx, n_store=121)


def _batches(pinned, retention, stops):
    """Batches in a row from seeded moments on the CPU, batch k under
    --stop_update_param when stops[k]. Under --pinned_host the plain
    scatter asserts that every slot it stores into is +0.0. Returns (the
    last batch's `_batch` dict, the rows stored by each batch, the
    context's grad_zero after each)."""
    from tests.test_torch_naive import T_BG, T_LRS, _cams
    from tests.test_torch_pinned import _start
    from tests.test_torch_train_step import _inputs
    from tests.test_train_synthetic import H, W

    real = hostmem.scatter_add_rows_pinned_plain

    def plain(grad_host, rows, ids, accumulate=True, n_store=0):
        slots = grad_host[ids[:n_store].cpu().long()]
        assert not slots.any() and not torch.signbit(slots).any(), "a stored slot is not zero"
        return real(grad_host, rows, ids, accumulate, n_store)

    state_np, opt_np, gts = _inputs()
    cfg, state, opt, ctx = _start(state_np, opt_np, pinned, retention)
    stored, clean = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(hostmem, "scatter_add_rows_pinned_plain", plain)
        try:
            for stop in stops:
                cfg.debug.stop_update_param = stop
                before = ctx.stored_rows
                state, opt, ctx, out = t_clm.train_one_batch(
                    state, opt, ctx, _cams(), torch.from_numpy(gts), 3, T_LRS, AdamConfig(),
                    T_BG, W, H, cfg)
                stored.append(ctx.stored_rows - before)
                clean.append(ctx.grad_zero)
        finally:
            ctx.close()
    last = {"losses": out.losses.numpy(), "sh_host": ctx.sh_host.numpy(),
            "exp_avg": ctx.adam.exp_avg.numpy(), "exp_avg_sq": ctx.adam.exp_avg_sq.numpy(),
            "sh_grad_host": ctx.sh_grad_host.numpy(), "xyz": state.params.xyz.numpy()}
    return last, stored, clean


@pytest.mark.parametrize("retention", [True, False])
@pytest.mark.parametrize("stops", [(False, False, False), (True, False, False)])
def test_split_stores_only_into_zero_slots(retention, stops):
    """Three clm batches in a row with --pinned_host: each stores its rows'
    first departures into zero slots (the plain scatter checks every one)
    and the batches equal the host path's to the bit. A batch under
    --stop_update_param leaves its gradients in the buffer: it stores
    nothing, and neither do the batches after it, which add every row."""
    host, host_stored, _ = _batches(False, retention, stops)
    card, card_stored, clean = _batches(True, retention, stops)
    for k in host:
        np.testing.assert_array_equal(card[k], host[k], err_msg=k)
    assert not any(host_stored)
    assert not card["sh_grad_host"].any()  # the last batch consumed every row
    if stops[0]:  # the first batch's gradients were added to, not overwritten
        assert card_stored == [0, 0, 0] and clean == [False] * 3
    else:
        assert all(n > 0 for n in card_stored) and clean == [True] * 3


# ---- on the card ----

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: csrc/pinned_scatter.cu has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("accumulate", [True, False])
@pytest.mark.parametrize("n,dtype", [(0, torch.int32), (1, torch.int32), (5, torch.int64),
                                     (1000, torch.int32), (4000, torch.int64)])
def test_kernel_matches_plain(dev, n, dtype, accumulate):
    table = torch.from_numpy(_rows(5000, seed=n)).pin_memory()
    want = table.clone()
    g = torch.from_numpy(_rows(n, seed=n + 1))
    ids = torch.from_numpy(_unique_ids(n, 5000, seed=n + 2)).to(dtype)
    hostmem.scatter_add_rows_pinned_plain(want, g, ids, accumulate)
    before = _build.LAUNCHES["pinned_scatter"]
    hostmem.scatter_add_rows_pinned(table, g.to(dev), ids.to(dev), accumulate)
    torch.cuda.synchronize()
    torch.testing.assert_close(table, want, rtol=0, atol=0)
    assert _build.LAUNCHES["pinned_scatter"] - before == (n > 0)


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", [1, 3, 16, 1056])
@pytest.mark.parametrize("depth", pinned_probe.DEPTHS)
@pytest.mark.parametrize("n_store", [0, 1, 2345, 4001])
def test_kernel_geometry_and_split_match_plain(dev, blocks, depth, n_store):
    """Every grid and depth of the probe's sweep (the source built at each
    PINNED_DEPTH), adding with the first n_store rows stored into zero
    slots and storing, against the plain version to the bit (the ragged
    4,001 rows over `blocks` ranges); clm's own launch too."""
    n = 4001
    table = torch.from_numpy(_rows(9000, seed=blocks + depth)).pin_memory()
    g = torch.from_numpy(_rows(n, seed=depth))
    g[0, :4] = -0.0
    ids = torch.from_numpy(_unique_ids(n, 9000, seed=n_store))
    table[ids[:n_store].long()] = 0.0
    start = table.clone()
    for accumulate in (True, False):
        table.copy_(start)
        want = start.clone()
        hostmem.scatter_add_rows_pinned_plain(want, g, ids, accumulate, n_store)
        kernels = pinned_probe.variant_kernels(table, g.to(dev), ids.to(dev), blocks, depth,
                                               n_store)
        kernels["scatter_add" if accumulate else "scatter_store"]()
        torch.cuda.synchronize()
        assert table.numpy().tobytes() == want.numpy().tobytes()
        table.copy_(start)
        hostmem.scatter_add_rows_pinned_cuda(table, g.to(dev), ids.to(dev), accumulate,
                                             n_store)
        torch.cuda.synchronize()
        assert table.numpy().tobytes() == want.numpy().tobytes()


@pytest.mark.cuda
def test_kernel_reads_rows_the_host_rewrote(dev):
    """Rows written by one launch, then zeroed by the host (as the host Adam
    does), then added to by a second launch: the second add reads the
    zeros, not a line the first launch left in the L2."""
    table = hostmem.pinned_zeros((1000, 48))
    ids = torch.from_numpy(_unique_ids(600, 1000, seed=4)).to(dev)
    a = torch.from_numpy(_rows(600, seed=5)).to(dev)
    b = torch.from_numpy(_rows(600, seed=6)).to(dev)
    hostmem.scatter_add_rows_pinned(table, a, ids)
    torch.cuda.synchronize()
    torch.testing.assert_close(table[ids.cpu().long()], a.cpu(), rtol=0, atol=0)
    table.zero_()
    hostmem.scatter_add_rows_pinned(table, b, ids)
    torch.cuda.synchronize()
    torch.testing.assert_close(table[ids.cpu().long()], b.cpu(), rtol=0, atol=0)
    assert np.count_nonzero(table.numpy().any(axis=1)) == 600


@pytest.mark.cuda
def test_kernel_writes_views_and_registered_memory(dev):
    """A row-offset view of a pinned block, memory pinned by
    cudaHostRegister (as pinned_zeros does from 1 GiB up), and unpinned
    memory, which raises."""
    ids = torch.from_numpy(_unique_ids(300, 400, seed=7, dtype=np.int64))
    g = torch.from_numpy(_rows(300, seed=8))
    base = torch.from_numpy(_rows(437, seed=9)).pin_memory()
    view = base[37:]
    want = view.clone()
    hostmem.scatter_add_rows_pinned_plain(want, g, ids)
    hostmem.scatter_add_rows_pinned(view, g.to(dev), ids.to(dev))
    torch.cuda.synchronize()
    torch.testing.assert_close(view, want, rtol=0, atol=0)

    plain = torch.from_numpy(_rows(400, seed=10))
    want = plain.clone()
    hostmem.scatter_add_rows_pinned_plain(want, g, ids)
    cudart = torch.cuda.cudart()
    assert int(cudart.cudaHostRegister(plain.data_ptr(), plain.numel() * 4, 2)) == 0
    try:
        hostmem.scatter_add_rows_pinned(plain, g.to(dev), ids.to(dev))
        torch.cuda.synchronize()
        torch.testing.assert_close(plain, want, rtol=0, atol=0)
    finally:
        assert int(cudart.cudaHostUnregister(plain.data_ptr())) == 0
    with pytest.raises(ValueError, match="grad_host is not in pinned host memory"):
        hostmem.scatter_add_rows_pinned(torch.from_numpy(_rows(400, seed=11)), g.to(dev),
                                        ids.to(dev))


@pytest.mark.cuda
def test_grad_buffer_on_the_card(dev):
    """PinnedGradBuffer with gradient rows on the card: offloads of unique
    ids through the kernel, reset_rows and to_numpy after them, equal to
    the same on the CPU."""
    on_card = hostmem.PinnedGradBuffer((64, 48), device=dev)
    on_cpu = hostmem.PinnedGradBuffer((64, 48), device="cpu")
    assert on_card.table.is_pinned()
    for k in range(3):
        g = torch.from_numpy(_rows(12, seed=20 + k))
        idx = _unique_ids(9, 20, seed=30 + k)
        on_card.offload(g.to(dev), idx)
        on_cpu.offload(g, idx)
    np.testing.assert_array_equal(on_card.to_numpy(), on_cpu.to_numpy())
    on_card.reset_rows(np.array([3, 4], np.int32))
    on_cpu.reset_rows(np.array([3, 4], np.int32))
    np.testing.assert_array_equal(on_card.to_numpy(), on_cpu.to_numpy())


def test_probe_needs_a_card():
    """utils/pinned_probe.py measures on the card only: without one it
    raises before it allocates a table."""
    from clm_gs_tpu_torch.utils import pinned_probe

    if torch.cuda.is_available():
        pytest.skip("the card is there: the probe would run")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pinned_probe.probe(rows=(64,), n=8)
