"""The --pinned_host card-side SH gather (utils/hostmem.py,
csrc/pinned_gather.cu) against the JAX package's pinned_host transport
(clm_gs_tpu/utils/hostmem.py) and against the port's host gather.

A gather is a copy, so its plain version equals the reference's
`PinnedShTable.fetch` (kind="device", as tests/test_hostmem.py runs it on the
CPU) and both packages' `native.gather_rows` to the bit; one clm batch with
--pinned_host equals the same batch without it to the bit (the same rows
are summed in the same order), with and without retention; and it matches
the reference's batch through its forced device-kind table to
tests/test_torch_clm.py's tolerances for one batch from seeded moments.

The cases marked `cuda` need the card and skip elsewhere; the reference is
imported only by the CPU cases, so on the card run
``python -m pytest tests/test_torch_pinned.py --noconftest -q -m cuda``.
"""

import os

import numpy as np
import pytest
import torch

from clm_gs_tpu_torch import _build, config as tconfig
from clm_gs_tpu_torch.optim import AdamConfig
from clm_gs_tpu_torch.strategies import clm_offload as t_clm
from clm_gs_tpu_torch.utils import hostmem, native, pinned_probe

torch.set_num_threads(1)

FIELDS = ("xyz", "opacity", "log_scale", "quat", "sh")
# tests/test_hostmem.py:35-42: duplicates, the first and the last row
HOSTMEM_IDS = [0, 5, 5, 63, 17]


def _table(rows=64, seed=0):
    return np.random.RandomState(seed).rand(rows, 48).astype(np.float32)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_plain_matches_reference_fetch_and_native(dtype):
    from clm_gs_tpu.utils import hostmem as j_hostmem, native as j_native

    buf = _table()
    idx = np.array(HOSTMEM_IDS, np.int32)
    got = hostmem.gather_rows_pinned_plain(torch.from_numpy(buf),
                                           torch.tensor(HOSTMEM_IDS, dtype=dtype))
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(j_hostmem.PinnedShTable(buf, kind="device").fetch(idx)))
    np.testing.assert_array_equal(got.numpy(), j_native.gather_rows(buf, idx))
    np.testing.assert_array_equal(
        got.numpy(), native.gather_rows(torch.from_numpy(buf), torch.from_numpy(idx)).numpy())
    # CPU ids take the plain version
    torch.testing.assert_close(
        hostmem.gather_rows_pinned(torch.from_numpy(buf), torch.tensor(HOSTMEM_IDS)),
        got, rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["float64", "transposed", "cols", "cuda_ids_on_cpu"])
def test_bad_arguments_raise(bad):
    table = torch.from_numpy(_table())
    ids = torch.tensor(HOSTMEM_IDS)
    if bad == "cuda_ids_on_cpu":
        with pytest.raises(ValueError, match="ids on the card"):
            hostmem.gather_rows_pinned_cuda(table, ids)
        return
    table = {"float64": table.double(), "transposed": table[:48].t(),
             "cols": table[:, :47].contiguous()}[bad]
    with pytest.raises(ValueError):
        hostmem.gather_rows_pinned(table, ids)


def _start(state_np, opt_np, pinned, retention):
    """The port's clm context, stripped state and seeded moments
    (tests/test_torch_clm.py `_port_start`), --pinned_host on or off."""
    from clm_gs_tpu_torch import convert
    from clm_gs_tpu_torch.models import gaussians as tG
    from clm_gs_tpu_torch.optim import AdamState
    from tests.test_torch_clm import _cfg, _opt_groups, _seed_host

    cfg = _cfg(tconfig, False, retention)
    cfg.tpu.pinned_host = pinned
    state = convert.state_from_numpy(state_np, device="cpu")
    ctx = t_clm.make_context(cfg, state, AdamConfig())
    assert ctx.card_gather is pinned
    state = t_clm.strip_device_sh(state)
    mu, nu = _opt_groups(opt_np, torch.from_numpy)
    opt = AdamState(tG.GaussianParams(**mu), tG.GaussianParams(**nu),
                    torch.tensor(float(opt_np["steps"])))
    _seed_host(ctx, opt_np, torch.from_numpy)
    return cfg, state, opt, ctx


def _no_host_gather(*args, **kwargs):
    raise AssertionError("native.gather_rows called on the --pinned_host path")


def _no_host_scatter(*args, **kwargs):
    raise AssertionError("native.scatter_add_rows called on the --pinned_host path")


def _port_batch(pinned, retention):
    """One batch from seeded moments on the CPU; the arriving rows of each
    transition are counted, and the gradient rows that go down (downloaded,
    or under --pinned_host scatter-added by the card), of them those the
    card's scatter stores into zero slots, and the rows of each flush whose
    permutation went up."""
    from tests.test_torch_clm import _result
    from tests.test_torch_naive import T_BG, T_LRS, _cams
    from tests.test_torch_train_step import _inputs
    from tests.test_train_synthetic import H, W

    state_np, opt_np, gts = _inputs()
    cfg, state, opt, ctx = _start(state_np, opt_np, pinned, retention)
    arriving, down, stored, permuted = [], [], [], []
    real, real_scatter, real_flush = t_clm._classify_transition, t_clm._scatter, t_clm._flush

    def count(prev_ids, next_ids):
        out = real(prev_ids, next_ids)
        arriving.append(len(out[3]))
        return out

    def counted(fn):
        def wrapper(ctx, rows, *args):
            down.append(rows.shape[0])
            return fn(ctx, rows, *args)
        return wrapper

    def scatter(ctx, rows, ids_dev, n_store=0):
        stored.append(n_store)
        return real_scatter(ctx, rows, ids_dev, n_store)

    def flush(ctx, grad_buf, ids_dev, ids_host, departed=None):
        out = real_flush(ctx, grad_buf, ids_dev, ids_host, departed)
        if 0 < out[2] < len(ids_host):
            permuted.append(len(ids_host))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_clm, "_classify_transition", count)
        mp.setattr(t_clm, "_scatter", counted(scatter))
        mp.setattr(t_clm, "_flush", flush)
        mp.setattr(t_clm, "_download", counted(t_clm._download))
        if pinned:  # the card path never gathers or scatters on the host
            mp.setattr(native, "gather_rows", _no_host_gather)
            mp.setattr(native, "scatter_add_rows", _no_host_scatter)
        try:
            state, opt, ctx, out = t_clm.train_one_batch(
                state, opt, ctx, _cams(), torch.from_numpy(gts), 3, T_LRS, AdamConfig(),
                T_BG, W, H, cfg)
        finally:
            ctx.close()
    res = _result(state, opt, ctx, [out.losses.numpy()], out, lambda t: t.numpy().copy())
    res.update(h2d=ctx.h2d_bytes, d2h=ctx.d2h_bytes, arriving=arriving, down=down,
               stored=stored, permuted=permuted, stored_rows=ctx.stored_rows,
               state_np=state_np, opt_np=opt_np)
    return res


@pytest.mark.parametrize("retention", [True, False])
def test_pinned_batch_equals_host_gather_batch(retention):
    host = _port_batch(False, retention)
    card = _port_batch(True, retention)
    np.testing.assert_array_equal(card["losses"], host["losses"])
    for key in ("params", "mu", "nu"):
        for f in FIELDS:
            np.testing.assert_array_equal(card[key][f], host[key][f], err_msg=f"{key} {f}")
    for key in ("xyz_grad_accum", "denom", "visible_any"):
        np.testing.assert_array_equal(card[key], host[key])
    # the same bytes each way, apart from the arriving rows' int32 ids,
    # which go up with the advance's maps, the gradient rows the card's
    # scatter reads back for its add: those that go down less the first
    # departures it stores, and a flush's int32 permutation
    assert card["arriving"] == host["arriving"]
    assert card["down"] == host["down"] and len(card["down"]) == 4
    assert (len(card["arriving"]) == 3) is retention
    assert 0 < sum(card["stored"]) == card["stored_rows"] <= sum(card["down"])
    assert not any(host["stored"]) and not host["permuted"] and not host["stored_rows"]
    assert card["h2d"] - host["h2d"] == (4 * sum(card["arriving"]) + 4 * sum(card["permuted"])
                                         + 192 * (sum(card["down"]) - sum(card["stored"])))
    assert card["d2h"] == host["d2h"]


def test_pinned_eval_equals_host_gather_eval():
    from tests.test_torch_naive import T_BG, _cams
    from tests.test_torch_train_step import _inputs
    from tests.test_train_synthetic import H, W

    state_np, opt_np, _ = _inputs()
    cb = _cams()
    imgs = {}
    for pinned in (False, True):
        _, state, _, ctx = _start(state_np, opt_np, pinned, True)
        with pytest.MonkeyPatch.context() as mp:
            if pinned:
                mp.setattr(native, "gather_rows", _no_host_gather)
            imgs[pinned] = [t_clm.eval_one_cam((state, ctx), cb.viewmats[b], cb.Ks[b],
                                               cb.camtoworlds[b], 3, T_BG, W, H)
                            for b in range(4)]
        ctx.close()
    for (a, na), (b, nb) in zip(imgs[True], imgs[False]):
        assert na == nb > 0
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.fixture(scope="module")
def reference_pinned():
    """The reference's clm batch with its pinned_host table forced to
    kind="device" (tests/test_hostmem.py:64's setup: a fresh state a run,
    CLMGS_PACK_GRADS=0, here from seeded moments), with and without
    retention."""
    import jax
    import jax.numpy as jnp

    from clm_gs_tpu import config as jconfig, optim as joptim
    from clm_gs_tpu.data.cameras import stack_cameras as j_stack
    from clm_gs_tpu.models import gaussians as jG
    from clm_gs_tpu.strategies import clm_offload as j_clm
    from clm_gs_tpu.utils import hostmem as j_hostmem
    from tests.test_torch_clm import _cfg, _opt_groups, _result, _seed_host
    from tests.test_torch_densify import _jax_state
    from tests.test_torch_native import reference_native
    from tests.test_torch_train_step import _inputs
    from tests.test_train_synthetic import BG, H, ISECT_CAP, LRS, W
    from tests.utils3d import make_camera

    reference_native()
    old = os.environ.get("CLMGS_PACK_GRADS")
    os.environ["CLMGS_PACK_GRADS"] = "0"
    jax.clear_caches()
    try:
        state_np, opt_np, gts = _inputs()
        out = {}
        for retention in (True, False):
            cfg = _cfg(jconfig, False, retention)
            ctx = j_clm.make_context(cfg, _jax_state(state_np), joptim.AdamConfig())
            ctx.pinned = j_hostmem.PinnedShTable(ctx.sh_host, kind="device")
            state = j_clm.strip_device_sh(_jax_state(state_np))
            mu, nu = _opt_groups(opt_np, jnp.asarray)
            opt = joptim.AdamState(jG.GaussianParams(**mu), jG.GaussianParams(**nu),
                                   jnp.asarray(opt_np["steps"]))
            _seed_host(ctx, opt_np, lambda a: a)
            cb = j_stack([make_camera(uid=i, width=W, height=H, angle=0.8 * i)
                          for i in range(4)])
            state, opt, ctx, res = j_clm.train_one_batch(
                state, opt, ctx, cb, jnp.asarray(gts), 3, LRS, joptim.AdamConfig(), BG,
                W, H, ISECT_CAP, cfg)
            out[retention] = _result(state, opt, ctx, [np.array(res.losses)], res,
                                     np.array)
        return out
    finally:
        if old is None:
            os.environ.pop("CLMGS_PACK_GRADS")
        else:
            os.environ["CLMGS_PACK_GRADS"] = old
        jax.clear_caches()


@pytest.mark.parametrize("retention", [True, False])
def test_pinned_batch_matches_reference_pinned_table(reference_pinned, retention):
    """test_torch_clm.py's one-batch tolerances: losses rtol 1e-5, `denom`
    and the visible set exact, parameter moves 1e-4 of the group's largest
    move, first moments 1e-5 of the largest gradient term, second moments
    rtol 1e-5."""
    ref = reference_pinned[retention]
    got = _port_batch(True, retention)
    state_np, opt_np = got["state_np"], got["opt_np"]
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)
    np.testing.assert_array_equal(got["visible_any"], ref["visible_any"])
    np.testing.assert_array_equal(got["denom"], ref["denom"])
    np.testing.assert_allclose(got["xyz_grad_accum"], ref["xyz_grad_accum"],
                               rtol=1e-4, atol=1e-6)
    for f in FIELDS:
        p0 = state_np["params"][f].reshape(ref["params"][f].shape)
        d_ref = ref["params"][f] - p0
        np.testing.assert_allclose(got["params"][f] - p0, d_ref,
                                   atol=1e-4 * np.abs(d_ref).max(), err_msg=f)
        mu0 = opt_np["mu"][f].reshape(ref["mu"][f].shape)
        np.testing.assert_allclose(got["mu"][f], ref["mu"][f],
                                   atol=1e-5 * np.abs(ref["mu"][f] - 0.9 * mu0).max(),
                                   err_msg=f)
        np.testing.assert_allclose(got["nu"][f], ref["nu"][f], rtol=1e-5, err_msg=f)


@pytest.mark.parametrize("strategy", ["--clm_offload", "--no_offload"])
def test_cli_pinned_host(tmp_path, strategy):
    """The CLI with --pinned_host: under clm the log says the card-side
    gather is on and the run (eval, PLY, checkpoint) is the same to the bit
    as without the flag; under no_offload the flag changes nothing."""
    from clm_gs_tpu_torch.train import main
    from clm_gs_tpu_torch.utils.synthetic_colmap import make_dataset

    scene = make_dataset(str(tmp_path / "scene"), device="cpu")
    runs = {}
    for flag in ([], ["--pinned_host"]):
        out = str(tmp_path / ("pinned" if flag else "host"))
        main(["-s", scene, "-m", out, strategy, "--eval", "--llffhold", "5",
              "--bsz", "4", "--iterations", "8", "--test_iterations", "8",
              "--save_iterations", "8", "--quiet"] + flag, device="cpu")
        with open(os.path.join(out, "python.log")) as f:
            log = f.read()
        with open(os.path.join(out, "point_cloud", "iteration_8", "point_cloud.ply"),
                  "rb") as f:
            runs[bool(flag)] = (log, f.read())
    said = [ln for ln in runs[True][0].splitlines() if ln.startswith("pinned_host:")]
    if strategy == "--clm_offload":
        assert said == ["pinned_host: card-side SH gather and gradient scatter on: the "
                        "device reads the rows it fetches out of the pinned host buffer "
                        "and adds the gradients of the rows it drops into the pinned "
                        "gradient buffer (their plain versions on the CPU)"]
    else:
        assert said == []
    assert runs[True][1] == runs[False][1]

    def numbers(log):
        return [ln for ln in log.splitlines() if " loss: " in ln or "Evaluating" in ln]

    assert numbers(runs[True][0]) == numbers(runs[False][0])
    assert any("Evaluating test" in ln for ln in numbers(runs[True][0]))


@pytest.mark.parametrize("n", [0, 1, 13, 8 * 16 * 3 + 5, 663_139])
@pytest.mark.parametrize("sms,most", [(132, hostmem.GATHER_BLOCKS),
                                      (132, hostmem.SCATTER_BLOCKS), (132, 1056),
                                      (8, hostmem.GATHER_BLOCKS), (1, hostmem.GATHER_BLOCKS)])
def test_pinned_grid_covers_every_row_once(n, sms, most):
    """hostmem.pinned_grid in launch_blocks(sms, most) blocks: ranges of
    rows_per_block rows (a multiple of ROW_GROUP) that cover [0, n) once,
    never more blocks than the cap (1/SM_SHARE of the SMs and `most`, at
    least one), and none without a row."""
    cap = hostmem.launch_blocks(sms, most)
    assert cap == max(1, min(most, sms // hostmem.SM_SHARE))
    b, rpb = hostmem.pinned_grid(n, cap)
    if n == 0:
        assert (b, rpb) == (0, 0)
        return
    assert 1 <= b <= cap <= max(1, sms // hostmem.SM_SHARE) and rpb % hostmem.ROW_GROUP == 0
    covered = np.zeros(n, np.int64)
    for k in range(b):
        lo, hi = k * rpb, min(n, (k + 1) * rpb)
        assert lo < hi
        covered[lo:hi] += 1
    assert (covered == 1).all()
    # clm's grids on a 132-SM card, the most of them 1/8 of its SMs
    assert hostmem.launch_blocks(132, hostmem.GATHER_BLOCKS) == 16
    assert hostmem.launch_blocks(132, hostmem.SCATTER_BLOCKS) == 4
    with pytest.raises(ValueError):
        hostmem.pinned_grid(n, 0)
    with pytest.raises(ValueError):
        hostmem.pinned_grid(-1, cap)


# ---- on the card ----

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: csrc/pinned_gather.cu has no CPU mode")
    return torch.device("cuda")


def _ids(n, rows, dtype, seed):
    ids = torch.randint(0, rows, (n,), dtype=dtype,
                        generator=torch.Generator().manual_seed(seed))
    if n >= 4:  # duplicates, the first and the last row
        ids[:4] = torch.tensor([0, rows - 1, 5, 5], dtype=dtype)
    return ids


@pytest.mark.cuda
@pytest.mark.parametrize("n,dtype", [(0, torch.int32), (1, torch.int32),
                                     (5, torch.int64), (1000, torch.int32),
                                     (100_003, torch.int32), (100_003, torch.int64)])
def test_kernel_matches_plain(dev, n, dtype):
    table = torch.from_numpy(_table(5000, seed=n)).pin_memory()
    ids = _ids(n, 5000, dtype, n)
    before = _build.LAUNCHES["pinned_gather"]
    got = hostmem.gather_rows_pinned(table, ids.to(dev))
    torch.cuda.synchronize()
    assert got.device == ids.to(dev).device and got.shape == (n, 48)
    torch.testing.assert_close(got.cpu(), hostmem.gather_rows_pinned_plain(table, ids),
                               rtol=0, atol=0)
    assert _build.LAUNCHES["pinned_gather"] - before == (n > 0)


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", [1, 3, 16, 1056])
@pytest.mark.parametrize("depth", pinned_probe.DEPTHS)
def test_kernel_geometry_matches_plain(dev, blocks, depth):
    """Every grid and depth of the probe's sweep (the source built at each
    PINNED_DEPTH) on a ragged 100,003 ids, int32 and int64."""
    table = torch.from_numpy(_table(5000, seed=depth)).pin_memory()
    for dtype in (torch.int32, torch.int64):
        ids = _ids(100_003, 5000, dtype, blocks)
        got = pinned_probe.variant_kernels(table, None, ids.to(dev), blocks, depth)["gather"]()
        torch.cuda.synchronize()
        torch.testing.assert_close(got.cpu(), hostmem.gather_rows_pinned_plain(table, ids),
                                   rtol=0, atol=0)


@pytest.mark.cuda
def test_pinned_zeros_huge_pages(dev, monkeypatch):
    """pinned_zeros from EXACT_PIN_BYTES up (here 5,000 rows): zeros on a 2
    MiB boundary, registered, read by the kernel, and unregistered when its
    last view goes."""
    import gc

    unregistered = []
    real = hostmem._unregister
    monkeypatch.setattr(hostmem, "_unregister",
                        lambda ptr: (unregistered.append(ptr), real(ptr)))
    monkeypatch.setattr(hostmem, "EXACT_PIN_BYTES", 5000 * 48 * 4)
    t = hostmem.pinned_zeros((5000, 48))
    assert t.is_pinned() and not t.any() and t.data_ptr() % hostmem.HUGE_PAGE == 0
    t.copy_(torch.from_numpy(_table(5000, seed=9)))
    ids = _ids(3000, 5000, torch.int32, 9)
    got = hostmem.gather_rows_pinned(t, ids.to(dev))
    torch.testing.assert_close(got.cpu(), t[ids.long()], rtol=0, atol=0)
    ptr = t.data_ptr()
    del t
    gc.collect()
    assert unregistered == [ptr]


@pytest.mark.cuda
def test_kernel_reads_views_and_registered_memory(dev):
    """A row-offset view of a pinned block (the device address plus the
    view's offset), memory pinned by cudaHostRegister (the allocator's
    pinned_use_cuda_host_register mode), and unpinned memory, which raises."""
    ids = _ids(777, 400, torch.int64, 1)
    base = torch.from_numpy(_table(437, seed=2)).pin_memory()
    view = base[37:]
    got = hostmem.gather_rows_pinned(view, ids.to(dev))
    torch.testing.assert_close(got.cpu(), view[ids], rtol=0, atol=0)

    plain = torch.from_numpy(_table(400, seed=3))
    cudart = torch.cuda.cudart()
    assert int(cudart.cudaHostRegister(plain.data_ptr(), plain.numel() * 4, 0)) == 0
    try:
        got = hostmem.gather_rows_pinned(plain, ids.to(dev))
        torch.cuda.synchronize()
        torch.testing.assert_close(got.cpu(), plain[ids], rtol=0, atol=0)
    finally:
        assert int(cudart.cudaHostUnregister(plain.data_ptr())) == 0
    with pytest.raises(ValueError, match="not in pinned host memory"):
        hostmem.gather_rows_pinned(torch.from_numpy(_table(400, seed=4)), ids.to(dev))


@pytest.mark.cuda
def test_pinned_zeros_page_locks_exactly_its_bytes(dev, monkeypatch):
    """hostmem.pinned_zeros from EXACT_PIN_BYTES up (here 1,000 rows): zeros,
    pinned by registration of its own numpy memory, read by the kernel and
    by an asynchronous copy, and unregistered once its last view is gone;
    below it, the caching allocator's pinned zeros."""
    import gc

    small = hostmem.pinned_zeros((10, 48))
    assert small.is_pinned() and not small.any() and small.shape == (10, 48)
    unregistered = []
    real = hostmem._unregister
    monkeypatch.setattr(hostmem, "_unregister",
                        lambda ptr: (unregistered.append(ptr), real(ptr)))
    monkeypatch.setattr(hostmem, "EXACT_PIN_BYTES", 1000 * 48 * 4)
    t = hostmem.pinned_zeros((1000, 48))
    assert t.is_pinned() and not t.any()
    t.copy_(torch.from_numpy(_table(1000, seed=8)))
    ids = _ids(300, 1000, torch.int32, 8)
    got = hostmem.gather_rows_pinned(t, ids.to(dev))
    torch.testing.assert_close(got.cpu(), t[ids.long()], rtol=0, atol=0)
    back = t.to(dev, non_blocking=True).cpu()
    torch.testing.assert_close(back, t, rtol=0, atol=0)
    view, ptr = t[10:], t.data_ptr()
    del t
    gc.collect()
    assert view.is_pinned() and not unregistered
    del view, got, back
    gc.collect()
    assert unregistered == [ptr]


@pytest.mark.cuda
def test_grow_and_restore_give_the_kernel_new_buffers(dev):
    """grow_context and restore_extra replace sh_host with new pinned
    buffers; the kernel looks the address up on every call and reads the
    new one."""
    from clm_gs_tpu_torch.models import gaussians as tG

    rng = np.random.RandomState(0)
    state = tG.create_from_pcd(rng.normal(size=(50, 3)).astype(np.float32),
                               rng.rand(50, 3), capacity=64, device=dev)
    cfg = tconfig.init_config(tconfig.Config())
    cfg.tpu.pinned_host = True
    ctx = t_clm.make_context(cfg, state, AdamConfig())
    try:
        assert ctx.card_gather and ctx.sh_host.is_pinned()
        ctx.sh_host.copy_(torch.from_numpy(_table(64, seed=5)))

        def check(rows):
            ids = _ids(300, rows, torch.int32, rows)
            got = t_clm._fetch(ctx, ids.to(dev))
            torch.testing.assert_close(got.cpu(), ctx.sh_host[ids.long()], rtol=0, atol=0)

        check(64)
        old = ctx.sh_host.data_ptr()
        ctx = t_clm.grow_context(ctx, 128, cfg)
        ctx.sh_host[64:] = torch.from_numpy(_table(64, seed=6))
        assert ctx.sh_host.data_ptr() != old and ctx.sh_host.is_pinned()
        check(128)
        old = ctx.sh_host.data_ptr()
        extra = t_clm.checkpoint_extra(ctx)
        extra["clm.sh_host"] = _table(128, seed=7)
        ctx = t_clm.restore_extra(ctx, extra)
        assert ctx.sh_host.data_ptr() != old and ctx.sh_host.is_pinned()
        np.testing.assert_array_equal(ctx.sh_host.numpy(), extra["clm.sh_host"])
        check(128)
    finally:
        ctx.close()
