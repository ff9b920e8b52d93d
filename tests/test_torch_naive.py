"""Port vs reference: the naive_offload strategy (parameters and Adam moments
on the host, the native host Adam).

The same numpy scene goes through both packages' `naive_offload`, on the
tiny scene of test_torch_train_step.py, the reference with its f32
rasterizer gradients (CLMGS_PACK_GRADS=0). One batch from seeded moments
uses that file's tolerances: losses rtol 1e-5, parameter moves 1e-4 of the
group's largest move, `denom` exact. Eight batches from zero moments use the
reference's own strategy-parity bounds (tests/test_strategies.py: batch-mean
losses rtol 5e-3 atol 5e-4, parameters rtol 0.05 atol 2e-3), against the
reference's naive_offload and against the port's no_offload.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clm_gs_tpu import config as jconfig, optim as joptim
from clm_gs_tpu.data.cameras import stack_cameras as j_stack
from clm_gs_tpu.models import densify as jD
from clm_gs_tpu.strategies import naive_offload as j_naive
from clm_gs_tpu_torch import config as tconfig, convert, optim as toptim
from clm_gs_tpu_torch.data.cameras import stack_cameras as t_stack
from clm_gs_tpu_torch.models import densify as tD
from clm_gs_tpu_torch.strategies import naive_offload as t_naive
from clm_gs_tpu_torch.strategies import no_offload as t_no_offload
from clm_gs_tpu_torch.utils.bench_scene import make_camera as t_make_camera
from tests.test_strategies import N_STEPS, _perturbed
from tests.test_torch_densify import _both, _densify_inputs, _jax_state
from tests.test_torch_native import reference_native
from tests.test_torch_train_step import _inputs
from tests.test_train_synthetic import BG, H, ISECT_CAP, LRS, W
from tests.utils3d import make_camera

torch.set_num_threads(1)

FIELDS = ("xyz", "opacity", "log_scale", "quat", "sh")
COLS = {"xyz": 3, "opacity": 1, "log_scale": 3, "quat": 4, "sh": 48}
T_LRS = {k: torch.tensor(np.asarray(v)) for k, v in LRS.items()}
T_BG = torch.tensor(np.asarray(BG))


def _cfg(pkg, sparse=False):
    """test_strategies.py's _mk_cfg, for either package."""
    cfg = pkg.Config()
    cfg.aux.naive_offload = True
    cfg.aux.sparse_adam = sparse
    cfg.opt.bsz = 4
    cfg.opt.lr_scale_mode = "accumu"
    return pkg.init_config(cfg)


def _seed(ctx, opt_np, buf):
    """Host moments at the step count of `opt_np`, copied: the host Adam
    updates them in place. `buf` makes the package's array from numpy."""
    for f, cols in COLS.items():
        a = ctx.adams[f]
        a.exp_avg = buf(np.array(opt_np["mu"][f], np.float32).reshape(-1, cols))
        a.exp_avg_sq = buf(np.array(opt_np["nu"][f], np.float32).reshape(-1, cols))
        a.step_count = int(opt_np["steps"])


def _host(ctx, f):
    v = ctx.params_host[f]
    return v.numpy() if torch.is_tensor(v) else np.asarray(v)


def _moments(ctx):
    return {f: tuple(np.array(getattr(ctx.adams[f], k)) for k in ("exp_avg", "exp_avg_sq"))
            for f in FIELDS}


def _run_jax(state_np, gts, sparse, n_batches, opt_np=None):
    cfg = _cfg(jconfig, sparse)
    state = _jax_state(state_np)
    ctx = j_naive.make_context(cfg, state, joptim.AdamConfig())
    if opt_np is not None:
        _seed(ctx, opt_np, lambda a: a)
    state = j_naive.strip_device_params(state)
    cb = j_stack([make_camera(uid=i, width=W, height=H, angle=0.8 * i)
                  for i in range(4)])
    losses = []
    for _ in range(n_batches):
        state, opt, ctx, out = j_naive.train_one_batch(
            state, None, ctx, cb, jnp.asarray(gts), 3, LRS, joptim.AdamConfig(),
            BG, W, H, ISECT_CAP, cfg)
        assert opt is None and int(out.max_isects) <= ISECT_CAP
        losses.append(np.asarray(out.losses))
    return {"params": {f: _host(ctx, f).reshape(state_np["params"][f].shape)
                       for f in FIELDS},
            "moments": _moments(ctx), "losses": np.array(losses),
            "xyz_grad_accum": np.array(state.xyz_grad_accum),
            "denom": np.array(state.denom), "visible_any": np.array(out.visible_any),
            "max_isects": int(out.max_isects)}


def _cams():
    return t_stack([t_make_camera(uid=i, width=W, height=H, angle=0.8 * i)
                    for i in range(4)], device="cpu")


def _run_port(state_np, gts, sparse, n_batches, opt_np=None):
    cfg = _cfg(tconfig, sparse)
    state = convert.state_from_numpy(state_np, device="cpu")
    ctx = t_naive.make_context(cfg, state, toptim.AdamConfig())
    if opt_np is not None:
        _seed(ctx, opt_np, torch.from_numpy)
    state = t_naive.strip_device_params(state)
    cb = _cams()
    losses = []
    for _ in range(n_batches):
        state, opt, ctx, out = t_naive.train_one_batch(
            state, None, ctx, cb, torch.from_numpy(gts), 3, T_LRS,
            toptim.AdamConfig(), T_BG, W, H, cfg)
        assert opt is None and t_naive._is_stripped(state)
        losses.append(out.losses.numpy())
    return {"params": {f: _host(ctx, f).reshape(state_np["params"][f].shape)
                       for f in FIELDS},
            "moments": _moments(ctx), "losses": np.array(losses),
            "xyz_grad_accum": state.xyz_grad_accum.numpy(),
            "denom": state.denom.numpy(), "visible_any": out.visible_any.numpy(),
            "max_isects": out.max_isects, "n_isects": out.n_isects}


def _run_no_offload(state_np, gts, sparse, n_batches):
    state = convert.state_from_numpy(state_np, device="cpu")
    opt = toptim.init_adam(state.params)
    cb = _cams()
    losses = []
    for _ in range(n_batches):
        state, opt, out = t_no_offload.train_step(
            state, opt, cb, torch.from_numpy(gts), 3, T_LRS, toptim.AdamConfig(),
            T_BG, W, H, sparse_adam=sparse)
        losses.append(out.losses.numpy())
    return {"params": convert.state_to_numpy(state)["params"],
            "losses": np.array(losses)}


def _perturbed_np():
    """test_strategies.py's perturbed scene and its rendered images, as numpy."""
    state, _, gts = _perturbed()
    d = {"params": {f: np.array(getattr(state.params, f)) for f in FIELDS},
         "alive": np.array(state.alive), "n_alive": np.array(state.n_alive)}
    d.update({f: np.array(getattr(state, f))
              for f in ("xyz_grad_accum", "denom", "max_radii2d")})
    return d, np.array(gts)


@pytest.fixture(scope="module")
def reference():
    """The reference's naive_offload: one batch from seeded moments and
    N_STEPS batches from zero moments, for both sparse_adam values."""
    reference_native()
    old = os.environ.get("CLMGS_PACK_GRADS")
    os.environ["CLMGS_PACK_GRADS"] = "0"
    jax.clear_caches()
    try:
        state_np, opt_np, gts = _inputs()
        pert_np, pert_gts = _perturbed_np()
        one = {sp: _run_jax(state_np, gts, sp, 1, opt_np) for sp in (False, True)}
        many = {sp: _run_jax(pert_np, pert_gts, sp, N_STEPS) for sp in (False, True)}
        return (state_np, opt_np, gts, one), (pert_np, pert_gts, many)
    finally:
        if old is None:
            os.environ.pop("CLMGS_PACK_GRADS")
        else:
            os.environ["CLMGS_PACK_GRADS"] = old
        jax.clear_caches()


@pytest.mark.parametrize("sparse_adam", [False, True])
def test_one_batch_matches_reference(reference, sparse_adam):
    state_np, opt_np, gts, one = reference[0]
    ref = one[sparse_adam]
    got = _run_port(state_np, gts, sparse_adam, 1, opt_np)
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)
    np.testing.assert_array_equal(got["visible_any"], ref["visible_any"])
    assert got["max_isects"] == ref["max_isects"] == max(got["n_isects"])
    np.testing.assert_array_equal(got["denom"], ref["denom"])
    np.testing.assert_allclose(got["xyz_grad_accum"], ref["xyz_grad_accum"],
                               rtol=1e-4, atol=1e-6)
    for f in FIELDS:
        p0 = state_np["params"][f]
        d_ref = ref["params"][f] - p0
        np.testing.assert_allclose(got["params"][f] - p0, d_ref,
                                   atol=1e-4 * np.abs(d_ref).max(), err_msg=f)
        # the first moment 0.9 mu + 0.1 g holds the gradient: 1e-5 of its
        # largest value, as test_torch_train_step.py
        mu0 = opt_np["mu"][f].reshape(-1, COLS[f])
        (m_got, v_got), (m_ref, v_ref) = got["moments"][f], ref["moments"][f]
        np.testing.assert_allclose(m_got, m_ref,
                                   atol=1e-5 * np.abs(m_ref - 0.9 * mu0).max(), err_msg=f)
        np.testing.assert_allclose(v_got, v_ref, rtol=1e-5, err_msg=f)
    if sparse_adam:
        hidden = ~ref["visible_any"]
        assert hidden.any()
        for f in FIELDS:
            np.testing.assert_array_equal(got["params"][f][hidden],
                                          state_np["params"][f][hidden])


def _within_strategy_bounds(got, want):
    """tests/test_strategies.py::test_naive_matches_no_offload's bounds."""
    np.testing.assert_allclose(got["losses"].mean(1), want["losses"].mean(1),
                               rtol=5e-3, atol=5e-4)
    for f in FIELDS:
        np.testing.assert_allclose(got["params"][f], want["params"][f],
                                   rtol=0.05, atol=2e-3, err_msg=f)


@pytest.mark.parametrize("sparse_adam", [False, True])
@pytest.mark.parametrize("against", ["reference_naive", "port_no_offload"])
def test_batches_from_zero_moments(reference, against, sparse_adam):
    pert_np, gts, many = reference[1]
    got = _run_port(pert_np, gts, sparse_adam, N_STEPS)
    want = (many[sparse_adam] if against == "reference_naive"
            else _run_no_offload(pert_np, gts, sparse_adam, N_STEPS))
    _within_strategy_bounds(got, want)
    assert got["losses"][-1].mean() < got["losses"][0].mean()


def _port_ctx(state_np, opt_np=None):
    state = convert.state_from_numpy(state_np, device="cpu")
    ctx = t_naive.make_context(_cfg(tconfig), state, toptim.AdamConfig())
    if opt_np is not None:
        _seed(ctx, opt_np, torch.from_numpy)
    return state, ctx


def _jax_ctx(state_np, opt_np=None):
    reference_native()
    state = _jax_state(state_np)
    ctx = j_naive.make_context(_cfg(jconfig), state, joptim.AdamConfig())
    if opt_np is not None:
        _seed(ctx, opt_np, lambda a: a)
    return state, ctx


def test_strip_and_materialize_round_trip():
    state_np, _ = _densify_inputs()
    state, ctx = _port_ctx(state_np)
    js = j_naive.strip_device_params(_jax_state(state_np))
    stripped = t_naive.strip_device_params(state)
    assert t_naive.strip_device_params(stripped) is stripped
    for f in FIELDS:
        assert tuple(getattr(stripped.params, f).shape) == getattr(js.params, f).shape
        buf = ctx.params_host[f]
        assert buf.shape == (128, COLS[f]) and buf.dtype == torch.float32
        assert buf.is_contiguous() and not buf.is_pinned()
    assert stripped.alive.shape == (128,) and stripped.n_alive == state.n_alive
    full = t_naive.materialize(stripped, ctx)
    assert t_naive.materialize(full, ctx) is full
    for f in FIELDS:
        assert torch.equal(getattr(full.params, f), getattr(state.params, f))
    # the device copy is a copy: the host Adam's writes do not reach it
    ctx.params_host["xyz"].add_(1.0)
    assert torch.equal(full.params.xyz, state.params.xyz)


def test_grow_context_matches_reference():
    state_np, opt_np = _densify_inputs()
    _, tctx = _port_ctx(state_np, opt_np)
    _, jctx = _jax_ctx(state_np, opt_np)
    tctx = t_naive.grow_context(tctx, 192, None)
    jctx = j_naive.grow_context(jctx, 192, None)
    for f in FIELDS:
        assert tctx.params_host[f].shape == tctx.grads_host[f].shape == (192, COLS[f])
        np.testing.assert_array_equal(_host(tctx, f), _host(jctx, f))
        assert not _host(tctx, f)[128:].any() and not tctx.grads_host[f].any()
        for got, want in zip(_moments(tctx)[f], _moments(jctx)[f]):
            np.testing.assert_array_equal(got, want)
            assert got.shape == (192, COLS[f]) and not got[128:].any()


def test_post_densify_matches_reference():
    """The host copy takes the densified parameters, and the moments of the
    rows densification wrote are zeroed (within 1e-6 relative as
    test_torch_densify.py; moments exact)."""
    state_np, opt_np = _densify_inputs()
    (js, _, ji), (ts, _, ti) = _both(state_np, opt_np, size_prune=True, with_opt=False)
    _, tctx = _port_ctx(state_np, opt_np)
    _, jctx = _jax_ctx(state_np, opt_np)
    tctx = t_naive.post_densify(tctx, ts, ti)
    jctx = j_naive.post_densify(jctx, js, ji)
    written = ti.written.numpy()
    assert written.any() and not written.all()
    np.testing.assert_array_equal(written, np.asarray(ji.written))
    for f in FIELDS:
        np.testing.assert_allclose(_host(tctx, f), _host(jctx, f), rtol=1e-6,
                                   atol=1e-6, err_msg=f)
        np.testing.assert_array_equal(
            _host(tctx, f), getattr(ts.params, f).numpy().reshape(-1, COLS[f]))
        for got, want in zip(_moments(tctx)[f], _moments(jctx)[f]):
            np.testing.assert_array_equal(got, want)
            assert not got[written].any() and got[~written].any()


def test_post_opacity_reset_matches_reference():
    state_np, opt_np = _densify_inputs(seed=1)
    state, tctx = _port_ctx(state_np, opt_np)
    _, jctx = _jax_ctx(state_np, opt_np)
    ts, _ = tD.reset_opacity(state, None)
    js, _ = jD.reset_opacity(_jax_state(state_np), None)
    tctx = t_naive.post_opacity_reset(tctx, ts)
    jctx = j_naive.post_opacity_reset(jctx, js)
    np.testing.assert_allclose(_host(tctx, "opacity"), _host(jctx, "opacity"),
                               rtol=1e-6)
    for f in FIELDS:
        for got, want in zip(_moments(tctx)[f], _moments(jctx)[f]):
            np.testing.assert_array_equal(got, want)
            assert got.any() == (f != "opacity")


def test_checkpoint_extra_matches_reference():
    """Same keys, shapes and dtypes as the reference's strategy_extra.npz;
    each package restores the other's."""
    state_np, opt_np = _densify_inputs(seed=2)
    _, tctx = _port_ctx(state_np, opt_np)
    _, jctx = _jax_ctx(state_np, opt_np)
    t_extra, j_extra = t_naive.checkpoint_extra(tctx), j_naive.checkpoint_extra(jctx)
    assert sorted(t_extra) == sorted(j_extra)
    assert "naive.sh.exp_avg_sq" in t_extra and "naive.xyz.step_count" in t_extra
    for k in t_extra:
        t, j = np.asarray(t_extra[k]), np.asarray(j_extra[k])
        assert (t.shape, t.dtype) == (j.shape, j.dtype), k
        np.testing.assert_array_equal(t, j)
    _, fresh = _port_ctx(state_np)
    fresh = t_naive.restore_extra(fresh, {k: np.asarray(v) for k, v in j_extra.items()})
    for f in FIELDS:
        assert fresh.adams[f].step_count == 7
        for got, want in zip(_moments(fresh)[f], _moments(jctx)[f]):
            np.testing.assert_array_equal(got, want)
        assert fresh.adams[f].exp_avg.is_contiguous()
    _, jfresh = _jax_ctx(state_np)
    jfresh = j_naive.restore_extra(jfresh, t_extra)
    for f in FIELDS:
        np.testing.assert_array_equal(_moments(jfresh)[f][0], _moments(tctx)[f][0])


def test_stop_update_param_leaves_the_host_state():
    state_np, opt_np, gts = _inputs()
    state, ctx = _port_ctx(state_np, opt_np)
    cfg = _cfg(tconfig)
    cfg.debug.stop_update_param = True
    before = {f: ctx.params_host[f].clone() for f in FIELDS}
    moments = _moments(ctx)
    s, _, ctx, out = t_naive.train_one_batch(
        t_naive.strip_device_params(state), None, ctx, _cams(), torch.from_numpy(gts),
        3, T_LRS, toptim.AdamConfig(), T_BG, W, H, cfg)
    assert t_naive._is_stripped(s) and np.isfinite(out.losses.numpy()).all()
    for f in FIELDS:
        assert torch.equal(ctx.params_host[f], before[f])
        assert ctx.adams[f].step_count == 10
        for got, want in zip(_moments(ctx)[f], moments[f]):
            np.testing.assert_array_equal(got, want)
