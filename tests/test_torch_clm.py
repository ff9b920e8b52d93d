"""Port vs reference: the clm_offload strategy (the SH rows, their gradients
and moments on the host, the card's 11 attributes streamed per camera).

The same numpy scene goes through both packages' `clm_offload`, on the tiny
scene of test_torch_train_step.py, the reference with its f32 rasterizer
gradients (CLMGS_PACK_GRADS=0) and a fresh state for each run (its batch
donates the caller's buffers). The filters, the Hamming distances, the
camera order and finish sets and the retention maps are exact. One batch
from seeded moments uses test_torch_naive.py's tolerances: losses rtol 1e-5,
`denom` exact, parameter moves 1e-4 of the group's largest move, first
moments 1e-5 of the largest gradient term. Eight batches from zero moments
use the reference's clm parity bounds (tests/test_strategies.py: losses,
sorted per batch, rtol 5e-3 atol 1e-3; parameters rtol 0.05 atol 2e-3),
against the reference's clm_offload and against the port's no_offload.
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
from clm_gs_tpu.models import gaussians as jG
from clm_gs_tpu.strategies import clm_offload as j_clm
from clm_gs_tpu.strategies import offload_common as j_oc
from clm_gs_tpu.utils import checkpoint as jckpt
from clm_gs_tpu_torch import config as tconfig, convert, optim as toptim
from clm_gs_tpu_torch.models import densify as tD
from clm_gs_tpu_torch.models import gaussians as tG
from clm_gs_tpu_torch.strategies import clm_offload as t_clm
from clm_gs_tpu_torch.strategies import offload_common as t_oc
from clm_gs_tpu_torch.train import _grow_opt
from clm_gs_tpu_torch.utils import checkpoint as tckpt
from tests.test_strategies import N_STEPS
from tests.test_torch_densify import ARGS, _densify_inputs, _jax_state
from tests.test_torch_naive import T_BG, T_LRS, _cams, _perturbed_np, _run_no_offload
from tests.test_torch_native import reference_native
from tests.test_torch_train_step import _inputs
from tests.test_train_synthetic import BG, H, ISECT_CAP, LRS, W
from tests.utils3d import make_camera

torch.set_num_threads(1)

FIELDS = ("xyz", "opacity", "log_scale", "quat", "sh")
GPU = FIELDS[:4]
COLS = {"xyz": 3, "opacity": 1, "log_scale": 3, "quat": 4, "sh": 48}


def _cfg(pkg, sparse=False, retention=True):
    """test_strategies.py's _mk_cfg("clm_offload"), for either package."""
    cfg = pkg.Config()
    cfg.aux.clm_offload = True
    cfg.aux.sparse_adam = sparse
    cfg.opt.bsz = 4
    cfg.opt.lr_scale_mode = "accumu"
    cfg.tpu.retention = retention
    return pkg.init_config(cfg)


def _opt_groups(opt_np, make):
    """The four card groups' moments of `opt_np`, each with its own SH
    placeholder (the reference donates them: no buffer twice)."""
    def grp(g):
        return {f: make(np.array(opt_np[g][f], np.float32)) for f in GPU} | {
            "sh": make(np.zeros((1, 48), np.float32))}
    return grp("mu"), grp("nu")


def _seed_host(ctx, opt_np, make):
    ctx.adam.exp_avg = make(np.array(opt_np["mu"]["sh"], np.float32))
    ctx.adam.exp_avg_sq = make(np.array(opt_np["nu"]["sh"], np.float32))
    ctx.adam.step_count = int(opt_np["steps"])


def _result(state, opt, ctx, losses, out, to_np):
    params = {f: to_np(getattr(state.params, f)) for f in GPU}
    params["sh"] = to_np(ctx.sh_host)
    mu = {f: to_np(getattr(opt.mu, f)) for f in GPU} | {"sh": to_np(ctx.adam.exp_avg)}
    nu = {f: to_np(getattr(opt.nu, f)) for f in GPU} | {"sh": to_np(ctx.adam.exp_avg_sq)}
    return {"params": params, "mu": mu, "nu": nu, "losses": np.array(losses),
            "xyz_grad_accum": to_np(state.xyz_grad_accum), "denom": to_np(state.denom),
            "visible_any": to_np(out.visible_any), "max_isects": int(out.max_isects),
            "placeholder": tuple(state.params.sh.shape) + tuple(opt.mu.sh.shape)}


def _run_jax(state_np, gts, sparse, n_batches, opt_np=None):
    cfg = _cfg(jconfig, sparse)
    state = _jax_state(state_np)
    ctx = j_clm.make_context(cfg, state, joptim.AdamConfig())
    state = j_clm.strip_device_sh(state)
    if opt_np is None:
        opt = joptim.init_adam(state.params)
    else:
        mu, nu = _opt_groups(opt_np, jnp.asarray)
        opt = joptim.AdamState(jG.GaussianParams(**mu), jG.GaussianParams(**nu),
                               jnp.asarray(opt_np["steps"]))
        _seed_host(ctx, opt_np, lambda a: a)
    cb = j_stack([make_camera(uid=i, width=W, height=H, angle=0.8 * i)
                  for i in range(4)])
    losses = []
    for _ in range(n_batches):
        state, opt, ctx, out = j_clm.train_one_batch(
            state, opt, ctx, cb, jnp.asarray(gts), 3, LRS, joptim.AdamConfig(), BG,
            W, H, ISECT_CAP, cfg)
        losses.append(np.array(out.losses))
    return _result(state, opt, ctx, losses, out, np.array)


def _port_start(state_np, sparse=False, retention=True, opt_np=None):
    cfg = _cfg(tconfig, sparse, retention)
    state = convert.state_from_numpy(state_np, device="cpu")
    ctx = t_clm.make_context(cfg, state, toptim.AdamConfig())
    state = t_clm.strip_device_sh(state)
    if opt_np is None:
        opt = toptim.init_adam(state.params)
    else:
        mu, nu = _opt_groups(opt_np, torch.from_numpy)
        opt = toptim.AdamState(tG.GaussianParams(**mu), tG.GaussianParams(**nu),
                               torch.tensor(float(opt_np["steps"])))
        _seed_host(ctx, opt_np, torch.from_numpy)
    return cfg, state, opt, ctx


def _run_port(state_np, gts, sparse, n_batches, opt_np=None, retention=True):
    cfg, state, opt, ctx = _port_start(state_np, sparse, retention, opt_np)
    cb = _cams()
    losses = []
    try:
        for _ in range(n_batches):
            state, opt, ctx, out = t_clm.train_one_batch(
                state, opt, ctx, cb, torch.from_numpy(gts), 3, T_LRS,
                toptim.AdamConfig(), T_BG, W, H, cfg)
            losses.append(out.losses.numpy())
    finally:
        ctx.close()
    res = _result(state, opt, ctx, losses, out, lambda t: t.numpy().copy())
    res["ctx"] = ctx
    res["n_isects"] = out.n_isects
    return res


@pytest.fixture(scope="module")
def reference():
    """The reference's clm_offload: one batch from seeded moments and
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
    # the same TSP order: the losses agree camera by camera
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)
    np.testing.assert_array_equal(got["visible_any"], ref["visible_any"])
    assert got["max_isects"] == ref["max_isects"] == max(got["n_isects"])
    np.testing.assert_array_equal(got["denom"], ref["denom"])
    np.testing.assert_allclose(got["xyz_grad_accum"], ref["xyz_grad_accum"],
                               rtol=1e-4, atol=1e-6)
    assert got["placeholder"] == ref["placeholder"] == (1, 48, 1, 48)
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
    assert got["ctx"].adam.step_count == 11 and got["ctx"].n_batches == 1
    if sparse_adam:
        hidden = ~ref["visible_any"]
        assert hidden.any()
        for f in FIELDS:
            p0 = state_np["params"][f].reshape(got["params"][f].shape)
            np.testing.assert_array_equal(got["params"][f][hidden], p0[hidden])


def _within_clm_bounds(got, want):
    """tests/test_strategies.py::test_clm_matches_no_offload's bounds."""
    np.testing.assert_allclose(np.sort(got["losses"], 1), np.sort(want["losses"], 1),
                               rtol=5e-3, atol=1e-3)
    for f in FIELDS:
        np.testing.assert_allclose(got["params"][f].reshape(want["params"][f].shape),
                                   want["params"][f], rtol=0.05, atol=2e-3, err_msg=f)


@pytest.mark.parametrize("sparse_adam", [False, True])
@pytest.mark.parametrize("against", ["reference_clm", "port_no_offload"])
def test_batches_from_zero_moments(reference, against, sparse_adam):
    pert_np, gts, many = reference[1]
    got = _run_port(pert_np, gts, sparse_adam, N_STEPS)
    want = (many[sparse_adam] if against == "reference_clm"
            else _run_no_offload(pert_np, gts, sparse_adam, N_STEPS))
    _within_clm_bounds(got, want)
    assert got["losses"][-1].mean() < got["losses"][0].mean()
    ctx = got["ctx"]
    assert ctx.n_batches == N_STEPS and ctx.h2d_bytes > 0 and ctx.d2h_bytes > 0


def test_retention_matches_full_regather():
    """The working-set advance only changes what moves: retention on and off
    agree within rtol 1e-5, atol 1e-6 (test_strategies.py::TestRetention),
    and retention uploads fewer bytes."""
    pert_np, gts = _perturbed_np()
    on = _run_port(pert_np, gts, False, 4)
    off = _run_port(pert_np, gts, False, 4, retention=False)
    np.testing.assert_allclose(on["losses"], off["losses"], rtol=1e-5, atol=1e-6)
    for f in FIELDS:
        for k in ("params", "mu", "nu"):
            np.testing.assert_allclose(on[k][f], off[k][f], rtol=1e-5, atol=1e-6,
                                       err_msg=f"{k}.{f}")
    assert on["ctx"].h2d_bytes < off["ctx"].h2d_bytes


# ---- the host-side pieces, exact ----

def _scene_inputs():
    pert_np, _ = _perturbed_np()
    cams = _cams()
    return pert_np, cams


@pytest.mark.parametrize("radius_clip", [0.0, 1.5])
def test_calculate_filters_match_reference(radius_clip):
    state_np, cb = _scene_inputs()
    C = len(state_np["alive"])
    p = state_np["params"]
    args = [p["xyz"], p["quat"], p["log_scale"], state_np["alive"]]
    jf = j_oc.calculate_filters(*map(jnp.asarray, args), jnp.asarray(cb.viewmats.numpy()),
                                jnp.asarray(cb.Ks.numpy()), W, H, radius_clip, C)
    tf = t_oc.calculate_filters(*(torch.from_numpy(np.asarray(a)) for a in args),
                                cb.viewmats, cb.Ks, W, H, radius_clip)
    counts = np.asarray(jf.counts)
    np.testing.assert_array_equal(tf.counts.numpy(), counts)
    assert counts.min() > 0
    for b in range(4):
        ids = tf.ids[b]
        assert ids.dtype == torch.int32
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jf.idx[b])[: counts[b]])
        assert (np.asarray(jf.idx[b])[counts[b]:] == C).all()
    np.testing.assert_array_equal(tf.sample.numpy(), np.asarray(jf.sample))


def test_hamming_distance_matrix_matches_reference():
    rng = np.random.RandomState(4)
    sample = rng.rand(7, 3001) < rng.rand(7, 1)
    got = t_oc.hamming_distance_matrix(torch.from_numpy(sample))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(j_oc.hamming_distance_matrix(sample)))


def _random_visibility(B=8, C=5000, seed=5):
    """Each camera sees a window of the rows plus scattered extra rows, so
    neighbouring windows overlap: sorted int32 id lists, padded for the
    reference with the id C."""
    rng = np.random.RandomState(seed)
    vis = np.zeros((B, C), bool)
    for b in range(B):
        start = rng.randint(0, C - 1500)
        vis[b, start:start + rng.randint(300, 1500)] = True
        vis[b, rng.choice(C, 200, replace=False)] = True
    ids = [np.nonzero(v)[0].astype(np.int32) for v in vis]
    v_cap = max(len(i) for i in ids) + 7
    padded = np.full((B, v_cap), C, np.int32)
    for b, i in enumerate(ids):
        padded[b, :len(i)] = i
    alive = rng.rand(C) < 0.9
    alive[np.concatenate(ids)] = True
    return vis, ids, padded, alive


@pytest.mark.parametrize("reorder", [True, False])
def test_order_and_finish_sets_match_reference(reorder):
    reference_native()
    vis, ids, padded, alive = _random_visibility()
    dist = np.asarray(j_oc.hamming_distance_matrix(vis[:, ::32]))
    counts = np.array([len(i) for i in ids])
    j_order, j_sets, j_never = j_clm._order_and_finish_sets(padded, counts, dist, alive,
                                                            reorder)
    t_order, t_sets, t_never = t_clm._order_and_finish_sets(
        [torch.from_numpy(i) for i in ids], torch.from_numpy(dist.copy()),
        torch.from_numpy(alive), reorder)
    np.testing.assert_array_equal(t_order.numpy(), j_order)
    assert len(t_sets) == len(j_sets) == 8
    for t, j in zip(t_sets, j_sets):
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(t.numpy(), j)
    np.testing.assert_array_equal(t_never.numpy(), j_never)
    # every visible row finishes exactly once, at its last camera
    union = np.sort(np.concatenate([s.numpy() for s in t_sets]))
    np.testing.assert_array_equal(union, np.nonzero(vis.any(0))[0])
    if reorder:
        assert counts[int(t_order[-1])] == counts.min()


def test_classify_and_invert_transition_match_reference():
    """The H/D/G split and the gather maps of the advance. The reference's
    maps index [prev padded to v_cap | arriving rows]; the port's, [prev |
    arriving rows] at their true lengths."""
    reference_native()
    _, ids, _, _ = _random_visibility(seed=6)
    V = 4096
    for prev, nxt in zip(ids[:-1], ids[1:]):
        jpd, jpn, jhn, jgp, gp_raw, hn_raw = j_clm._classify_transition(prev, nxt, V)
        pd, pn, gp, hn = t_clm._classify_transition(torch.from_numpy(prev),
                                                    torch.from_numpy(nxt))
        nr = len(prev) - len(gp_raw)
        for t, j in ((pd, jpd[:nr]), (pn, jpn[:nr]), (gp, gp_raw), (hn, hn_raw)):
            np.testing.assert_array_equal(t.numpy(), j)
        src, gsrc = t_clm._invert_transition(pd, pn, hn, len(prev), len(nxt))
        j_src, j_gsrc = j_clm._invert_transition(jpd[:nr], jpn[:nr], hn_raw, V, len(jhn))
        src, gsrc = src.numpy(), gsrc.numpy()
        np.testing.assert_array_equal(
            np.where(src >= len(prev), src - len(prev) + V, src), j_src[:len(nxt)])
        np.testing.assert_array_equal(np.where(gsrc == len(prev), V, gsrc),
                                      j_gsrc[:len(nxt)])
        # the maps rebuild the next camera's rows from the previous ones
        rows = np.concatenate([prev, nxt[hn.numpy()]])
        np.testing.assert_array_equal(rows[src], nxt)


# ---- densification, growth, checkpoints and loaders ----

def _stripped(state_np, opt_np):
    """Both packages' clm set-up from one numpy state: the stripped states,
    the card moments with the SH placeholder, and the contexts."""
    tcfg, ts, to, tctx = _port_start(state_np, opt_np=opt_np)
    jcfg = _cfg(jconfig)
    js = _jax_state(state_np)
    jctx = j_clm.make_context(jcfg, js, joptim.AdamConfig())
    mu, nu = _opt_groups(opt_np, jnp.asarray)
    jo = joptim.AdamState(jG.GaussianParams(**mu), jG.GaussianParams(**nu),
                          jnp.asarray(opt_np["steps"]))
    _seed_host(jctx, opt_np, lambda a: a)
    return (j_clm.strip_device_sh(js), jo, jctx), (ts, to, tctx)


@pytest.mark.parametrize("size_prune", [False, True])
def test_post_densify_matches_reference(size_prune):
    """densify_and_prune(include_sh=False) on the stripped states, then the
    host replay: the SH rows within 1e-6, the moments exact, the
    placeholders kept; the replay equals the port's own scatter on the full
    state at every live row."""
    state_np, opt_np = _densify_inputs()
    (js, jo, jctx), (ts, to, tctx) = _stripped(state_np, opt_np)
    key = jax.random.PRNGKey(3)
    noise = torch.from_numpy(np.array(jax.random.normal(key, (2, 128, 3), jnp.float32)))
    args = (ARGS["grad_threshold"], ARGS["min_opacity"], ARGS["extent"],
            ARGS["percent_dense"])
    js2, jo2, ji = jD.densify_and_prune(js, jo, key, *args, jnp.asarray(size_prune),
                                        include_sh=False)
    ts2, to2, ti = tD.densify_and_prune(ts, to, None, *args, size_prune, noise=noise,
                                        include_sh=False)
    assert ti.n_cloned > 0 and ti.n_split > 0
    assert tuple(ts2.params.sh.shape) == tuple(to2.mu.sh.shape) == (1, 48)
    np.testing.assert_array_equal(ti.written.numpy(), np.asarray(ji.written))
    tctx = t_clm.post_densify(tctx, ts2, ti)
    jctx = j_clm.post_densify(jctx, js2, ji)
    np.testing.assert_allclose(tctx.sh_host.numpy(), jctx.sh_host, rtol=1e-6, atol=1e-6)
    for k in ("exp_avg", "exp_avg_sq"):
        np.testing.assert_array_equal(getattr(tctx.adam, k).numpy(), getattr(jctx.adam, k))
        assert not getattr(tctx.adam, k).numpy()[ti.written.numpy()].any()
    full, _, _ = tD.densify_and_prune(convert.state_from_numpy(state_np, device="cpu"),
                                      None, None, *args, size_prune, noise=noise)
    alive = full.alive.numpy()
    np.testing.assert_array_equal(ts2.alive.numpy(), alive)
    np.testing.assert_array_equal(tctx.sh_host.numpy()[alive], full.params.sh.numpy()[alive])
    tctx.close()


def test_host_replay_when_a_clone_lands_in_a_split_source():
    """tests/test_strategies.py::TestClmDensifyReplay on the port: a clone
    child takes the slot its split neighbour freed, and the replay still
    reads every source before writing."""
    C, n = 8, 6
    rng = np.random.RandomState(0)
    ls = np.full((C, 3), np.log(0.001), np.float32)
    ls[1] = np.log(5.0)
    params = {"xyz": rng.randn(C, 3).astype(np.float32), "opacity": np.full(C, 3.0),
              "log_scale": ls, "quat": np.tile([[1.0, 0, 0, 0]], (C, 1)),
              "sh": np.arange(C * 48, dtype=np.float32).reshape(C, 48)}
    accum = np.zeros(C, np.float32)
    accum[[0, 1]] = 10.0
    state_np = {"params": params, "alive": np.arange(C) < n, "n_alive": n,
                "xyz_grad_accum": accum, "denom": (np.arange(C) < n).astype(np.float32),
                "max_radii2d": np.zeros(C, np.float32)}
    args = (0.5, 0.005, 1.0, 0.01, False)
    noise = torch.zeros(2, C, 3)
    full, _, info = tD.densify_and_prune(convert.state_from_numpy(state_np, device="cpu"),
                                         None, None, *args, noise=noise)
    assert int(info.clone_dest[0]) == 1
    state = convert.state_from_numpy(state_np, device="cpu")
    ctx = t_clm.make_context(_cfg(tconfig), state, toptim.AdamConfig())
    s2, _, info2 = tD.densify_and_prune(t_clm.strip_device_sh(state), None, None, *args,
                                        noise=noise, include_sh=False)
    ctx = t_clm.post_densify(ctx, s2, info2)
    alive = full.alive.numpy()
    np.testing.assert_array_equal(ctx.sh_host.numpy()[alive], full.params.sh.numpy()[alive])
    ctx.close()


def test_placeholder_survives_growth_densify_and_row_surgery():
    """The (1, 48) SH placeholder and its moments stay (1, 48) through
    grow_capacity, _grow_opt, densify_and_prune and zero_rows. The
    reference pads it by the added rows (a defect, ROADMAP.md)."""
    state_np, opt_np = _densify_inputs()
    (js, _, jctx), (ts, to, tctx) = _stripped(state_np, opt_np)
    grown = tG.grow_capacity(ts, 192)
    go = _grow_opt(to, 192)
    assert grown.capacity == 192 and grown.params.xyz.shape == (192, 3)
    assert go.mu.xyz.shape == (192, 3) and go.nu.opacity.shape == (192,)
    assert jG.grow_capacity(js, 192).params.sh.shape == (65, 48)
    zeroed = toptim.zero_rows(go, torch.arange(192) < 100)
    densified, dopt, _ = tD.densify_and_prune(grown, go, torch.Generator().manual_seed(0),
                                              **ARGS, size_prune=True, include_sh=False)
    for t in (grown.params.sh, go.mu.sh, go.nu.sh, zeroed.mu.sh, zeroed.nu.sh,
              densified.params.sh, dopt.mu.sh, dopt.nu.sh):
        assert tuple(t.shape) == (1, 48)
    assert not zeroed.mu.xyz[:100].any() and zeroed.mu.xyz[100:128].any()
    tctx = t_clm.grow_context(tctx, 192, None)
    jctx = j_clm.grow_context(jctx, 192, _cfg(jconfig))
    for t, j in ((tctx.sh_host, jctx.sh_host), (tctx.sh_grad_host, jctx.sh_grad_host),
                 (tctx.adam.exp_avg, jctx.adam.exp_avg)):
        assert t.shape == (192, 48) and t.is_contiguous()
        np.testing.assert_array_equal(t.numpy(), j)
    with pytest.raises(ValueError, match="stripped"):
        t_clm.make_context(_cfg(tconfig), ts, toptim.AdamConfig())
    tctx.close()


def test_checkpoint_of_a_stripped_state_cross_reads(tmp_path):
    """chkpnt.npz with the (1, 48) SH and strategy_extra.npz with the clm.*
    keys: the two packages write the same arrays (but `rng_key`, each its own
    generator's state), each loads its own chkpnt.npz, and both restore
    either package's strategy_extra.npz."""
    state_np, opt_np = _densify_inputs(seed=2)
    (js, jo, jctx), (ts, to, tctx) = _stripped(state_np, opt_np)
    t_extra, j_extra = t_clm.checkpoint_extra(tctx), j_clm.checkpoint_extra(jctx)
    assert sorted(t_extra) == sorted(j_extra) == [
        "clm.exp_avg", "clm.exp_avg_sq", "clm.sh_host", "clm.step_count"]
    tckpt.save_checkpoint(str(tmp_path / "t"), 9, ts, to, torch.Generator(),
                          strategy_extra=t_extra)
    jckpt.save_checkpoint(str(tmp_path / "j"), 9, js, jo, jax.random.PRNGKey(0),
                          strategy_extra=j_extra)
    dirs = {r: str(tmp_path / r / "checkpoints" / "9") for r in "tj"}
    for name in ("chkpnt.npz", "strategy_extra.npz"):
        with np.load(os.path.join(dirs["t"], name)) as a, \
                np.load(os.path.join(dirs["j"], name)) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                if k != "rng_key":
                    assert (a[k].shape, a[k].dtype) == (b[k].shape, b[k].dtype), k
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    s, o, _, it = tckpt.load_checkpoint(dirs["t"], device="cpu")
    jst, jop, _, jit = jckpt.load_checkpoint(dirs["j"])
    assert it == jit == 9
    assert tuple(s.params.sh.shape) == jst.params.sh.shape == (1, 48)
    assert tuple(o.nu.sh.shape) == jop.nu.sh.shape == (1, 48)
    np.testing.assert_array_equal(s.params.xyz.numpy(), state_np["params"]["xyz"])
    np.testing.assert_array_equal(o.mu.quat.numpy(), opt_np["mu"]["quat"])
    for d in dirs.values():
        with np.load(os.path.join(d, "strategy_extra.npz")) as z:
            extra = dict(z)
        ctx = t_clm.restore_extra(t_clm.make_context_empty(_cfg(tconfig), 128,
                                                           toptim.AdamConfig(), "cpu"),
                                  extra)
        jc = j_clm.restore_extra(j_clm.make_context_empty(_cfg(jconfig), 128,
                                                          joptim.AdamConfig()), extra)
        assert ctx.adam.step_count == jc.adam.step_count == 7
        np.testing.assert_array_equal(ctx.sh_host.numpy(), jc.sh_host)
        np.testing.assert_array_equal(ctx.adam.exp_avg_sq.numpy(), jc.adam.exp_avg_sq)
        np.testing.assert_array_equal(ctx.sh_host.numpy(), state_np["params"]["sh"])
        assert not ctx.sh_grad_host.any() and ctx.sh_host.is_contiguous()
        ctx.close()
    tctx.close()


@pytest.mark.parametrize("loader", ["pcd", "ply", "tensors"])
def test_host_sh_loaders_match_reference(tmp_path, loader):
    """host_sh=True: (state with the placeholder, (C, 48) host rows), as the
    reference's loaders return them."""
    rng = np.random.RandomState(1)
    if loader == "pcd":
        pts, cols = rng.normal(size=(50, 3)).astype(np.float32), rng.rand(50, 3)
        t = tG.create_from_pcd(pts, cols, capacity=64, device="cpu", host_sh=True)
        j = jG.create_from_pcd(pts, cols, capacity=64, host_sh=True)
    else:
        state_np, _ = _densify_inputs()
        full = convert.state_from_numpy(state_np, device="cpu")
        path = str(tmp_path / ("m.ply" if loader == "ply" else "m.npz"))
        (tG.save_ply if loader == "ply" else tG.save_tensors)(full, path)
        t_load, j_load = ((tG.load_ply, jG.load_ply) if loader == "ply"
                          else (tG.load_tensors, jG.load_tensors))
        t = t_load(path, capacity=64, device="cpu", host_sh=True)
        j = j_load(path, capacity=64, host_sh=True)
    (ts, t_sh), (js, j_sh) = t, j
    assert tuple(ts.params.sh.shape) == js.params.sh.shape == (1, 48)
    assert t_sh.shape == (64, 48) and not t_sh.is_pinned()
    np.testing.assert_allclose(t_sh.numpy(), j_sh, rtol=1e-6, atol=1e-7)
    for f in GPU:
        np.testing.assert_allclose(getattr(ts.params, f).numpy(),
                                   np.asarray(getattr(js.params, f)), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(ts.alive.numpy(), np.asarray(js.alive))


def test_eval_one_cam_matches_the_full_render():
    """The clm eval (filter, gather the host rows, render the compact set)
    against the port's no_offload render of the full state."""
    from clm_gs_tpu_torch.strategies import no_offload

    state_np, cb = _scene_inputs()
    cfg, state, _, ctx = _port_start(state_np)
    full = t_clm.materialize(state, ctx)
    for b in range(4):
        args = (cb.viewmats[b], cb.Ks[b], cb.camtoworlds[b], 3, T_BG, W, H)
        img, n = t_clm.eval_one_cam((state, ctx), *args)
        ref, n_ref = no_offload.eval_one_cam(full, *args)
        assert n == n_ref > 0
        torch.testing.assert_close(img, ref, rtol=1e-5, atol=1e-6)
    ctx.close()
