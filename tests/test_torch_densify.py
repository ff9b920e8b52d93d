"""Port vs reference: densification, knn, initialisation, capacity buckets
and schedules.

Inputs are numpy arrays from seeds, fed to both packages. The split samples
of the reference come from jax.random; the port takes the same standard
normals through `noise=`. Tolerances: masks, counts and destinations exact;
float32 results within 1e-6 relative (the same formulas, evaluated in
another order) unless stated.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clm_gs_tpu import optim as joptim
from clm_gs_tpu.models import densify as jD
from clm_gs_tpu.models import gaussians as jG
from clm_gs_tpu.ops import knn as jknn
from clm_gs_tpu.utils import general as jgeneral
from clm_gs_tpu_torch import convert, optim as toptim
from clm_gs_tpu_torch.models import densify as tD
from clm_gs_tpu_torch.models import gaussians as tG
from clm_gs_tpu_torch.ops import knn as tknn
from clm_gs_tpu_torch.utils import general as tgeneral

torch.set_num_threads(1)

FIELDS = ("xyz", "opacity", "log_scale", "quat", "sh")
STATS = ("xyz_grad_accum", "denom", "max_radii2d")


def _np(obj):
    return {f: np.asarray(getattr(obj, f)) if not torch.is_tensor(getattr(obj, f))
            else getattr(obj, f).numpy() for f in FIELDS}


def _jax_state(d):
    P = jG.GaussianParams(**{f: jnp.asarray(d["params"][f]) for f in FIELDS})
    return jG.GaussianState(params=P, alive=jnp.asarray(d["alive"]),
                            n_alive=jnp.asarray(d["n_alive"], jnp.int32),
                            **{f: jnp.asarray(d[f]) for f in STATS})


def _jax_adam(d):
    P = lambda g: jG.GaussianParams(**{f: jnp.asarray(g[f]) for f in FIELDS})
    return joptim.AdamState(P(d["mu"]), P(d["nu"]), jnp.asarray(d["steps"]))


def _densify_inputs(cap=128, n=48, seed=0):
    """Rows of every kind: cold, clone (small and hot), split (large and
    hot), faint (pruned), huge (size-pruned, and its split children too)."""
    rng = np.random.RandomState(seed)
    kind = rng.choice(["cold", "clone", "split", "faint", "huge"], n,
                      p=[0.3, 0.2, 0.2, 0.15, 0.15])
    scale = np.where(kind == "clone", 0.005, np.where(kind == "huge", 0.2, 0.05))
    log_scale = np.log(scale[:, None] * rng.uniform(0.5, 1.0, (n, 3)))
    opacity = np.where(kind == "faint", -8.0, rng.uniform(-1.0, 2.0, n))
    hot = np.isin(kind, ["clone", "split", "huge"])
    denom = rng.randint(1, 4, n).astype(np.float32)
    denom[rng.rand(n) < 0.1] = 0.0  # never seen: grad 0
    accum = np.where(hot, 1e-3, 1e-5) * np.maximum(denom, 1)

    def pad(x):
        out = np.zeros((cap,) + np.shape(x)[1:], np.float32)
        out[:n] = x
        return out

    params = {
        "xyz": pad(rng.uniform(-1, 1, (n, 3))), "opacity": pad(opacity),
        "log_scale": pad(log_scale), "quat": pad(rng.normal(size=(n, 4))),
        "sh": pad(rng.normal(size=(n, 48))),
    }
    state = {"params": params, "alive": np.arange(cap) < n, "n_alive": n,
             "xyz_grad_accum": pad(accum), "denom": pad(denom),
             "max_radii2d": np.zeros(cap, np.float32)}
    opt = {"mu": {f: rng.normal(size=v.shape).astype(np.float32)
                  for f, v in params.items()},
           "nu": {f: rng.uniform(0.1, 1.0, v.shape).astype(np.float32)
                  for f, v in params.items()},
           "steps": np.float32(7.0)}
    return state, opt


ARGS = dict(grad_threshold=2e-4, min_opacity=0.005, extent=1.0,
            percent_dense=0.01)


def _both(state_np, opt_np, size_prune, seed=3, with_opt=True):
    key = jax.random.PRNGKey(seed)
    C = len(state_np["alive"])
    noise = np.array(jax.random.normal(key, (2, C, 3), jnp.float32))
    js, jo, ji = jD.densify_and_prune(
        _jax_state(state_np), _jax_adam(opt_np) if with_opt else None, key,
        ARGS["grad_threshold"], ARGS["min_opacity"], ARGS["extent"],
        ARGS["percent_dense"], jnp.asarray(size_prune))
    ts, to, ti = tD.densify_and_prune(
        convert.state_from_numpy(state_np, device="cpu"),
        convert.adam_from_numpy(opt_np, device="cpu") if with_opt else None,
        None, ARGS["grad_threshold"], ARGS["min_opacity"], ARGS["extent"],
        ARGS["percent_dense"], size_prune, noise=torch.from_numpy(noise))
    return (js, jo, ji), (ts, to, ti)


@pytest.mark.parametrize("size_prune", [False, True])
def test_densify_and_prune_matches_reference(size_prune):
    state_np, opt_np = _densify_inputs()
    (js, jo, ji), (ts, to, ti) = _both(state_np, opt_np, size_prune)
    assert ti.n_cloned > 0 and ti.n_split > 0 and ti.n_pruned > ti.n_split
    assert not ti.overflow and not bool(ji.overflow)
    for a, b in ((ti.n_cloned, ji.n_cloned), (ti.n_split, ji.n_split),
                 (ti.n_pruned, ji.n_pruned), (ti.n_alive, ji.n_alive)):
        assert a == int(b)
    assert ts.n_alive == int(js.n_alive) == int(ts.alive.sum())
    np.testing.assert_array_equal(ts.alive.numpy(), np.asarray(js.alive))
    np.testing.assert_array_equal(ti.written.numpy(), np.asarray(ji.written))
    np.testing.assert_array_equal(ti.clone_dest.numpy(), np.asarray(ji.clone_dest))
    np.testing.assert_array_equal(ti.split_dest.numpy(), np.asarray(ji.split_dest))
    got, ref = _np(ts.params), _np(js.params)
    for f in FIELDS:
        # the split samples go through an einsum: 1e-6 of the coordinates
        np.testing.assert_allclose(got[f], ref[f], rtol=1e-6, atol=1e-6, err_msg=f)
    for grp in ("mu", "nu"):
        g, r = _np(getattr(to, grp)), _np(getattr(jo, grp))
        for f in FIELDS:
            np.testing.assert_array_equal(g[f], r[f], err_msg=f"{grp}.{f}")
            assert not g[f][ti.written.numpy()].any()
    for f in STATS:
        assert not getattr(ts, f).any()
    # size pruning removes every live row larger than 0.1 * extent, and
    # never writes such a split child
    smax = torch.exp(ts.params.log_scale).amax(1)[ts.alive]
    assert bool((smax > 0.1).any()) != size_prune


def test_densify_overflow_writes_nothing():
    state_np, opt_np = _densify_inputs(cap=40, n=38, seed=1)
    (js, jo, ji), (ts, to, ti) = _both(state_np, opt_np, False)
    assert ti.overflow and bool(ji.overflow)
    assert ti.n_cloned == ti.n_split == 0 and not ti.written.any()
    assert (ti.clone_dest == 40).all() and (ti.split_dest == 40).all()
    np.testing.assert_array_equal(ts.alive.numpy(), np.asarray(js.alive))
    assert ts.n_alive == int(js.n_alive) < 38  # the prune still happened


def test_densify_without_optimizer_state():
    state_np, opt_np = _densify_inputs(seed=2)
    (js, jo, ji), (ts, to, ti) = _both(state_np, opt_np, True, with_opt=False)
    assert to is None and jo is None
    np.testing.assert_array_equal(ts.alive.numpy(), np.asarray(js.alive))


def test_densify_from_a_generator_is_seeded():
    state_np, opt_np = _densify_inputs(seed=4)
    outs = []
    for _ in range(2):
        s, _, info = tD.densify_and_prune(
            convert.state_from_numpy(state_np, device="cpu"),
            convert.adam_from_numpy(opt_np, device="cpu"),
            torch.Generator().manual_seed(9), ARGS["grad_threshold"],
            ARGS["min_opacity"], ARGS["extent"], ARGS["percent_dense"], False)
        outs.append(s.params.xyz)
    assert info.n_split > 0
    assert torch.equal(outs[0], outs[1])


def test_count_densify_matches_reference():
    for seed in range(3):
        state_np, _ = _densify_inputs(seed=seed)
        ref = int(jD.count_densify(_jax_state(state_np), ARGS["grad_threshold"],
                                   ARGS["percent_dense"], ARGS["extent"]))
        got = tD.count_densify(convert.state_from_numpy(state_np, device="cpu"),
                               ARGS["grad_threshold"], ARGS["percent_dense"],
                               ARGS["extent"])
        assert got == ref > 0


@pytest.mark.parametrize("with_opt", [True, False])
def test_reset_opacity_matches_reference(with_opt):
    state_np, opt_np = _densify_inputs(seed=5)
    js, jo = jD.reset_opacity(_jax_state(state_np),
                              _jax_adam(opt_np) if with_opt else None)
    ts, to = tD.reset_opacity(
        convert.state_from_numpy(state_np, device="cpu"),
        convert.adam_from_numpy(opt_np, device="cpu") if with_opt else None)
    np.testing.assert_allclose(ts.params.opacity.numpy(),
                               np.asarray(js.params.opacity), rtol=1e-6)
    assert (torch.sigmoid(ts.params.opacity)[ts.alive] <= 0.01 + 1e-7).all()
    if not with_opt:
        assert to is None and jo is None
        return
    for grp in ("mu", "nu"):
        g, r = _np(getattr(to, grp)), _np(getattr(jo, grp))
        for f in FIELDS:
            np.testing.assert_array_equal(g[f], r[f], err_msg=f"{grp}.{f}")
    assert not to.mu.opacity[ts.alive].any()


def test_add_densification_stats_matches_reference():
    state_np, _ = _densify_inputs(seed=6)
    rng = np.random.RandomState(6)
    g2d = rng.normal(size=(128, 2)).astype(np.float32)
    vis = rng.rand(128) < 0.5
    js = jD.add_densification_stats(_jax_state(state_np), jnp.asarray(g2d),
                                     jnp.asarray(vis), 96, 64)
    ts = tD.add_densification_stats(
        convert.state_from_numpy(state_np, device="cpu"), torch.from_numpy(g2d),
        torch.from_numpy(vis), 96, 64)
    np.testing.assert_allclose(ts.xyz_grad_accum.numpy(),
                               np.asarray(js.xyz_grad_accum), rtol=1e-6)
    np.testing.assert_array_equal(ts.denom.numpy(), np.asarray(js.denom))


def test_zero_rows_match_reference():
    _, opt_np = _densify_inputs(seed=7)
    mask = np.random.RandomState(7).rand(128) < 0.3
    jo = joptim.zero_rows(_jax_adam(opt_np), jnp.asarray(mask))
    to = toptim.zero_rows(convert.adam_from_numpy(opt_np, device="cpu"),
                          torch.from_numpy(mask))
    for grp in ("mu", "nu"):
        g, r = _np(getattr(to, grp)), _np(getattr(jo, grp))
        for f in FIELDS:
            np.testing.assert_array_equal(g[f], r[f])


def _knn_cases():
    rng = np.random.RandomState(0)
    grid = np.stack(np.meshgrid(*[np.arange(6)] * 3), -1).reshape(-1, 3)
    tied = np.concatenate([grid, grid + 1e-6 * rng.rand(*grid.shape),
                           np.repeat(grid[:20], 3, 0)]).astype(np.float32)
    return {
        "random": rng.normal(size=(700, 3)).astype(np.float32),
        "clusters": (rng.normal(size=(600, 3)) * 1e-4
                     + rng.randint(0, 3, (600, 1))).astype(np.float32),
        "tied_codes": tied,
        "n2_below_k": rng.normal(size=(2, 3)).astype(np.float32),
        "n3": rng.normal(size=(3, 3)).astype(np.float32),
    }


@pytest.mark.parametrize("case", list(_knn_cases()))
def test_knn_matches_reference(case):
    pts = _knn_cases()[case]
    ref = np.asarray(jknn.knn_mean_sq_dist(jnp.asarray(pts)))
    got = tknn.knn_mean_sq_dist(torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    if len(pts) > 3:
        exact_ref = np.asarray(jknn.knn_mean_sq_dist_exact(jnp.asarray(pts[:200])))
        np.testing.assert_allclose(
            tknn.knn_mean_sq_dist_exact(torch.from_numpy(pts[:200])).numpy(),
            exact_ref, rtol=1e-6)


def test_create_from_pcd_matches_reference():
    rng = np.random.RandomState(1)
    pts = rng.normal(size=(300, 3)).astype(np.float32)
    cols = rng.rand(300, 3).astype(np.float32)
    for kw in ({}, {"capacity": 400}, {"downsample_ratio": 0.5, "seed": 3}):
        js = jG.create_from_pcd(pts, cols, **kw)
        ts = tG.create_from_pcd(pts, cols, device="cpu", **kw)
        assert ts.capacity == js.capacity and ts.n_alive == int(js.n_alive)
        np.testing.assert_array_equal(ts.alive.numpy(), np.asarray(js.alive))
        got, ref = _np(ts.params), _np(js.params)
        for f in FIELDS:
            np.testing.assert_allclose(got[f], ref[f], rtol=1e-6, err_msg=f)
    with pytest.raises(ValueError):
        tG.create_from_pcd(pts, cols, capacity=100, device="cpu")


def test_grow_capacity_matches_reference():
    state_np, _ = _densify_inputs(seed=8)
    js = jG.grow_capacity(_jax_state(state_np), 192)
    ts = tG.grow_capacity(convert.state_from_numpy(state_np, device="cpu"), 192)
    got = convert.state_to_numpy(ts)
    assert ts.capacity == js.capacity == 192 and ts.n_alive == int(js.n_alive)
    np.testing.assert_array_equal(got["alive"], np.asarray(js.alive))
    for f in FIELDS:
        np.testing.assert_array_equal(got["params"][f], np.asarray(getattr(js.params, f)))
    for f in STATS:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(js, f)))


@pytest.mark.parametrize("granule", [65536, 1024])
def test_next_capacity_and_round_up_match_reference(granule):
    for n in [0, 1, 100, 52_428, 52_429, 65_536, 81_920, 1_000_000, 1_447_035,
              3_000_000, 123_456_789]:
        assert tgeneral.next_capacity(n, granule) == jgeneral.next_capacity(n, granule)
        assert tgeneral.round_up(n, granule) == jgeneral.round_up(n, granule)


@pytest.mark.parametrize("delay", [0, 500])
def test_expon_lr_matches_reference(delay):
    kw = dict(lr_delay_steps=delay, lr_delay_mult=0.01, max_steps=30_000)
    jf = jgeneral.get_expon_lr_func(1.6e-4 * 4.4, 1.6e-6 * 4.4, **kw)
    tf = tgeneral.get_expon_lr_func(1.6e-4 * 4.4, 1.6e-6 * 4.4, **kw)
    for step in [-1, 0, 1, 5, 250, 499, 500, 7_001, 29_999, 30_000, 45_000]:
        np.testing.assert_allclose(float(tf(step)), float(jf(step)), rtol=1e-6)
    assert float(tgeneral.get_expon_lr_func(0.0, 0.0)(10)) == 0.0


def test_check_update_at_this_iter_matches_reference():
    for it in range(1, 120):
        for bsz in (1, 3, 4, 16):
            for interval in (1, 4, 7, 40, 100):
                for offset in (0, 2):
                    assert (tgeneral.check_update_at_this_iter(it, bsz, interval, offset)
                            == jgeneral.check_update_at_this_iter(it, bsz, interval, offset))
