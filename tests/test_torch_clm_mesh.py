"""Port vs reference: clm_offload on a (data x gauss) mesh, each rank a gloo
process on the CPU (tests/torch_clm_workers.py, which imports no JAX).

The scene is tests/test_parallel.py's `_spread_scene`, whose live rows span
the whole capacity (so every gauss shard holds live, visible rows), with
ground truth rendered by the reference and the model then perturbed as
tests/test_strategies.py's `_perturbed` does. The workers run one batch
from seeded moments and three from zero moments on meshes 1x2, 2x1 and 2x2
(two camera chains where the data axis is 2) and return the whole state,
moments and host rows gathered back, and each rank's own host rows. They
are held against the port's single-process clm, the JAX package's
single-device clm and, at 2x2, the JAX package's own two-chain run
(tests/test_parallel.py:246), the reference with its f32 rasterizer
gradients (CLMGS_PACK_GRADS=0) and a fresh state for each run (its batch
donates the caller's buffers). Three batches use tests/test_parallel.py's
bounds (losses sorted per batch rtol 1e-4 atol 1e-6; parameters, SH
included, rtol 1e-3 atol 1e-5); one batch from seeded moments
test_torch_clm.py's (losses rtol 1e-5, parameter moves 1e-4 of the group's
largest move, first moments 1e-5 of the largest gradient term).

`_scene(seed=11)` of tests/test_parallel.py:246, whose ground truth is the
unperturbed scene's own render, runs on the meshes against the port's
single process only: its first batch's loss is rendering round-off (~1e-9
in the reference, ~3e-8 in the port), so Adam's first step lr * sign(g)
follows each package's own rounding and the two packages' runs part.
"""

import os
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from clm_gs_tpu import config as jconfig, optim as joptim
from clm_gs_tpu.data.cameras import stack_cameras as j_stack
from clm_gs_tpu.models import gaussians as jG
from clm_gs_tpu.parallel.mesh import make_mesh as j_make_mesh
from clm_gs_tpu.parallel.mesh import shard_capacity_tree as j_shard_tree
from clm_gs_tpu.strategies import clm_offload as j_clm
from clm_gs_tpu.strategies import offload_common as j_oc
from clm_gs_tpu_torch import convert
from clm_gs_tpu_torch.data.cameras import stack_cameras as t_stack
from clm_gs_tpu_torch.parallel import mesh as M
from clm_gs_tpu_torch.strategies import clm_offload as t_clm
from clm_gs_tpu_torch.strategies import offload_common as t_oc
from clm_gs_tpu_torch.utils.bench_scene import make_camera as t_make_camera
from tests import torch_clm_workers as cw
from tests import torch_parallel_workers as workers
from tests.test_parallel import _spread_scene
from tests.test_torch_clm import _cfg, _random_visibility, _run_jax
from tests.test_torch_densify import _jax_state
from tests.test_torch_native import reference_native
from tests.test_train_synthetic import BG, CAP, H, ISECT_CAP, LRS, W, _render_gts, _scene
from tests.utils3d import make_camera

torch.set_num_threads(1)

FIELDS = ("xyz", "opacity", "log_scale", "quat", "sh")
MESHES = {2: ("1x2", "2x1"), 4: ("2x2",)}
SHAPES = ("1x2", "2x1", "2x2")


def _np_state(state):
    d = {"params": {f: np.array(getattr(state.params, f)) for f in FIELDS},
         "alive": np.array(state.alive), "n_alive": np.array(state.n_alive)}
    d.update({f: np.array(getattr(state, f))
              for f in ("xyz_grad_accum", "denom", "max_radii2d")})
    return d


def _case(state, gts, batches, sparse=False, opt=None):
    cams = t_stack([t_make_camera(uid=i, width=W, height=H, angle=0.8 * i)
                    for i in range(4)], device="cpu")
    return {"state": _np_state(state), "cams": convert.cameras_to_numpy(cams),
            "gts": np.array(gts), "sparse_adam": sparse, "opt": opt,
            "lrs": {k: np.asarray(v) for k, v in LRS.items()}, "batches": batches}


def _spread():
    """_spread_scene's ground truth, and the scene perturbed as
    tests/test_strategies.py's _perturbed perturbs _scene."""
    state, cb = _spread_scene()
    gts = _render_gts(state, cb)
    p = state.params
    p = jG.GaussianParams(
        xyz=p.xyz + 0.02 * jax.random.normal(jax.random.PRNGKey(7), p.xyz.shape),
        opacity=p.opacity - 0.3, log_scale=p.log_scale + 0.1, quat=p.quat, sh=p.sh * 0.8)
    return replace(state, params=p), gts


def _seeded(params_np, seed=5):
    """Seeded moments at step 10 (Adam's first step from zero moments is
    lr * sign(g))."""
    rng = np.random.RandomState(seed)
    return {"mu": {f: (1e-3 * rng.normal(size=v.shape)).astype(np.float32)
                   for f, v in params_np.items()},
            "nu": {f: rng.uniform(0.5e-2, 1.5e-2, v.shape).astype(np.float32)
                   for f, v in params_np.items()},
            "steps": np.float32(10.0)}


def _jax_two_chains(case):
    """tests/test_parallel.py:246's run: the reference's clm with two camera
    chains on its 2x2 mesh of virtual CPU devices."""
    cfg = _cfg(jconfig, case["sparse_adam"])
    s = _jax_state(case["state"])
    ctx = j_clm.make_context(cfg, s, joptim.AdamConfig())
    mesh = j_make_mesh("2x2", jax.devices()[:4])
    s = j_shard_tree(j_clm.strip_device_sh(s), mesh, s.capacity)
    opt = joptim.init_adam(s.params)
    cb = j_stack([make_camera(uid=i, width=W, height=H, angle=0.8 * i) for i in range(4)])
    losses = []
    for _ in range(case["batches"]):
        s, opt, ctx, out = j_clm.train_one_batch(
            s, opt, ctx, cb, jnp.asarray(case["gts"]), 3, LRS, joptim.AdamConfig(), BG,
            W, H, ISECT_CAP, cfg, n_chains=2,
            data_sharding=NamedSharding(mesh, PartitionSpec("data")))
        losses.append(np.array(out.losses))
    m = j_clm.materialize(s, ctx)
    return {"losses": np.array(losses),
            "params": {f: np.array(getattr(m.params, f)) for f in FIELDS}}


@pytest.fixture(scope="module")
def runs():
    """Every case on every mesh (each rank's results), the port's single
    process, and the reference's single device and two-chain runs."""
    reference_native()
    spread, gts = _spread()
    s11, cb11 = _scene(seed=11)
    cases = {
        "three": _case(spread, gts, 3),
        "three_sparse": _case(spread, gts, 3, sparse=True),
        "one": _case(spread, gts, 1, opt=_seeded(_np_state(spread)["params"])),
        "scene11": _case(s11, _render_gts(s11, cb11), 3),
    }
    port = {k: cw.run_batches(c) for k, c in cases.items()}
    old = os.environ.get("CLMGS_PACK_GRADS")
    os.environ["CLMGS_PACK_GRADS"] = "0"
    jax.clear_caches()
    try:
        ref = {k: _run_jax(cases[k]["state"], cases[k]["gts"], cases[k]["sparse_adam"],
                           cases[k]["batches"], cases[k]["opt"])
               for k in ("three", "one")}
        ref["two_chains"] = _jax_two_chains(cases["three"])
    finally:
        if old is None:
            os.environ.pop("CLMGS_PACK_GRADS")
        else:
            os.environ["CLMGS_PACK_GRADS"] = old
        jax.clear_caches()
    got = {}
    for world, meshes in MESHES.items():
        per_rank = workers.launch(cw.clm_meshes, world, meshes, cases, timeout=300)
        for key in per_rank[0]:
            got[key] = [r[key] for r in per_rank]
    return cases, port, ref, got


def _params(res):
    return res["state"]["params"] if "state" in res else res["params"]


def _within_mesh_bounds(got, want):
    """tests/test_parallel.py:246's bounds."""
    np.testing.assert_allclose(np.sort(got["losses"], 1), np.sort(want["losses"], 1),
                               rtol=1e-4, atol=1e-6)
    for f in FIELDS:
        np.testing.assert_allclose(_params(got)[f].reshape(_params(want)[f].shape),
                                   _params(want)[f], rtol=1e-3, atol=1e-5, err_msg=f)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("case", ["three", "scene11"])
def test_batches_match_the_single_process(runs, shape, case):
    """Three batches from zero moments on each mesh and every rank against
    the port's single process; the host moments too."""
    _, port, _, got = runs
    for res in got[shape, case]:
        _within_mesh_bounds(res, port[case])
        for k in ("mu", "nu"):
            np.testing.assert_allclose(res[k]["sh"], port[case][k]["sh"], rtol=1e-3,
                                       atol=1e-5, err_msg=k)
        assert res["step_count"] == port[case]["step_count"] == 3


@pytest.mark.parametrize("shape", SHAPES)
def test_batches_match_the_reference(runs, shape):
    """Three batches from zero moments against the JAX package's
    single-device clm."""
    _, _, ref, got = runs
    _within_mesh_bounds(got[shape, "three"][0], ref["three"])


def test_two_chains_match_the_reference_two_chain_run(runs):
    """2x2 against the JAX package's own two-chain run: the same losses in
    the same step-major order (each step's two chains in data order), the
    same parameters."""
    _, _, ref, got = runs
    out, want = got["2x2", "three"][0], ref["two_chains"]
    np.testing.assert_allclose(np.array(out["losses"]), want["losses"], rtol=1e-4,
                               atol=1e-6)
    _within_mesh_bounds(out, want)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("against", ["port", "reference"])
def test_one_batch_from_seeded_moments(runs, shape, against):
    """test_torch_clm.py's one-batch bounds: losses, denom, the statistic,
    parameter moves, first and second moments, the SH rows' included."""
    cases, port, ref, got = runs
    case, out = cases["one"], got[shape, "one"][0]
    want = port["one"] if against == "port" else ref["one"]
    wp = _params(want)
    np.testing.assert_allclose(np.sort(out["losses"][0]), np.sort(want["losses"][0]),
                               rtol=1e-5)
    ws = want["state"] if "state" in want else want
    np.testing.assert_array_equal(out["state"]["denom"], ws["denom"])
    np.testing.assert_allclose(out["state"]["xyz_grad_accum"], ws["xyz_grad_accum"],
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(out["visible_any"], want["visible_any"])
    for f in FIELDS:
        p0 = case["state"]["params"][f].reshape(wp[f].shape)
        d_want = wp[f] - p0
        np.testing.assert_allclose(out["state"]["params"][f].reshape(p0.shape) - p0, d_want,
                                   atol=1e-4 * np.abs(d_want).max(), err_msg=f)
        mu0 = case["opt"]["mu"][f].reshape(wp[f].shape)
        np.testing.assert_allclose(out["mu"][f].reshape(mu0.shape), want["mu"][f],
                                   atol=1e-5 * np.abs(want["mu"][f] - 0.9 * mu0).max(),
                                   err_msg=f)
        np.testing.assert_allclose(out["nu"][f].reshape(mu0.shape), want["nu"][f],
                                   rtol=1e-5, err_msg=f)
    assert out["max_isects"] == want["max_isects"]


@pytest.mark.parametrize("shape", SHAPES)
def test_sparse_adam(runs, shape):
    """sparse_adam: the rows no camera saw in the last batch keep what the
    batch before left them; three batches within the bounds of the port's
    single process, the same visibility."""
    _, port, _, got = runs
    out, want = got[shape, "three_sparse"][0], port["three_sparse"]
    np.testing.assert_array_equal(out["visible_any"], want["visible_any"])
    assert (~want["visible_any"] & want["state"]["alive"]).any()
    _within_mesh_bounds(out, want)


@pytest.mark.parametrize("shape", ["2x1", "2x2"])
def test_data_replicas_are_bit_identical(runs, shape):
    """The data ranks of a gauss group hold the same host SH rows and
    moments to the bit, and gradient buffers back at zero; the finish sets
    were summed over the data group (bytes counted), once per row."""
    _, _, _, got = runs
    n_data, n_gauss = (int(a) for a in shape.split("x"))
    for case in ("three", "three_sparse", "one"):
        per_rank = got[shape, case]
        for g in range(n_gauss):
            group = [r["local"] for r in per_rank if r["index"][1] == g]
            assert len(group) == n_data
            for k in ("sh_host", "exp_avg", "exp_avg_sq"):
                for other in group[1:]:
                    np.testing.assert_array_equal(other[k], group[0][k], err_msg=k)
            for r in group:
                assert not r["sh_grad_host"].any()
        assert all(r["data_sum_bytes"] > 0 for r in per_rank)


@pytest.mark.parametrize("shape", SHAPES)
def test_each_rank_holds_its_share_of_the_rows(runs, shape):
    """C/n_gauss rows of the card state and of the host SH rows and moments
    on each rank, the ranks in row-major mesh order; no data sum where the
    data axis is 1."""
    _, _, _, got = runs
    n_data, n_gauss = (int(a) for a in shape.split("x"))
    per_rank = got[shape, "three"]
    assert len(per_rank) == n_data * n_gauss
    for rank, r in enumerate(per_rank):
        assert r["mesh"] == {"data": n_data, "gauss": n_gauss}
        assert r["index"] == (rank // n_gauss, rank % n_gauss)
        local = r["local"]
        assert local["card_rows"] == CAP // n_gauss
        for k in ("sh_host", "exp_avg", "exp_avg_sq", "sh_grad_host"):
            assert local[k].shape == (CAP // n_gauss, 48), k
        assert (r["data_sum_bytes"] > 0) == (n_data > 1)


@pytest.mark.parametrize("shape", SHAPES)
def test_order_inputs_sum_to_the_whole_scene(runs, shape):
    """On the mesh, each rank's Hamming matrix and counts summed over its
    gauss group equal the single device's; each shard's ids are its part of
    the whole filter."""
    cases, _, _, got = runs
    case = cases["three"]
    state = convert.state_from_numpy(case["state"], "cpu")
    cams = convert.cameras_from_numpy(case["cams"], "cpu")
    p = state.params
    F = t_oc.calculate_filters(p.xyz, p.quat, p.log_scale, state.alive, cams.viewmats,
                               cams.Ks, W, H, 0.0)
    d, counts = t_oc.order_inputs(F)
    per_rank = got[shape, "order"]
    for r in per_rank:
        np.testing.assert_array_equal(r["dist"], d.numpy())
        np.testing.assert_array_equal(r["counts"], counts.numpy())
    n_gauss = int(shape.split("x")[1])
    for b in range(4):
        ids = np.concatenate([per_rank[g]["ids"][b] for g in range(n_gauss)])
        np.testing.assert_array_equal(ids, F.ids[b].numpy())


@pytest.mark.parametrize("n_gauss", [3, 4])
def test_globally_phased_samples_sum_to_the_whole_matrix(n_gauss):
    """Shards of 50 and 40 rows (not multiples of the stride): each
    shard's filter sampled at its global phase gives Hamming matrices and
    counts that sum to the whole state's, which equal the reference's."""
    state_np, _ = _spread_np_with_capacity(150 if n_gauss == 3 else 160)
    cams = t_stack([t_make_camera(uid=i, width=W, height=H, angle=0.8 * i)
                    for i in range(4)], device="cpu")
    state = convert.state_from_numpy(state_np, "cpu")
    p = state.params
    args = (cams.viewmats, cams.Ks, W, H, 0.0)
    whole = t_oc.calculate_filters(p.xyz, p.quat, p.log_scale, state.alive, *args)
    d_sum = torch.zeros(4, 4, dtype=torch.int32)
    c_sum = torch.zeros(4, dtype=torch.int64)
    for g in range(n_gauss):
        sh = M.shard_state(state, M.Mesh(1, n_gauss, 0, g))
        q, n = sh.params, sh.capacity
        F = t_oc.calculate_filters(q.xyz, q.quat, q.log_scale, sh.alive, *args,
                                   sample_phase=-g * n % t_oc.SAMPLE_STRIDE)
        d, c = t_oc.order_inputs(F)
        d_sum += d
        c_sum += c
    d_whole, c_whole = t_oc.order_inputs(whole)
    np.testing.assert_array_equal(d_sum.numpy(), d_whole.numpy())
    np.testing.assert_array_equal(c_sum.numpy(), c_whole.numpy())
    jx = np.asarray(j_oc.hamming_distance_matrix(whole.sample.numpy()))
    np.testing.assert_array_equal(d_whole.numpy(), jx)
    assert d_whole.numpy().max() > 0


def _spread_np_with_capacity(C):
    """_spread_scene's construction at capacity C (every row live, half of
    them far outside every frustum)."""
    from tests.utils3d import random_gaussians

    rng = np.random.RandomState(9)
    xyz, log_scales, quats, opacity, sh = random_gaussians(C, rng)
    xyz = xyz.copy()
    xyz[np.random.RandomState(9).rand(C) < 0.5] *= 40.0
    params = {"xyz": xyz, "opacity": opacity, "log_scale": log_scales, "quat": quats,
              "sh": sh.reshape(C, 48)}
    params = {k: np.asarray(v, np.float32) for k, v in params.items()}
    z = np.zeros(C, np.float32)
    return {"params": params, "alive": np.ones(C, bool), "n_alive": np.array(C),
            "xyz_grad_accum": z, "denom": z, "max_radii2d": z}, C


@pytest.mark.parametrize("reorder", [True, False])
def test_finish_sets_of_two_chains_match_reference(reorder):
    """_order_and_finish_sets with n_chains=2 against the reference's: the
    order, one finish set per step, each row at its last step over both
    chains."""
    reference_native()
    vis, ids, padded, alive = _random_visibility()
    dist = np.asarray(j_oc.hamming_distance_matrix(vis[:, ::32]))
    counts = np.array([len(i) for i in ids])
    j_order, j_sets, j_never = j_clm._order_and_finish_sets(
        padded, counts, dist, alive, reorder, n_chains=2)
    t_order, t_sets, t_never = t_clm._order_and_finish_sets(
        [torch.from_numpy(i) for i in ids], torch.from_numpy(dist.copy()),
        torch.from_numpy(alive), reorder, torch.from_numpy(counts), n_chains=2)
    np.testing.assert_array_equal(t_order.numpy(), j_order)
    assert len(t_sets) == len(j_sets) == 4
    for t, j in zip(t_sets, j_sets):
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(t.numpy(), j)
    np.testing.assert_array_equal(t_never.numpy(), j_never)
    S = 4
    last = np.full(len(alive), -1)
    for s in range(S):
        for d in range(2):
            last[ids[int(t_order[d * S + s])]] = s
    for s, rows in enumerate(t_sets):
        np.testing.assert_array_equal(rows.numpy(), np.nonzero(last == s)[0])
