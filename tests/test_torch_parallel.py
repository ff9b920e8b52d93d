"""Port vs reference: the sharded no_offload step of `clm_gs_tpu_torch/parallel`
on (data x gauss) meshes, each rank a gloo process on the CPU.

The inputs are built once here with numpy: `_scene(seed=5)` of
tests/test_train_synthetic.py at step 10 with seeded moments (Adam's first
step from zero moments is lr * sign(g); test_torch_train_step.py), random
ground truth, and `_spread_scene`'s layout of tests/test_parallel.py. The
workers (tests/torch_parallel_workers.py) import no JAX; they shard the
state, run one step on meshes 1x2 and 2x1 (world 2) and 2x2 and 1x4 (world
4) and return the state and moments gathered back. Here they are held
against the JAX package's and the port's single-device `train_step`, and
against the JAX package's own sharded step, whose gradients come out
n_gauss times too large.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clm_gs_tpu import optim as joptim
from clm_gs_tpu.models import gaussians as jG
from clm_gs_tpu.parallel.mesh import data_sharding as j_data_sharding
from clm_gs_tpu.parallel.mesh import make_mesh as j_make_mesh
from clm_gs_tpu.parallel.mesh import shard_capacity_tree as j_shard_tree
from clm_gs_tpu.parallel.shard import make_sharded_train_step as j_sharded_step
from clm_gs_tpu.strategies import no_offload as j_no_offload
from clm_gs_tpu_torch import convert, optim as toptim
from clm_gs_tpu_torch.config import parse_config
from clm_gs_tpu_torch.data.cameras import stack_cameras as t_stack
from clm_gs_tpu_torch.models.gaussians import GaussianState
from clm_gs_tpu_torch.parallel import mesh as M
from clm_gs_tpu_torch.parallel import multihost
from clm_gs_tpu_torch.strategies import no_offload as t_no_offload
from clm_gs_tpu_torch.utils.bench_scene import make_camera as t_make_camera
from tests import torch_parallel_workers as workers
from tests.test_parallel import _spread_scene
from tests.test_torch_cli import _unpacked_reference_grads
from tests.test_train_synthetic import BG, CAP, H, ISECT_CAP, LRS, W, _scene

torch.set_num_threads(1)

FIELDS = workers.FIELDS
MESHES = {2: ("1x2", "2x1"), 4: ("2x2", "1x4")}
STEP_MESHES = ("1x2", "2x1", "2x2")


def _inputs(state, sparse_adam=False, seed=5):
    """A case of workers.sharded_steps: the state at step 10 with seeded
    moments and statistics, the four cameras, random ground truth."""
    rng = np.random.RandomState(seed)
    params = {f: np.array(getattr(state.params, f)) for f in FIELDS}
    return {
        "state": {"params": params, "alive": np.array(state.alive),
                  "n_alive": np.array(state.n_alive),
                  "xyz_grad_accum": rng.uniform(0, 1, CAP).astype(np.float32),
                  "denom": rng.randint(0, 5, CAP).astype(np.float32),
                  "max_radii2d": np.zeros(CAP, np.float32)},
        "opt": {"mu": {f: (1e-3 * rng.normal(size=v.shape)).astype(np.float32)
                       for f, v in params.items()},
                "nu": {f: rng.uniform(0.5e-2, 1.5e-2, v.shape).astype(np.float32)
                       for f, v in params.items()},
                "steps": np.float32(10.0)},
        "cams": convert.cameras_to_numpy(t_stack(
            [t_make_camera(uid=i, width=W, height=H, angle=0.8 * i) for i in range(4)],
            device="cpu")),
        "gts": rng.rand(4, 3, H, W).astype(np.float32),
        "sparse_adam": sparse_adam,
        "lrs": {k: np.asarray(v) for k, v in LRS.items()},
        "sh_degree": 3,
    }


def _jax_inputs(case):
    P = lambda d: jG.GaussianParams(**{f: jnp.asarray(d[f]) for f in FIELDS})
    s = case["state"]
    state = jG.GaussianState(
        params=P(s["params"]), alive=jnp.asarray(s["alive"]),
        n_alive=jnp.asarray(s["n_alive"]), xyz_grad_accum=jnp.asarray(s["xyz_grad_accum"]),
        denom=jnp.asarray(s["denom"]), max_radii2d=jnp.asarray(s["max_radii2d"]))
    o = case["opt"]
    opt = joptim.AdamState(P(o["mu"]), P(o["nu"]), jnp.asarray(o["steps"]))
    _, cb = _scene()
    return state, opt, cb, jnp.asarray(case["gts"])


def _jax_result(s, o, out):
    return {"state": {"params": {f: np.array(getattr(s.params, f)) for f in FIELDS},
                      "xyz_grad_accum": np.array(s.xyz_grad_accum),
                      "denom": np.array(s.denom)},
            "opt": {"mu": {f: np.array(getattr(o.mu, f)) for f in FIELDS},
                    "nu": {f: np.array(getattr(o.nu, f)) for f in FIELDS}},
            "losses": np.array(out.losses), "max_isects": int(out.max_isects),
            "max_shard_vis": (None if getattr(out, "max_shard_vis", None) is None
                              else int(out.max_shard_vis))}


def _jax_single(case):
    state, opt, cb, gts = _jax_inputs(case)
    s, o, out = j_no_offload.train_step(state, opt, cb, gts, 3, LRS, joptim.AdamConfig(),
                                        BG, W, H, ISECT_CAP,
                                        sparse_adam=case["sparse_adam"])
    return _jax_result(s, o, out)


def _jax_sharded(case, shape, gather_cap=0):
    """The JAX package's own sharded step on the virtual CPU devices."""
    state, opt, cb, gts = _jax_inputs(case)
    n = int(np.prod([int(a) for a in shape.split("x")]))
    mesh = j_make_mesh(shape, jax.devices()[:n])
    cap = state.capacity
    state, opt = j_shard_tree(state, mesh, cap), j_shard_tree(opt, mesh, cap)
    cb = jax.tree.map(lambda x: jax.device_put(x, j_data_sharding(mesh)), cb)
    gts = jax.device_put(gts, j_data_sharding(mesh))
    step = j_sharded_step(mesh, W, H, ISECT_CAP, gather_cap=gather_cap)
    return _jax_result(*step(state, opt, cb, gts, 3, LRS, joptim.AdamConfig(), BG))


def _port_single(case):
    s, o, out = t_no_offload.train_step(
        convert.state_from_numpy(case["state"], "cpu"),
        convert.adam_from_numpy(case["opt"], "cpu"),
        convert.cameras_from_numpy(case["cams"], "cpu"), torch.from_numpy(case["gts"]),
        3, {k: torch.tensor(v) for k, v in case["lrs"].items()}, toptim.AdamConfig(),
        torch.zeros(3), W, H, sparse_adam=case["sparse_adam"])
    return {"state": convert.state_to_numpy(s), "opt": convert.adam_to_numpy(o),
            "losses": out.losses.numpy(), "n_isects": out.n_isects,
            "visible_any": out.visible_any.numpy()}


@pytest.fixture(scope="module")
def runs():
    """Every case on every mesh (rank 0's and the other ranks' results),
    and the single-device and JAX sharded references."""
    scene5, _ = _scene(seed=5)
    spread, _ = _spread_scene()
    cases = {"scene5": _inputs(scene5), "scene5_sparse": _inputs(scene5, True),
             "spread": _inputs(spread, seed=9)}
    with _unpacked_reference_grads():
        ref = {
            "jax": {"scene5": _jax_single(cases["scene5"])},
            "jax_1x2": _jax_sharded(cases["scene5"], "1x2"),
            "jax_spread_1x4": _jax_sharded(cases["spread"], "1x4"),
            "jax_budget16_1x4": _jax_sharded(cases["scene5"], "1x4", gather_cap=16),
        }
    ref["port"] = {k: _port_single(c) for k, c in cases.items()}
    got = {}
    for world, meshes in MESHES.items():
        per_rank = workers.launch(workers.sharded_steps, world, meshes, cases)
        for key in per_rank[0]:
            got[key] = [r[key] for r in per_rank]
    return cases, ref, got


def _close_moves(got, want, p0, rel, what):
    """Parameter moves agree within `rel` of the largest move of the group."""
    for f in FIELDS:
        d_want = want[f] - p0[f]
        np.testing.assert_allclose(got[f] - p0[f], d_want,
                                   atol=rel * np.abs(d_want).max(), err_msg=f"{what} {f}")


@pytest.mark.parametrize("shape", STEP_MESHES)
@pytest.mark.parametrize("against", ["jax", "port"])
def test_sharded_step_matches_single_device(runs, shape, against):
    """Losses (sorted) rtol 1e-4 / atol 1e-6; parameters rtol 1e-3 / atol
    1e-5 (tests/test_parallel.py's bounds) and their moves within 1e-4 of the
    group's largest; first moments within 1e-5 of the gradient's largest
    term; xyz_grad_accum rtol 1e-4 / atol 1e-6; denom exact. Not n_gauss
    times the single-device gradients and statistics."""
    cases, ref, got = runs
    case, want, out = cases["scene5"], ref[against]["scene5"], got[shape, "scene5"][0]
    np.testing.assert_allclose(np.sort(out["losses"]), np.sort(want["losses"]),
                               rtol=1e-4, atol=1e-6)
    p0 = case["state"]["params"]
    for f in FIELDS:
        np.testing.assert_allclose(out["state"]["params"][f], want["state"]["params"][f],
                                   rtol=1e-3, atol=1e-5, err_msg=f)
        mu0 = case["opt"]["mu"][f]
        g_scale = np.abs(want["opt"]["mu"][f] - 0.9 * mu0).max()
        np.testing.assert_allclose(out["opt"]["mu"][f], want["opt"]["mu"][f],
                                   atol=1e-5 * g_scale, err_msg=f)
        np.testing.assert_allclose(out["opt"]["nu"][f], want["opt"]["nu"][f],
                                   rtol=1e-5, err_msg=f)
    _close_moves(out["state"]["params"], want["state"]["params"], p0, 1e-4, shape)
    np.testing.assert_allclose(out["state"]["xyz_grad_accum"],
                               want["state"]["xyz_grad_accum"], rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(out["state"]["denom"], want["state"]["denom"])


@pytest.mark.parametrize("shape", STEP_MESHES)
def test_sharded_step_is_the_same_on_every_rank(runs, shape):
    """Every rank's gathered state, moments and losses are equal to the bit,
    and the instance counts equal the single-device step's."""
    _, ref, got = runs
    first = got[shape, "scene5"][0]
    for other in got[shape, "scene5"][1:]:
        np.testing.assert_array_equal(other["losses"], first["losses"])
        for f in FIELDS:
            np.testing.assert_array_equal(other["state"]["params"][f],
                                          first["state"]["params"][f])
            np.testing.assert_array_equal(other["opt"]["mu"][f], first["opt"]["mu"][f])
    assert first["n_isects"] == ref["port"]["scene5"]["n_isects"]
    assert first["max_isects"] == max(ref["port"]["scene5"]["n_isects"])


@pytest.mark.parametrize("shape", STEP_MESHES)
def test_sparse_adam_matches_single_device(runs, shape):
    """sparse_adam: the rows no camera of the batch saw keep their
    parameters; moves within 1e-6 of the largest of the port's single step."""
    cases, ref, got = runs
    case, want = cases["scene5_sparse"], ref["port"]["scene5_sparse"]
    out = got[shape, "scene5_sparse"][0]
    np.testing.assert_array_equal(out["visible_any"], want["visible_any"])
    hidden = ~want["visible_any"] & case["state"]["alive"]
    p0 = case["state"]["params"]
    assert hidden.any()
    for f in FIELDS:
        np.testing.assert_array_equal(out["state"]["params"][f][hidden], p0[f][hidden])
    _close_moves(out["state"]["params"], want["state"]["params"], p0, 1e-6, shape)


def _increment_ratio(got, want, start):
    """Median ratio of two runs' increments of a statistic where the
    single-device increment is clearly positive."""
    d_got, d_want = got - start, want - start
    keep = d_want > 1e-3 * d_want.max()
    return float(np.median(d_got[keep] / d_want[keep]))


def _gradient(res, case, f):
    """The batch gradient a step folded into the first moments of the live
    rows (Adam leaves the other rows' moments as they were)."""
    alive = case["state"]["alive"]
    return (res["opt"]["mu"][f][alive] - 0.9 * case["opt"]["mu"][f][alive]) / 0.1


def test_reference_sharded_gradients_are_n_gauss_times_too_large(runs):
    """The JAX package's sharded step on a 1x2 mesh: the densification
    statistic and every gradient come out twice the single-device values
    (its all_gather's transpose sums both gauss ranks' identical cotangents);
    the port's are the single-device values. denom is the same in all."""
    cases, ref, got = runs
    case = cases["scene5"]
    start = case["state"]["xyz_grad_accum"]
    single, jax_sh, port_sh = ref["jax"]["scene5"], ref["jax_1x2"], got["1x2", "scene5"][0]
    accum = lambda r: r["state"]["xyz_grad_accum"]
    assert _increment_ratio(accum(jax_sh), accum(single), start) == pytest.approx(2.0, rel=1e-3)
    assert _increment_ratio(accum(port_sh), accum(single), start) == pytest.approx(1.0, rel=1e-4)
    for f in FIELDS:
        g1, gj, gp = (_gradient(r, case, f) for r in (single, jax_sh, port_sh))
        keep = np.abs(g1) > 1e-2 * np.abs(g1).max()
        assert np.median(gj[keep] / g1[keep]) == pytest.approx(2.0, rel=1e-3), f
        assert np.median(gp[keep] / g1[keep]) == pytest.approx(1.0, rel=1e-4), f
    np.testing.assert_array_equal(jax_sh["state"]["denom"], single["state"]["denom"])
    np.testing.assert_array_equal(port_sh["state"]["denom"], single["state"]["denom"])


def test_exact_gather_equals_the_unbudgeted_reference(runs):
    """_spread_scene on a 1x4 mesh: the port's exact-size gather gives the
    JAX package's unbudgeted step (gather_cap=0): the same losses and denom,
    and its statistic and gradients once where the reference's are four
    times (within 1e-4 relative); the same largest visible count of a shard."""
    cases, ref, got = runs
    case, jx, out = cases["spread"], ref["jax_spread_1x4"], got["1x4", "spread"][0]
    np.testing.assert_allclose(out["losses"], jx["losses"], rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(out["state"]["denom"], jx["state"]["denom"])
    start = case["state"]["xyz_grad_accum"]
    np.testing.assert_allclose(4 * (out["state"]["xyz_grad_accum"] - start),
                               jx["state"]["xyz_grad_accum"] - start, rtol=1e-4, atol=1e-6)
    for f in FIELDS:
        gj = _gradient(jx, case, f)
        np.testing.assert_allclose(4 * _gradient(out, case, f), gj,
                                   atol=1e-4 * np.abs(gj).max(), err_msg=f)
    assert out["max_shard_vis"] == jx["max_shard_vis"]
    assert out["n_isects"] == ref["port"]["spread"]["n_isects"]


def test_exact_gather_drops_no_row_where_the_budget_overflows(runs):
    """_scene(seed=5) on a 1x4 mesh with the JAX package's gather_cap=16
    (tests/test_parallel.py:228): a shard's 4-row budget drops rows, its
    losses move away from the single-device step's; the port's gather of the
    same demand drops none and keeps them."""
    _, ref, got = runs
    jx, out, single = ref["jax_budget16_1x4"], got["1x4", "scene5"][0], ref["jax"]["scene5"]
    assert jx["max_shard_vis"] == out["max_shard_vis"] > 16 // 4
    assert np.abs(jx["losses"] - single["losses"]).max() > 1e-3
    np.testing.assert_allclose(out["losses"], single["losses"], rtol=1e-5, atol=1e-7)
    assert out["n_isects"] == ref["port"]["scene5"]["n_isects"]


@pytest.mark.parametrize("shape", [s for m in MESHES.values() for s in m])
def test_each_rank_holds_its_share_of_the_rows(runs, shape):
    """Every capacity leaf of the state and both moments holds C / n_gauss
    rows on each rank, and the ranks sit on the mesh in row-major order."""
    n_data, n_gauss = M.mesh_dims(shape, int(np.prod([int(a) for a in shape.split("x")])))
    per_rank = runs[2][shape, "scene5"]
    assert len(per_rank) == n_data * n_gauss
    for rank, out in enumerate(per_rank):
        assert out["mesh"] == {"data": n_data, "gauss": n_gauss}
        assert out["index"] == (rank // n_gauss, rank % n_gauss)
        assert set(out["rows"].values()) == {CAP // n_gauss}, out["rows"]


@pytest.mark.parametrize("shape,world,dims", [
    ("", 4, (4, 1)), ("4", 4, (4, 1)), ("2x4", 8, (2, 4)), ("1x2", 2, (1, 2)),
    ("1x1", 1, (1, 1)), ("", 1, (1, 1)),
])
def test_mesh_grammar(shape, world, dims):
    assert M.mesh_dims(shape, world) == dims


@pytest.mark.parametrize("shape,world", [
    ("2x4", 4), ("4", 2), ("3", 4), ("1x2", 1), ("0x2", 0), ("2x", 2), ("ax2", 2),
    ("2x2x1", 4),
])
def test_mesh_grammar_errors(shape, world):
    with pytest.raises(ValueError, match="--mesh_shape"):
        M.mesh_dims(shape, world)


def test_capacity_must_divide_among_the_gauss_ranks():
    state = convert.state_from_numpy(_inputs(_scene(seed=5)[0])["state"], "cpu")
    for n_gauss in (3, 5):
        mesh = M.Mesh(1, n_gauss, 0, 0)
        with pytest.raises(ValueError, match="not a multiple of the gauss axis"):
            M.shard_state(state, mesh)
    mesh = M.Mesh(1, 4, 0, 2)
    sharded = M.shard_state(state, mesh)
    assert isinstance(sharded, GaussianState) and sharded.n_alive == state.n_alive
    np.testing.assert_array_equal(sharded.params.sh.numpy(),
                                  state.params.sh[64:96].numpy())
    assert sharded.params.sh.untyped_storage().nbytes() == 32 * 48 * 4


def test_data_slice():
    cb = t_stack([t_make_camera(uid=i, width=W, height=H, angle=0.8 * i)
                  for i in range(4)], device="cpu")
    gts = torch.arange(4.0)
    cams, g = M.data_slice((cb, gts), M.Mesh(2, 1, 1, 0))
    assert torch.equal(g, gts[2:]) and torch.equal(cams.Ks, cb.Ks[2:])
    assert (cams.width, cams.height) == (W, H)
    with pytest.raises(ValueError, match="does not divide bsz 4"):
        M.data_slice(gts, M.Mesh(3, 1, 0, 0))


def test_bootstrap_without_a_group():
    """No flags and no torchrun variables: no process group, and this
    process is the one that writes."""
    cfg = parse_config(["-s", "x", "-m", "y"])
    for k in ("RANK", "WORLD_SIZE"):
        assert k not in os.environ
    assert multihost.maybe_initialize(cfg, "cpu") is False
    assert multihost.is_rank0()
    with multihost.rank0_first():
        pass
    assert multihost.fully_replicated_host_value(torch.arange(3)).tolist() == [0, 1, 2]


@pytest.mark.parametrize("flags,match", [
    (["--dist_num_processes", "2"], "needs --dist_coordinator"),
    (["--dist_coordinator", "127.0.0.1:1", "--dist_num_processes", "2"],
     "--dist_process_id -1 is not a rank of 2"),
    (["--dist_coordinator", "127.0.0.1:1", "--dist_num_processes", "2",
      "--dist_process_id", "2"], "--dist_process_id 2 is not a rank of 2"),
])
def test_bootstrap_flag_errors(flags, match):
    cfg = parse_config(["-s", "x", "-m", "y"] + flags)
    with pytest.raises(ValueError, match=match):
        multihost.maybe_initialize(cfg, "cpu")


def test_bootstrap_on_the_card_needs_one():
    cfg = parse_config(["-s", "x", "-m", "y", "--dist_coordinator", "127.0.0.1:1"])
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        multihost.maybe_initialize(cfg, "cuda")
