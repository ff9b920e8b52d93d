"""Port vs reference: no_offload's `train_step(micro_group=G)`, the cameras
rendered G at a time through `render_cams` (strategies/base.py;
clm_gs_tpu/strategies/no_offload.py:64-81 and base.py:95-160).

The step of test_torch_train_step.py (bsz 4, SH degree 3, moments seeded so
that Adam's update is smooth in the gradient) with micro_group=2 goes
through both packages, the reference with f32 rasterizer gradients
(CLMGS_PACK_GRADS=0) and its caches cleared on both edges. The tolerances
are test_torch_train_step.py's: losses rtol 1e-5, the visible set and
`denom` exact, `xyz_grad_accum` rtol 1e-4 atol 1e-6, parameter moves 1e-4
of the group's largest move, first moments 1e-5 of the largest gradient
term, second moments rtol 1e-5. The port's groups of 2 and of 4 are held
to its one-camera step within the same bounds (the group's losses come from
one blurred pass and one backward, so sums run in another order).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clm_gs_tpu import optim as joptim
from clm_gs_tpu.data.cameras import stack_cameras as j_stack
from clm_gs_tpu.models import gaussians as jG
from clm_gs_tpu.strategies import no_offload as j_no_offload
from clm_gs_tpu_torch import convert, optim as toptim
from clm_gs_tpu_torch.data.cameras import stack_cameras as t_stack
from clm_gs_tpu_torch.strategies import no_offload as t_no_offload
from clm_gs_tpu_torch.utils.bench_scene import make_camera as t_make_camera
from tests.test_torch_train_step import FIELDS, _inputs, _np
from tests.test_train_synthetic import BG, H, ISECT_CAP, LRS, W
from tests.utils3d import make_camera

torch.set_num_threads(1)


def _result(params, mu, nu, xyz_grad_accum, denom, losses, visible_any, n_isects):
    return {"params": params, "mu": mu, "nu": nu, "xyz_grad_accum": xyz_grad_accum,
            "denom": denom, "losses": losses, "visible_any": visible_any,
            "max_isects": n_isects}


def _jax_step(state_np, opt_np, gts, micro_group):
    P = lambda d: jG.GaussianParams(**{f: jnp.asarray(d[f]) for f in FIELDS})
    state = jG.GaussianState(
        params=P(state_np["params"]), alive=jnp.asarray(state_np["alive"]),
        n_alive=jnp.asarray(state_np["n_alive"]),
        xyz_grad_accum=jnp.asarray(state_np["xyz_grad_accum"]),
        denom=jnp.asarray(state_np["denom"]),
        max_radii2d=jnp.asarray(state_np["max_radii2d"]),
    )
    opt = joptim.AdamState(P(opt_np["mu"]), P(opt_np["nu"]), jnp.asarray(opt_np["steps"]))
    cb = j_stack([make_camera(uid=i, width=W, height=H, angle=0.8 * i) for i in range(4)])
    s, o, out = j_no_offload.train_step(
        state, opt, cb, jnp.asarray(gts), 3, LRS, joptim.AdamConfig(), BG, W, H,
        ISECT_CAP, micro_group=micro_group,
    )
    assert int(out.max_isects) <= ISECT_CAP
    return _result(_np(s.params), _np(o.mu), _np(o.nu), np.array(s.xyz_grad_accum),
                   np.array(s.denom), np.array(out.losses), np.array(out.visible_any),
                   int(out.max_isects))


def _port_step(state_np, opt_np, gts, micro_group):
    state = convert.state_from_numpy(state_np, device="cpu")
    opt = convert.adam_from_numpy(opt_np, device="cpu")
    cb = t_stack([t_make_camera(uid=i, width=W, height=H, angle=0.8 * i)
                  for i in range(4)], device="cpu")
    lrs = {k: torch.tensor(np.asarray(v)) for k, v in LRS.items()}
    s, o, out = t_no_offload.train_step(
        state, opt, cb, torch.from_numpy(gts), 3, lrs, toptim.AdamConfig(),
        torch.tensor(np.asarray(BG)), W, H, micro_group=micro_group,
    )
    assert len(out.n_isects) == 4 and max(out.n_isects) == out.max_isects
    got_opt = convert.adam_to_numpy(o)
    return _result(convert.state_to_numpy(s)["params"], got_opt["mu"], got_opt["nu"],
                   s.xyz_grad_accum.numpy(), s.denom.numpy(), out.losses.numpy(),
                   out.visible_any.numpy(), out.max_isects)


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def reference(inputs):
    old = os.environ.get("CLMGS_PACK_GRADS")
    os.environ["CLMGS_PACK_GRADS"] = "0"
    jax.clear_caches()
    try:
        return _jax_step(*inputs, micro_group=2)
    finally:
        if old is None:
            os.environ.pop("CLMGS_PACK_GRADS")
        else:
            os.environ["CLMGS_PACK_GRADS"] = old
        jax.clear_caches()


@pytest.fixture(scope="module")
def port_g1(inputs):
    return _port_step(*inputs, micro_group=0)


def _assert_close(got, ref, state_np, opt_np):
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)
    np.testing.assert_array_equal(got["visible_any"], ref["visible_any"])
    assert got["max_isects"] == ref["max_isects"]
    np.testing.assert_array_equal(got["denom"], ref["denom"])
    np.testing.assert_allclose(got["xyz_grad_accum"], ref["xyz_grad_accum"],
                               rtol=1e-4, atol=1e-6)
    for f in FIELDS:
        p0 = state_np["params"][f]
        d_ref = ref["params"][f] - p0
        np.testing.assert_allclose(got["params"][f] - p0, d_ref,
                                   atol=1e-4 * np.abs(d_ref).max(), err_msg=f)
        g_scale = np.abs(ref["mu"][f] - 0.9 * opt_np["mu"][f]).max()
        np.testing.assert_allclose(got["mu"][f], ref["mu"][f], atol=1e-5 * g_scale,
                                   err_msg=f)
        np.testing.assert_allclose(got["nu"][f], ref["nu"][f], rtol=1e-5, err_msg=f)


def test_micro_group_matches_reference(inputs, reference):
    state_np, opt_np, gts = inputs
    _assert_close(_port_step(state_np, opt_np, gts, 2), reference, state_np, opt_np)


@pytest.mark.parametrize("micro_group", [2, 4, 8])
def test_micro_group_matches_one_camera_step(inputs, port_g1, micro_group):
    """Groups of 2, of the whole batch (4), and past it (8: G = bsz)."""
    state_np, opt_np, gts = inputs
    _assert_close(_port_step(state_np, opt_np, gts, micro_group), port_g1, state_np,
                  opt_np)


@pytest.mark.parametrize("micro_group,bsz,want", [(0, 4, 1), (1, 4, 1), (2, 4, 2),
                                                  (4, 4, 4), (8, 4, 4), (3, 4, 1)])
def test_group_size(micro_group, bsz, want):
    """The JAX step's G: micro_group when 0 < G < B, B when G >= B, 1 when 0,
    and 1 when G does not divide B."""
    assert t_no_offload.group_size(micro_group, bsz) == want
