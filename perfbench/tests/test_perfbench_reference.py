"""The plain reference against the port's plain path on the CPU, at small
sizes: projection, the rendered image, one camera's gradients, and the
check's readings over a whole small run of each cell. (A test may import
both; the reference imports nothing of the port.)"""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from clm_gs_tpu_torch.models.gaussians import GaussianParams  # noqa: E402
from clm_gs_tpu_torch.ops.projection import fully_fused_projection  # noqa: E402
from clm_gs_tpu_torch.strategies.base import (photometric_loss,  # noqa: E402
                                              render_one_cam)
from perfbench import harness  # noqa: E402
from perfbench.reference import gs3d  # noqa: E402
from perfbench.tests import small  # noqa: E402


@pytest.fixture(scope="module", params=["bicycle-6m", "bigcity-25m"])
def scene(request):
    return harness.Scene(small.config(request.param), 4, "cpu")


def _cam(scene, j=0):
    i = int(scene.cams["train"][j])
    c = scene.cams
    return i, c["viewmats"][i], c["Ks"][i], c["camtoworlds"][i]


def test_projection(scene):
    p = scene.first
    _, view, K, _ = _cam(scene)
    m2d, conic, depth, radius = gs3d.project(p["xyz"], p["quat"], p["log_scale"], view, K, 96, 64)
    ref = fully_fused_projection(p["xyz"], p["quat"], torch.exp(p["log_scale"]), view[None],
                                 K[None], 96, 64)
    vis = radius > 0
    assert vis.sum() > 100
    assert torch.equal(vis, ref.radii[0] > 0)
    assert torch.equal(radius[vis], ref.radii[0][vis])
    assert torch.allclose(m2d[vis], ref.means2d[0][vis], rtol=1e-5, atol=1e-3)
    assert torch.allclose(conic[vis], ref.conics[0][vis], rtol=1e-4, atol=1e-6)
    assert torch.allclose(depth, ref.depths[0], rtol=1e-5, atol=1e-5)


def _port_params(p):
    return GaussianParams(*(p[k].clone().requires_grad_(True) for k in gs3d.LEAVES))


def test_image_and_gradients(scene):
    p = scene.first
    i, view, K, c2w = _cam(scene, 1)
    gt = scene.gt(i)
    bg = torch.zeros(3)
    leaf = _port_params(p)
    out = render_one_cam(leaf, torch.ones(p["xyz"].shape[0], dtype=torch.bool), view, K,
                         c2w[:3, 3], 3, 96, 64, bg)
    loss = photometric_loss(out.image, gt)
    loss.backward()

    grads = {k: torch.zeros_like(p[k]) for k in gs3d.LEAVES}
    ref_loss, _ = gs3d.camera_step(p, grads, view, K, c2w[:3, 3], gt, bg, 96, 64,
                                   torch.float32)
    assert ref_loss == pytest.approx(float(loss.detach()), rel=1e-4)
    for k, g in zip(gs3d.LEAVES, (leaf.xyz, leaf.opacity, leaf.log_scale, leaf.quat, leaf.sh)):
        scale = float(g.grad.abs().max())
        assert scale > 0
        assert float((grads[k] - g.grad).abs().max()) <= 2e-4 * scale, k

    with torch.no_grad():
        m2d, conic, depth, radius = gs3d.project(p["xyz"], p["quat"], p["log_scale"], view, K,
                                                 96, 64)
        table = torch.cat([m2d, conic, torch.sigmoid(p["opacity"])[:, None],
                           gs3d.sh_colour(p["xyz"], p["sh"], c2w[:3, 3])], 1)
        ids, starts, counts = gs3d.bin_tiles(table, radius, depth, 96, 64)
        img, _ = gs3d.render(table, ids, starts, counts, bg, 96, 64)
    assert int(counts.sum()) == out.n_isects
    assert torch.allclose(img, out.image.detach(), atol=2e-5)


@pytest.mark.parametrize("cell", sorted(small.CELLS))
def test_readings_of_a_small_run(cell):
    cfg, trf = small.cell(cell)
    r = harness.run_cell(cell, 99, 0.5, False, "cpu", config=cfg, traffic=trf)
    for k, c in r["checks"].items():
        assert c["value"] < 1e-4, (k, c)
