"""Synthetic COLMAP scene on disk: Gaussians rendered from a ring of cameras,
written as PNG images, COLMAP sparse binaries and a points3D.bin (the port's
own copy of tests/make_synthetic_colmap.py `make_dataset`).

Images are rendered by the port's rasterizer: its kernels for a device
"cuda", its plain versions for "cpu".

    make_dataset(root)             # 120 Gaussians, 10 cameras of 96x64
    make_dataset(root, full=True)  # the bench scene: 1,000,000 Gaussians,
                                   # 32 cameras of 1237x822 on its ring

FULL_TRAIN_ARGS is the training command that chip_smoke.py's phase `cli`
runs on the full scene.

The small scene draws the test helper's Gaussians from the same numpy seed,
cameras and init points (centres plus 0.02 noise). The full scene is
`bench_scene._surface_gaussians` (seed 0) seen by 32 cameras on the bench
scene's circle of radius 6; its points3D.bin holds the exact centres with
their DC colours.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from clm_gs_tpu_torch.data import colmap
from clm_gs_tpu_torch.data.cameras import stack_cameras
from clm_gs_tpu_torch.ops.projection import fully_fused_projection
from clm_gs_tpu_torch.ops.rasterize import rasterize
from clm_gs_tpu_torch.ops.sh import spherical_harmonics
from clm_gs_tpu_torch.utils import bench_scene
from clm_gs_tpu_torch.utils.general import check_device

FULL_CAMERAS = 32
# The training command for the full scene, less -s and -m: 200 iterations
# at bsz 4 with three densification rounds (80, 120, 160), an opacity reset
# at 120, a checkpoint at 100, a PLY at 200, eval at every multiple of 4
# (test_iterations are intervals, as in the reference) and timers on. The
# gradient threshold 5e-7 makes the model outgrow its first capacity
# (1,572,864 for 1M Gaussians) at the first round.
FULL_TRAIN_ARGS = [
    "--no_offload", "--eval", "--llffhold", "8", "--bsz", "4",
    "--iterations", "200", "--densify_from_iter", "40",
    "--densification_interval", "40", "--densify_until_iter", "160",
    "--opacity_reset_interval", "120", "--test_iterations", "4", "200",
    "--save_iterations", "200", "--checkpoint_iterations", "100",
    "--log_interval", "20", "--enable_timer", "--check_gpu_memory",
    "--densify_grad_threshold", "5e-7",
]


def _random_gaussians(n, rng, extent=1.5):
    """tests/utils3d.py random_gaussians: sh is (n, 16, 3)."""
    xyz = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    log_scales = rng.uniform(-3.5, -2.0, (n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    opacity_logits = rng.uniform(-1.0, 3.0, (n,)).astype(np.float32)
    sh = np.zeros((n, 16, 3), np.float32)
    sh[:, 0, :] = rng.uniform(-1.0, 1.0, (n, 3))
    sh[:, 1:, :] = 0.1 * rng.normal(size=(n, 15, 3))
    return xyz, log_scales, quats, opacity_logits, sh


@torch.no_grad()
def _render_images(cams, gaussians, out_dir, names, device):
    """Render each camera's view to a PNG; returns nothing."""
    from PIL import Image

    xyz, log_scales, quats, opacity_logits, sh = (
        torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
        for a in gaussians)
    sh = sh.reshape(len(xyz), 16, 3)
    opac = torch.sigmoid(opacity_logits)
    bg = torch.zeros(3, device=device)
    w, h = cams[0].width, cams[0].height
    cb = stack_cameras(cams, device=device)
    os.makedirs(out_dir, exist_ok=True)
    for i, name in enumerate(names):
        proj = fully_fused_projection(xyz, quats, torch.exp(log_scales),
                                      cb.viewmats[i:i + 1], cb.Ks[i:i + 1], w, h)
        colors = torch.clamp_min(
            spherical_harmonics(3, xyz - cb.camera_centers[i], sh) + 0.5, 0.0)
        img, _, _ = rasterize(proj.means2d[0], proj.conics[0], colors, opac,
                              proj.depths[0], proj.radii[0], w, h, bg)
        arr = (torch.clamp(img, 0, 1) * 255).to(torch.uint8).cpu().numpy()
        Image.fromarray(arr.transpose(1, 2, 0)).save(os.path.join(out_dir, name),
                                                     compress_level=1)


def make_dataset(root, n_points=120, n_cams=10, width=96, height=64, seed=0,
                 full=False, device="cuda"):
    """Write the scene under `root` (images/ and sparse/0/); returns root."""
    device = check_device(device)
    if full:
        rng = np.random.RandomState(0)
        xyz, log_scales, quats, opacity_logits, sh = bench_scene._surface_gaussians(
            bench_scene.N, rng)
        n_cams, width, height, dist = FULL_CAMERAS, bench_scene.W, bench_scene.H, 6.0
    else:
        rng = np.random.RandomState(seed)
        xyz, log_scales, quats, opacity_logits, sh = _random_gaussians(n_points, rng)
        opacity_logits = opacity_logits + 1.0  # brighter, denser Gaussians
        dist = 4.0
    gaussians = (xyz, log_scales, quats, opacity_logits, sh)

    cams = [bench_scene.make_camera(uid=i + 1, width=width, height=height,
                                    dist=dist, angle=2 * np.pi * i / n_cams)
            for i in range(n_cams)]
    names = [f"img_{i:03d}.png" for i in range(n_cams)]
    _render_images(cams, gaussians, os.path.join(root, "images"), names, device)

    sparse = os.path.join(root, "sparse", "0")
    os.makedirs(sparse, exist_ok=True)
    K = cams[0].K
    colmap.write_cameras_binary(os.path.join(sparse, "cameras.bin"), {
        1: colmap.ColmapCamera(1, "PINHOLE", width, height,
                               np.array([K[0, 0], K[1, 1], width / 2, height / 2]))
    })
    colmap.write_images_binary(os.path.join(sparse, "images.bin"), {
        i + 1: colmap.ColmapImage(i + 1, colmap.rotmat2qvec(cam.R.T),
                                  cam.T.astype(np.float64), 1, names[i])
        for i, cam in enumerate(cams)
    })
    dc = np.asarray(sh).reshape(len(xyz), -1)[:, :3]
    if full:
        pts = xyz
    else:  # SfM-like: the true centres plus noise
        pts = xyz + 0.02 * rng.normal(size=xyz.shape).astype(np.float32)
    rgb = (np.clip(dc * 0.28209479 + 0.5, 0, 1) * 255).astype(np.uint8)
    colmap.write_points3d_binary(os.path.join(sparse, "points3D.bin"),
                                 pts.astype(np.float64), rgb)
    return root
