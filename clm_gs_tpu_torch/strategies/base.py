"""One camera's differentiable render, G cameras' (`render_cams`), and the
photometric loss (clm_gs_tpu/strategies/base.py:29-160).

Projection -> SH colours -> binning + compositing. ``RenderOut.means2d`` is
the screen-space position tensor; a caller that wants its gradient (the
densification statistics) calls ``retain_grad()`` on it before backward, the
torch form of the reference's zero-valued ``probe`` input.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from clm_gs_tpu_torch.models.gaussians import GaussianParams, activated, sh_coeffs
from clm_gs_tpu_torch.ops.projection import fully_fused_projection
from clm_gs_tpu_torch.ops.rasterize import rasterize
from clm_gs_tpu_torch.ops.sh import degree_mask, sh_basis
from clm_gs_tpu_torch.ops.ssim import combined_loss, combined_loss_batch


class RenderOut(NamedTuple):
    image: torch.Tensor  # (3, H, W)
    alpha: torch.Tensor  # (H, W)
    radii: torch.Tensor  # (C,) 0 = culled
    n_isects: int
    means2d: torch.Tensor  # (C, 2)


def rasterize_inputs(params: GaussianParams, alive, viewmat, Kmat, campos,
                     sh_degree: int, width: int, height: int):
    """Projection and SH colour of one camera: the rasterizer's inputs
    (means2d, conics, colors, opacities, depths, radii)."""
    opac, scales = activated(params)
    proj = fully_fused_projection(
        params.xyz, params.quat, scales, viewmat[None], Kmat[None], width,
        height, alive=alive,
    )
    dirs = params.xyz - campos[None, :]
    basis = sh_basis(dirs) * degree_mask(sh_degree, dirs.dtype, dirs.device)
    colors = torch.clamp_min(
        torch.einsum("nk,nkc->nc", basis, sh_coeffs(params)) + 0.5, 0.0
    )
    return (proj.means2d[0], proj.conics[0], colors, opac, proj.depths[0],
            proj.radii[0])


def render_one_cam(params: GaussianParams, alive, viewmat, Kmat, campos,
                   sh_degree: int, width: int, height: int,
                   background) -> RenderOut:
    """Differentiable render of one camera from the full padded buffer."""
    means2d, conics, colors, opac, depths, radii = rasterize_inputs(
        params, alive, viewmat, Kmat, campos, sh_degree, width, height
    )
    image, alpha, n_isects = rasterize(
        means2d, conics, colors, opac, depths, radii, width, height, background
    )
    return RenderOut(image, alpha, radii, n_isects, means2d)


class RenderBatchOut(NamedTuple):
    images: torch.Tensor  # (G, 3, H, W)
    alphas: torch.Tensor  # (G, H, W)
    radii: torch.Tensor  # (G, C) 0 = culled
    n_isects: Tuple[int, ...]  # (G,)
    means2d: torch.Tensor  # (G, C, 2)


def render_cams(params: GaussianParams, alive, viewmats, Kmats, campos, sh_degree: int,
                width: int, height: int, background) -> RenderBatchOut:
    """Differentiable render of G cameras (viewmats (G, 4, 4), Kmats (G, 3,
    3), campos (G, 3)) from the full padded buffer: projection and SH colours
    batched over the G cameras, compositing per camera (the JAX package's
    default branch; its CLMGS_RAST_BATCH gate to `rasterize_batch` is not
    carried). Each camera's math is render_one_cam's."""
    opac, scales = activated(params)
    proj = fully_fused_projection(
        params.xyz, params.quat, scales, viewmats, Kmats, width, height, alive=alive,
    )
    dirs = params.xyz[None, :, :] - campos[:, None, :]  # (G, C, 3)
    basis = sh_basis(dirs) * degree_mask(sh_degree, dirs.dtype, dirs.device)
    colors = torch.clamp_min(
        torch.einsum("gnk,nkc->gnc", basis, sh_coeffs(params)) + 0.5, 0.0
    )
    imgs, als, nis = [], [], []
    for b in range(viewmats.shape[0]):
        img, al, ni = rasterize(
            proj.means2d[b], proj.conics[b], colors[b], opac, proj.depths[b],
            proj.radii[b], width, height, background,
        )
        imgs.append(img)
        als.append(al)
        nis.append(ni)
    return RenderBatchOut(torch.stack(imgs), torch.stack(als), proj.radii, tuple(nis),
                          proj.means2d)


def photometric_loss(image, gt_image, lambda_dssim: float = 0.2,
                     loss_scale: float = 1.0):
    """gt clamped to [0, 1]; loss_scale applies --lr_scale_loss."""
    gt = torch.clamp(gt_image, 0.0, 1.0)
    return combined_loss(image, gt, lambda_dssim) * loss_scale


def photometric_loss_batch(images, gt_images, lambda_dssim: float = 0.2,
                           loss_scale: float = 1.0):
    """(G,) per-camera combined losses in one blurred pass."""
    gts = torch.clamp(gt_images, 0.0, 1.0)
    return combined_loss_batch(images, gts, lambda_dssim) * loss_scale
