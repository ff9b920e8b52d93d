"""EWA projection of 3D Gaussians to screen space
(clm_gs_tpu/ops/projection.py:45-217).

Elementwise per Gaussian and differentiated by autograd; the reference has no
Pallas kernel for this stage either. covar = R S S^T R^T, cam-space covar =
W covar W^T, cov2d = J covar_cam J^T with the clamped perspective Jacobian,
EPS2D added to the diagonal, conic = inverse(cov2d), radius =
ceil(3 sqrt(lambda_max)). Culled and dead rows get radius 0.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

EPS2D = 0.3
NEAR_PLANE = 0.01
FAR_PLANE = 1e10


class ProjResults(NamedTuple):
    radii: torch.Tensor  # (C, N) float32 (0 = culled)
    means2d: torch.Tensor  # (C, N, 2)
    depths: torch.Tensor  # (C, N)
    conics: torch.Tensor  # (C, N, 3) inverse-covariance upper triangle
    compensations: torch.Tensor  # (C, N)


def quat_scale_to_covar(quats, scales):
    """(N, 4) unnormalized quats and (N, 3) activated scales -> (N, 3, 3)
    covariance R S S^T R^T (the oracle's form; the hot path uses
    covar_cols)."""
    from clm_gs_tpu_torch.utils.general import build_scaling_rotation

    M = build_scaling_rotation(scales, quats)
    return M @ M.transpose(-1, -2)


def _rot_cols(quats):
    """Unnormalized quats -> the 9 rotation-matrix entries as (N,) columns."""
    w, x, y, z = quats[:, 0], quats[:, 1], quats[:, 2], quats[:, 3]
    inv = torch.rsqrt(w * w + x * x + y * y + z * z + 1e-24)
    w, x, y, z = w * inv, x * inv, y * inv, z * inv
    return (
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    )


def covar_cols(quats, scales):
    """Upper-triangle world covariance as six (N,) columns."""
    r = _rot_cols(quats)
    s0 = scales[:, 0] * scales[:, 0]
    s1 = scales[:, 1] * scales[:, 1]
    s2 = scales[:, 2] * scales[:, 2]

    def cv(i, j):
        return (
            r[3 * i] * r[3 * j] * s0
            + r[3 * i + 1] * r[3 * j + 1] * s1
            + r[3 * i + 2] * r[3 * j + 2] * s2
        )

    return cv(0, 0), cv(0, 1), cv(0, 2), cv(1, 1), cv(1, 2), cv(2, 2)


def _project_one_cam(means, covar6, viewmat, K, width, height, radius_clip, alive):
    """Project all N Gaussians into one camera (projection.py:87-174)."""
    Rcw = viewmat[:3, :3]
    tcw = viewmat[:3, 3]
    p_view = torch.stack(
        [
            means[:, 0] * Rcw[i, 0] + means[:, 1] * Rcw[i, 1]
            + means[:, 2] * Rcw[i, 2] + tcw[i]
            for i in range(3)
        ],
        dim=-1,
    )
    z = p_view[:, 2]
    valid = alive & (z > NEAR_PLANE) & (z < FAR_PLANE)
    zs = torch.where(z == 0, torch.full_like(z, 1e-6), z)

    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    tan_fovx = 0.5 * width / fx
    tan_fovy = 0.5 * height / fy
    lim_x_pos = (width - cx) / fx + 0.3 * tan_fovx
    lim_x_neg = cx / fx + 0.3 * tan_fovx
    lim_y_pos = (height - cy) / fy + 0.3 * tan_fovy
    lim_y_neg = cy / fy + 0.3 * tan_fovy

    rz = 1.0 / zs
    rz2 = rz * rz
    tx = zs * torch.clamp(p_view[:, 0] * rz, -lim_x_neg, lim_x_pos)
    ty = zs * torch.clamp(p_view[:, 1] * rz, -lim_y_neg, lim_y_pos)

    w00, w01, w02, w11, w12, w22 = covar6
    Cw = ((w00, w01, w02), (w01, w11, w12), (w02, w12, w22))
    t = [
        [
            Rcw[i, 0] * Cw[0][a] + Rcw[i, 1] * Cw[1][a] + Rcw[i, 2] * Cw[2][a]
            for a in range(3)
        ]
        for i in range(3)
    ]

    def _cam(i, j):
        return t[i][0] * Rcw[j, 0] + t[i][1] * Rcw[j, 1] + t[i][2] * Rcw[j, 2]

    j00 = fx * rz
    j02 = -fx * tx * rz2
    j11 = fy * rz
    j12 = -fy * ty * rz2
    c00, c01, c02 = _cam(0, 0), _cam(0, 1), _cam(0, 2)
    c11, c12, c22 = _cam(1, 1), _cam(1, 2), _cam(2, 2)
    sxx = j00 * (j00 * c00 + j02 * c02) + j02 * (j00 * c02 + j02 * c22)
    sxy = j00 * (j11 * c01 + j12 * c02) + j02 * (j11 * c12 + j12 * c22)
    syy = j11 * (j11 * c11 + j12 * c12) + j12 * (j11 * c12 + j12 * c22)

    det_orig = sxx * syy - sxy * sxy
    sxx = sxx + EPS2D
    syy = syy + EPS2D
    det = sxx * syy - sxy * sxy
    valid = valid & (det > 0)
    det_safe = torch.where(det <= 0, torch.ones_like(det), det)
    compensation = torch.sqrt(torch.clamp_min(det_orig / det_safe, 0.0))

    inv_det = 1.0 / det_safe
    conic = torch.stack([syy * inv_det, -sxy * inv_det, sxx * inv_det], dim=-1)

    b = 0.5 * (sxx + syy)
    v1 = b + torch.sqrt(torch.clamp_min(b * b - det_safe, 0.01))
    radius = torch.ceil(3.0 * torch.sqrt(v1))

    mean2d = torch.stack(
        [fx * p_view[:, 0] * rz + cx, fy * p_view[:, 1] * rz + cy], dim=-1
    )
    inside = (
        (mean2d[:, 0] + radius > 0)
        & (mean2d[:, 0] - radius < width)
        & (mean2d[:, 1] + radius > 0)
        & (mean2d[:, 1] - radius < height)
    )
    valid = valid & (radius > radius_clip) & inside
    radius = torch.where(valid, radius, torch.zeros_like(radius)).detach()
    return radius, mean2d, z, conic, compensation


def fully_fused_projection(
    means, quats, scales, viewmats, Ks, width: int, height: int,
    radius_clip: float = 0.0, alive=None,
) -> ProjResults:
    """Project N Gaussians into C cameras.

    means (N, 3), quats (N, 4) unnormalized, scales (N, 3) activated,
    viewmats (C, 4, 4), Ks (C, 3, 3), alive optional (N,) bool.
    Returns ProjResults with (C, N) leading shape (mask = radii > 0).
    """
    if alive is None:
        alive = torch.ones(means.shape[0], dtype=torch.bool, device=means.device)
    covar6 = covar_cols(quats, scales)
    outs = [
        _project_one_cam(
            means, covar6, viewmats[c], Ks[c], width, height, radius_clip, alive
        )
        for c in range(viewmats.shape[0])
    ]
    return ProjResults(*(torch.stack(x) for x in zip(*outs)))


def visibility_mask(means, quats, scales, viewmats, Ks, width: int, height: int,
                    radius_clip: float = 0.0, alive=None):
    """Per-camera visibility as a dense (C, N) bool mask: radii > 0."""
    proj = fully_fused_projection(means, quats, scales, viewmats, Ks, width, height,
                                  radius_clip, alive)
    return proj.radii > 0
