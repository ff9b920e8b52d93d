"""Real spherical harmonics, degrees 0..3 (clm_gs_tpu/ops/sh.py:54-118).

Coefficients per Gaussian are (16, 3) = [DC, 15 rest]; the direction is
gaussian centre minus camera centre, normalized here; the active degree masks
basis entries >= (deg+1)^2. The caller adds 0.5 and clamps at 0.
"""

from __future__ import annotations

import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)


def rgb_to_sh(rgb):
    """RGB in [0, 1] -> DC coefficient."""
    return (rgb - 0.5) / C0


def sh_to_rgb(sh):
    return sh * C0 + 0.5


def sh_basis(dirs):
    """(..., 3) unnormalized directions -> (..., 16) SH basis values."""
    d = dirs / (torch.linalg.norm(dirs, dim=-1, keepdim=True) + 1e-12)
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    one = torch.ones_like(x)
    return torch.stack(
        [
            C0 * one,
            -C1 * y,
            C1 * z,
            -C1 * x,
            C2[0] * xy,
            C2[1] * yz,
            C2[2] * (2.0 * zz - xx - yy),
            C2[3] * xz,
            C2[4] * (xx - yy),
            C3[0] * y * (3.0 * xx - yy),
            C3[1] * xy * z,
            C3[2] * y * (4.0 * zz - xx - yy),
            C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            C3[4] * x * (4.0 * zz - xx - yy),
            C3[5] * z * (xx - yy),
            C3[6] * x * (xx - 3.0 * yy),
        ],
        dim=-1,
    )


def degree_mask(active_degree: int, dtype=torch.float32, device=None):
    """(16,) mask of basis entries enabled at `active_degree` (0..3)."""
    idx = torch.arange(16, device=device)
    return (idx < (int(active_degree) + 1) ** 2).to(dtype)


def spherical_harmonics(active_degree: int, dirs, coeffs):
    """dirs (N, 3), coeffs (N, 16, 3) -> (N, 3) raw SH colours."""
    basis = sh_basis(dirs) * degree_mask(active_degree, dirs.dtype, dirs.device)
    return torch.einsum("nk,nkc->nc", basis, coeffs)


def spherical_harmonics_vjp_coeffs(active_degree: int, dirs, v_colors):
    """The hand-derived d(colour)/d(coeffs) contraction: the masked basis of
    `dirs` (N, 3) times the colour gradients `v_colors` (N, 3), an outer
    product per row -> (N, 16, 3)."""
    basis = sh_basis(dirs) * degree_mask(active_degree, dirs.dtype, dirs.device)
    return basis[..., None] * v_colors[..., None, :]


def sh_color_flat(basis, sh_flat):
    """A masked (N, 16) basis contracted with the flat (N, 48) table:
    color_c = sum_k basis_k * sh[:, 3k + c]."""
    return torch.stack([torch.sum(basis * sh_flat[:, c::3], dim=-1) for c in range(3)],
                       dim=-1)


def eval_color(active_degree: int, means, campos, coeffs):
    """The colour path: dirs -> SH -> +0.5 -> clamp_min(0)."""
    rgb = spherical_harmonics(active_degree, means - campos[None, :], coeffs)
    return torch.clamp_min(rgb + 0.5, 0.0)
