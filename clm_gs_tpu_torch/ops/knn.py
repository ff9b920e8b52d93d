"""Mean squared distance to the k nearest neighbours, for the initial scales
(clm_gs_tpu/ops/knn.py:20-80).

The Morton-window approximation of the reference: points are sorted along a
3D Z-curve (10 bits an axis) and each takes its k nearest among the
2*WINDOW points next to it in curve order. Codes are computed in int64 and
sorted stably, so tied codes keep their input order as in the reference.
Plain torch: it runs once, when a scene is initialised.
"""

from __future__ import annotations

import torch

WINDOW = 32


def _morton_interleave(x, y, z):
    """Interleave 3 x 10-bit ints (int64 tensors) into a 30-bit Morton code."""

    def spread(v):
        v = v & 0x3FF
        v = (v | (v << 16)) & 0x30000FF
        v = (v | (v << 8)) & 0x300F00F
        v = (v | (v << 4)) & 0x30C30C3
        v = (v | (v << 2)) & 0x9249249
        return v

    return spread(x) | (spread(y) << 1) | (spread(z) << 2)


@torch.no_grad()
def knn_mean_sq_dist(points, k: int = 3, window: int = WINDOW):
    """(N, 3) float32 points -> (N,) mean squared distance to the k nearest
    neighbours (approximate, Morton window), clamped below at 1e-7. Points
    with fewer than k neighbours in the window average the ones they have."""
    n = points.shape[0]
    dev = points.device
    lo = points.min(0).values
    hi = points.max(0).values
    q = ((points - lo) / torch.clamp_min(hi - lo, 1e-9) * 1023.0).to(torch.int64)
    code = _morton_interleave(q[:, 0], q[:, 1], q[:, 2])
    order = torch.argsort(code, stable=True)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(n, device=dev)
    p = points[order]

    idx = torch.arange(n, device=dev)
    inf = torch.tensor(float("inf"), device=dev)
    d2s = []
    for s in range(1, window + 1):
        fwd = torch.sum((p - torch.roll(p, -s, 0)) ** 2, dim=1)
        fwd = torch.where(idx < n - s, fwd, inf)
        bwd = torch.where(idx >= s, torch.roll(fwd, s, 0), inf)
        d2s += [fwd, bwd]
    d2 = torch.stack(d2s, 1)  # (N, 2*window)
    nearest = torch.topk(d2, min(k, d2.shape[1]), dim=1, largest=False).values
    finite = torch.isfinite(nearest)
    n_finite = torch.clamp_min(finite.sum(1), 1)
    mean = torch.where(finite, nearest, torch.zeros_like(nearest)).sum(1) / n_finite
    return torch.clamp_min(mean[inv], 1e-7)


@torch.no_grad()
def knn_mean_sq_dist_exact(points, k: int = 3):
    """O(N^2) exact version for tests and tiny point clouds."""
    d2 = torch.sum((points[:, None, :] - points[None, :, :]) ** 2, dim=-1)
    d2.fill_diagonal_(float("inf"))
    nearest = torch.topk(d2, k, dim=1, largest=False).values
    return torch.clamp_min(nearest.mean(1), 1e-7)
