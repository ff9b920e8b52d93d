"""Visibility filters and the compact-set camera step of clm_offload
(clm_gs_tpu/strategies/offload_common.py).

Per camera, the Gaussians it sees (radii > 0 on the card-resident
attributes alone) form an ascending int32 id list at its true length; the
differentiable step gathers those rows into compact leaves, runs the
render -> loss -> backward of `strategies/base.py` on them, and adds the
compact gradients and densification statistics back into (C, ...)
accumulators with `index_add_`. The ids are unique, so each row receives
exactly one addition: the torch form of the JAX package's inverse-map
gather. The JAX package pads every list to a fixed `v_cap` with the id C;
the port has no padding, so every compact row is valid.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, NamedTuple

import torch

from clm_gs_tpu_torch.models.gaussians import GaussianParams
from clm_gs_tpu_torch.ops.projection import fully_fused_projection
from clm_gs_tpu_torch.strategies.base import photometric_loss, render_one_cam

GPU_FIELDS = ("xyz", "opacity", "log_scale", "quat")


class Filters(NamedTuple):
    ids: List[torch.Tensor]  # per camera: ascending int32 visible ids
    counts: torch.Tensor  # (B,) int64 on the host
    sample: torch.Tensor  # (B, ceil(C / stride)) bool: TSP distance sample


@torch.no_grad()
def calculate_filters(xyz, quat, log_scale, alive, viewmats, Ks, width: int,
                      height: int, radius_clip: float,
                      sample_stride: int = 32) -> Filters:
    """Each camera's visible rows by projection alone (no SH needed), one
    camera at a time so that only one camera's (C,) intermediates live."""
    scales = torch.exp(log_scale)
    ids, samples = [], []
    for b in range(viewmats.shape[0]):
        proj = fully_fused_projection(xyz, quat, scales, viewmats[b:b + 1],
                                      Ks[b:b + 1], width, height,
                                      radius_clip=radius_clip, alive=alive)
        vis = proj.radii[0] > 0
        ids.append(torch.nonzero(vis).flatten().to(torch.int32))
        samples.append(vis[::sample_stride])
    counts = torch.tensor([len(i) for i in ids], dtype=torch.int64)
    return Filters(ids, counts, torch.stack(samples))


def hamming_distance_matrix(sample) -> torch.Tensor:
    """(B, S) bool visibility samples -> (B, B) int32 Hamming distances for
    the camera-order TSP. The product runs in float32 on the 0/1 samples,
    exact while S < 2^24 (torch has no integer matmul on the card)."""
    s = sample.to(torch.float32)
    inter = s @ s.T
    ones = s.sum(1)
    return (ones[:, None] + ones[None, :] - 2.0 * inter).to(torch.int32)


class MicroOut(NamedTuple):
    loss: torch.Tensor  # () on the device
    grads: GaussianParams  # compact (n, ...) gradients, sh (n, 48)
    probe_grad: torch.Tensor  # (n, 2) screen-space gradients
    radii: torch.Tensor  # (n,)
    n_isects: int


def _compact(params: GaussianParams, ids, shc) -> GaussianParams:
    idx = ids.long()
    return GaussianParams(*(getattr(params, f)[idx] for f in GPU_FIELDS), shc)


def micro_step_visible(params: GaussianParams, ids, shc, viewmat, Kmat, campos,
                       gt, sh_degree: int, background, width: int, height: int,
                       lambda_dssim: float = 0.2,
                       loss_scale: float = 1.0) -> MicroOut:
    """One camera's forward and backward over its compact visible set: the
    11 card-resident attributes gathered at `ids`, the SH rows `shc`
    (n, 48) of the working set."""
    leaf = GaussianParams(*(t.detach().requires_grad_(True)
                            for t in _compact(params, ids, shc).astuple()))
    out = render_one_cam(leaf, None, viewmat, Kmat, campos, sh_degree, width,
                         height, background)
    out.means2d.retain_grad()
    loss = photometric_loss(out.image, gt, lambda_dssim, loss_scale)
    loss.backward()
    grads = GaussianParams(*(t.grad if t.grad is not None else torch.zeros_like(t)
                             for t in leaf.astuple()))
    probe = out.means2d.grad
    if probe is None:
        probe = torch.zeros_like(out.means2d)
    return MicroOut(loss.detach(), grads, probe, out.radii, out.n_isects)


@dataclass
class ClmAcc:
    """A batch's (C, ...) accumulators over its cameras."""

    g_xyz: torch.Tensor  # (C, 3)
    g_opacity: torch.Tensor  # (C,)
    g_log_scale: torch.Tensor  # (C, 3)
    g_quat: torch.Tensor  # (C, 4)
    accum: torch.Tensor  # (C,) densification statistic numerator
    denom: torch.Tensor  # (C,) its denominator
    vis_any: torch.Tensor  # (C,) bool
    n_isects: List[int] = field(default_factory=list)


def make_clm_acc(params: GaussianParams) -> ClmAcc:
    C = params.xyz.shape[0]
    z = lambda: torch.zeros(C, device=params.xyz.device)  # noqa: E731
    return ClmAcc(
        *(torch.zeros_like(getattr(params, f)) for f in GPU_FIELDS),
        accum=z(), denom=z(),
        vis_any=torch.zeros(C, dtype=torch.bool, device=params.xyz.device),
    )


@torch.no_grad()
def scatter_stats(xyz_grad_accum, denom, ids, probe_grad, radii, width: int,
                  height: int):
    """Add one camera's densification statistics at its compact rows, in
    place: the screen-space gradient scaled by (W/2, H/2), its L2 norm where
    radii > 0, and the visible count. Returns the two accumulators."""
    half = torch.tensor([[width * 0.5, height * 0.5]], device=probe_grad.device)
    vis = (radii > 0).to(torch.float32)
    norm = torch.linalg.norm(probe_grad * half, dim=-1)
    idx = ids.long()
    xyz_grad_accum.index_add_(0, idx, norm * vis)
    denom.index_add_(0, idx, vis)
    return xyz_grad_accum, denom


def clm_fused_step(params: GaussianParams, shc, grad_buf, ids, viewmat, Kmat,
                   campos, gt, acc: ClmAcc, sh_degree: int, background,
                   width: int, height: int, lambda_dssim: float = 0.2,
                   loss_scale: float = 1.0):
    """One clm camera: the micro step, then every accumulation of the batch
    in place (the four attribute gradients, the densification statistics,
    the visibility union and the instance counts). Returns (loss,
    grad_buf + the camera's compact SH gradients)."""
    out = micro_step_visible(params, ids, shc, viewmat, Kmat, campos, gt,
                             sh_degree, background, width, height, lambda_dssim,
                             loss_scale)
    idx = ids.long()
    for f in GPU_FIELDS:
        getattr(acc, "g_" + f).index_add_(0, idx, getattr(out.grads, f))
    scatter_stats(acc.accum, acc.denom, ids, out.probe_grad, out.radii, width,
                  height)
    acc.vis_any[idx] = True
    acc.n_isects.append(out.n_isects)
    return out.loss, grad_buf + out.grads.sh


@torch.no_grad()
def eval_visible(params: GaussianParams, ids, shc, viewmat, Kmat, campos,
                 sh_degree: int, background, width: int, height: int):
    """Eval render of one camera from its compact visible set; returns
    (image, n_isects)."""
    out = render_one_cam(_compact(params, ids, shc), None, viewmat, Kmat, campos,
                         sh_degree, width, height, background)
    return out.image, out.n_isects
