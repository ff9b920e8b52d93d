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

On a (data x gauss) mesh (`parallel/mesh.py`) a rank holds C/n_gauss rows
and its ids are local. Its filter samples the rows whose global id is a
multiple of the stride, so the gauss ranks' Hamming matrices and visible
counts sum to the whole scene's (`order_inputs`). The micro step and the
eval render project and shade the rank's compact set; the gauss group's
rows are gathered into one table (`parallel/shard.gather_table`, whose
backward returns the rank's own slice) and rasterized, so each rank gets
the gradients of its own compact rows (the counterpart of the JAX
package's `micro_step_visible_batch`, one camera a rank).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, NamedTuple

import torch
import torch.distributed as dist

from clm_gs_tpu_torch.models.gaussians import GaussianParams
from clm_gs_tpu_torch.ops.projection import _project_one_cam, covar_cols
from clm_gs_tpu_torch.parallel.shard import gather_table, rasterize_table, table_rows
from clm_gs_tpu_torch.strategies.base import (photometric_loss, rasterize_inputs,
                                              render_one_cam)
from clm_gs_tpu_torch.utils.timer import OFF

GPU_FIELDS = ("xyz", "opacity", "log_scale", "quat")
# the camera-order TSP samples every SAMPLE_STRIDE-th row
SAMPLE_STRIDE = 32
# rows a chunk of `calculate_filters` (a multiple of SAMPLE_STRIDE): one
# camera's projection temporaries of a chunk and the chunk's (B, rows)
# visibility live at once (2.6 GB of the card at 2^22 rows; an H100,
# BigCity-25M); fewer rows add launches, as the host queues each op of each
# camera
FILTER_CHUNK_ROWS = 1 << 21


class Filters(NamedTuple):
    ids: List[torch.Tensor]  # per camera: ascending int32 visible ids
    counts: torch.Tensor  # (B,) int64 on the host
    sample: torch.Tensor  # (B, ceil(C / stride)) bool: TSP distance sample


@torch.no_grad()
def calculate_filters(xyz, quat, log_scale, alive, viewmats, Ks, width: int,
                      height: int, radius_clip: float,
                      sample_stride: int = SAMPLE_STRIDE, sample_phase: int = 0,
                      chunk_rows: int = FILTER_CHUNK_ROWS, tm=OFF) -> Filters:
    """Each camera's visible rows by projection alone (no SH needed). Rows
    in the outer loop, `chunk_rows` at a time, cameras in the inner: a
    chunk's scales and world covariance are computed once for all cameras,
    only one camera's chunk-sized intermediates live at a time, and the
    chunk's (B, rows) visibility is read back once (the JAX package maps
    over cameras inside one jit, which XLA fuses). Each camera's ids are its
    chunks' ids offset by the chunk start, ascending; the work is
    elementwise per row, so ids, counts and sample equal an unchunked
    pass's. The TSP sample takes rows sample_phase, sample_phase +
    sample_stride, ... (on a gauss shard: the rows whose global id is a
    multiple of the stride); chunks start at multiples of the stride.
    `alive` None: every row. Spans, in the Timer `tm`: a chunk's queued
    projections (`clm.filters.project`) and its read-backs
    (`clm.filters.readback`)."""
    if chunk_rows % sample_stride:
        raise ValueError(f"chunk_rows {chunk_rows} is not a multiple of the sample "
                         f"stride {sample_stride}")
    B, C = viewmats.shape[0], xyz.shape[0]
    ids = [[] for _ in range(B)]
    samples = []
    for lo in range(0, C, chunk_rows):
        hi = min(lo + chunk_rows, C)
        means = xyz[lo:hi]
        live = (torch.ones(hi - lo, dtype=torch.bool, device=xyz.device) if alive is None
                else alive[lo:hi])
        with tm.span("clm.filters.project"):
            covar6 = covar_cols(quat[lo:hi], torch.exp(log_scale[lo:hi]))
            vis = torch.stack([
                _project_one_cam(means, covar6, viewmats[b], Ks[b], width, height,
                                 radius_clip, live)[0] > 0
                for b in range(B)])
        with tm.span("clm.filters.readback"):
            rows = (torch.nonzero(vis)[:, 1].to(torch.int32) + lo).split(
                vis.sum(1).tolist())
        for b in range(B):
            ids[b].append(rows[b])
        # a copy: a view would keep every chunk's (B, rows) visibility alive
        samples.append(vis[:, sample_phase::sample_stride].clone())
    ids = [torch.cat(i) for i in ids]
    counts = torch.tensor([len(i) for i in ids], dtype=torch.int64)
    return Filters(ids, counts, torch.cat(samples, dim=1))


def hamming_distance_matrix(sample) -> torch.Tensor:
    """(B, S) bool visibility samples -> (B, B) int32 Hamming distances for
    the camera-order TSP. The product runs in float32 on the 0/1 samples,
    exact while S < 2^24 (torch has no integer matmul on the card)."""
    s = sample.to(torch.float32)
    inter = s @ s.T
    ones = s.sum(1)
    return (ones[:, None] + ones[None, :] - 2.0 * inter).to(torch.int32)


def order_inputs(F: Filters, mesh=None):
    """(dist (B, B) int32, counts (B,) int64), on the host, for the camera
    order: the Hamming matrix of the filters' sample and the visible counts;
    on a mesh, summed over the gauss group in one all_reduce (the whole
    scene's, as each shard samples its part of the global sample)."""
    d = hamming_distance_matrix(F.sample)
    if mesh is None or mesh.n_gauss == 1:
        return d.cpu(), F.counts
    B = d.shape[0]
    both = torch.cat([d.flatten(), F.counts.to(d.device, torch.int32)])
    dist.all_reduce(both, group=mesh.gauss_group)
    both = both.cpu()
    return both[:B * B].view(B, B), both[B * B:].long()


class MicroOut(NamedTuple):
    loss: torch.Tensor  # () on the device
    grads: GaussianParams  # compact (n, ...) gradients, sh (n, 48)
    probe_grad: torch.Tensor  # (n, 2) screen-space gradients
    radii: torch.Tensor  # (n,)
    n_isects: int


def _compact(params: GaussianParams, ids, shc) -> GaussianParams:
    idx = ids.long()
    return GaussianParams(*(getattr(params, f)[idx] for f in GPU_FIELDS), shc)


def _render(compact: GaussianParams, viewmat, Kmat, campos, sh_degree: int,
            width: int, height: int, background, mesh=None):
    """`render_one_cam` of a compact set, or on a mesh of the gauss group's
    compact sets gathered into one table. Returns (image, this rank's
    means2d and radii, n_isects)."""
    if mesh is None:
        out = render_one_cam(compact, None, viewmat, Kmat, campos, sh_degree, width,
                             height, background)
        return out.image, out.means2d, out.radii, out.n_isects
    means2d, conics, colors, opac, depths, radii = rasterize_inputs(
        compact, None, viewmat, Kmat, campos, sh_degree, width, height)
    with OFF.span("render.rasterize"):
        table, _ = gather_table(mesh, table_rows(means2d, conics, colors, opac, depths,
                                                 radii))
        image, _, n_isects = rasterize_table(table, width, height, background)
    return image, means2d, radii, n_isects


def micro_step_visible(params: GaussianParams, ids, shc, viewmat, Kmat, campos,
                       gt, sh_degree: int, background, width: int, height: int,
                       lambda_dssim: float = 0.2, loss_scale: float = 1.0,
                       mesh=None) -> MicroOut:
    """One camera's forward and backward over its compact visible set: the
    11 card-resident attributes gathered at `ids`, the SH rows `shc`
    (n, 48) of the working set (on a mesh: the rank's, module docstring)."""
    leaf = GaussianParams(*(t.detach().requires_grad_(True)
                            for t in _compact(params, ids, shc).astuple()))
    image, means2d, radii, n_isects = _render(leaf, viewmat, Kmat, campos, sh_degree,
                                              width, height, background, mesh)
    means2d.retain_grad()
    with OFF.span("render.loss"):
        loss = photometric_loss(image, gt, lambda_dssim, loss_scale)
    with OFF.span("render.backward"):
        loss.backward()
    grads = GaussianParams(*(t.grad if t.grad is not None else torch.zeros_like(t)
                             for t in leaf.astuple()))
    probe = means2d.grad
    if probe is None:
        probe = torch.zeros_like(means2d)
    return MicroOut(loss.detach(), grads, probe, radii, n_isects)


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
                   loss_scale: float = 1.0, mesh=None):
    """One clm camera: the micro step, then every accumulation of the batch
    in place (the four attribute gradients, the densification statistics,
    the visibility union and the instance counts: the span
    `clm.accumulate`). Returns (loss, grad_buf + the camera's compact SH
    gradients)."""
    out = micro_step_visible(params, ids, shc, viewmat, Kmat, campos, gt,
                             sh_degree, background, width, height, lambda_dssim,
                             loss_scale, mesh)
    with OFF.span("clm.accumulate"):
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
                 sh_degree: int, background, width: int, height: int, mesh=None):
    """Eval render of one camera from its compact visible set (on a mesh,
    the gauss group's); returns (image, n_isects)."""
    image, _, _, n_isects = _render(_compact(params, ids, shc), viewmat, Kmat, campos,
                                    sh_degree, width, height, background, mesh)
    return image, n_isects
