"""Adaptive densification: clone, split, prune and opacity reset
(clm_gs_tpu/models/densify.py:46-251).

Mask-based updates of the fixed-capacity rows, as in the reference:

  - grads = xyz_grad_accum / denom, 0 where denom is 0
  - clone: grad >= threshold and max(scale) <= percent_dense * extent
    -> one exact copy
  - split: grad >= threshold and max(scale) > percent_dense * extent
    -> N = 2 samples from N(0, scale) rotated into the world frame, new
       log_scale = log(scale / (0.8 N)); the source is pruned
  - prune: opacity < min_opacity, and with size pruning max(scale) >
    0.1 * extent. New rows that would fail the test are never written.
  - new rows fill the free slots in index order; their optimizer moments
    start at zero; all densification statistics restart at zero.

``count_densify`` says how many rows the next round writes, so the caller can
grow the capacity first. With ``include_sh=False`` (clm_offload, whose SH rows
live on the host) the state's SH is a (1, 48) placeholder that passes through
unchanged, as do its moments: the caller replays the SH row moves on the host
from the returned plan. The split samples come from a ``torch.Generator``
or, for a comparison with the reference, from a given ``noise`` tensor of
standard normals of shape (N, C, 3).
"""

from __future__ import annotations

from dataclasses import replace
from typing import NamedTuple, Optional

import torch

from clm_gs_tpu_torch.models.gaussians import (PARAM_FIELDS as FIELDS,
                                               GaussianParams, GaussianState,
                                               activated)
from clm_gs_tpu_torch.optim import AdamState, zero_opacity_rows, zero_rows
from clm_gs_tpu_torch.utils.general import build_rotation, inverse_sigmoid


class DensifyInfo(NamedTuple):
    n_cloned: int
    n_split: int
    n_pruned: int
    n_alive: int
    overflow: bool  # the new rows did not fit; nothing was written
    # Row-movement plan. dest == capacity means "no row written".
    clone_dest: torch.Tensor  # (C,) int32
    split_dest: torch.Tensor  # (N, C) int32
    written: torch.Tensor  # (C,) bool


def _masks(state: GaussianState, grad_threshold, percent_dense, extent):
    grads = torch.where(
        state.denom > 0,
        state.xyz_grad_accum / torch.clamp_min(state.denom, 1.0),
        torch.zeros_like(state.denom),
    )
    _, scales = activated(state.params)
    smax = scales.max(1).values
    hot = state.alive & (grads >= grad_threshold)
    clone_mask = hot & (smax <= percent_dense * extent)
    split_mask = hot & (smax > percent_dense * extent)
    return clone_mask, split_mask, smax


@torch.no_grad()
def count_densify(state: GaussianState, grad_threshold, percent_dense, extent) -> int:
    """Number of new rows the next densify would write (clone + 2 * split)."""
    clone_mask, split_mask, _ = _masks(state, grad_threshold, percent_dense, extent)
    return int(clone_mask.sum() + 2 * split_mask.sum())


@torch.no_grad()
def densify_and_prune(
    state: GaussianState,
    opt_state: Optional[AdamState],
    generator: Optional[torch.Generator],
    grad_threshold: float,
    min_opacity: float,
    extent: float,
    percent_dense: float,
    size_prune: bool,
    n_split_samples: int = 2,
    noise: Optional[torch.Tensor] = None,
    include_sh: bool = True,
):
    """One densification round. Returns (state, opt_state, DensifyInfo).

    The split samples are `noise` (N, C, 3) standard normals when given,
    else drawn from `generator` on the state's device."""
    p = state.params
    C = state.capacity
    dev = p.xyz.device
    N = n_split_samples
    clone_mask, split_mask, smax = _masks(state, grad_threshold, percent_dense, extent)
    opac = torch.sigmoid(p.opacity)
    scales = torch.exp(p.log_scale)

    # prune the existing set: sources of splits die, as do faint or huge rows
    base_prune = (opac < min_opacity) | (size_prune & (smax > 0.1 * extent))
    prune_existing = state.alive & (base_prune | split_mask)

    # new rows that would fail the prune test are never written
    clone_survives = ~base_prune
    split_survives = ~((opac < min_opacity)
                       | (size_prune & (smax / (0.8 * N) > 0.1 * extent)))
    n_requests = (clone_mask & clone_survives).int() + N * (
        split_mask & split_survives).int()
    rank = torch.cumsum(n_requests, 0) - n_requests  # exclusive slot rank
    n_new = int(n_requests.sum())

    alive_after_prune = state.alive & ~prune_existing
    n_free = C - int(alive_after_prune.sum())
    overflow = n_new > n_free

    # k-th free slot in index order: free slots sort first, stably
    free_slots = torch.argsort(alive_after_prune.int(), stable=True)

    if noise is None:
        noise = torch.randn((N, C, 3), generator=generator, device=dev)
    rots = build_rotation(p.quat)  # (C, 3, 3)
    split_xyz = torch.einsum("cij,ncj->nci", rots, noise * scales[None]) + p.xyz[None]
    split_log_scale = torch.log(torch.clamp_min(scales / (0.8 * N), 1e-30))

    new = dict(zip(FIELDS, (t.clone() for t in p.astuple())))
    written = torch.zeros(C, dtype=torch.bool, device=dev)

    def scatter_rows(src_mask, k_offset, xyz, log_scale):
        """One generated row per masked source into its free slot. Returns
        each source's destination, C where it writes none."""
        k = torch.clamp_max(rank + k_offset, C - 1)
        dest = torch.where(src_mask, free_slots[k], torch.full_like(k, C))
        src = torch.nonzero(src_mask).flatten()
        for f, rows in zip(FIELDS, (xyz, p.opacity, log_scale, p.quat, p.sh)):
            if f != "sh" or include_sh:
                new[f][dest[src]] = rows[src]
        written[dest[src]] = True
        return dest.int()

    cm = clone_mask & clone_survives & (not overflow)
    clone_dest = scatter_rows(cm, 0, p.xyz, p.log_scale)
    sm = split_mask & split_survives & (not overflow)
    split_dests = [scatter_rows(sm, r, split_xyz[r], split_log_scale)
                   for r in range(N)]

    alive_new = alive_after_prune | written
    n_alive = int(alive_new.sum())
    if opt_state is not None:
        opt_state = zero_rows(opt_state, written)

    # dead rows are zeroed so masked projection sees benign values
    def clear_dead(x):
        if x.shape[0] != C:  # the host-kept SH's placeholder
            return x
        return torch.where(alive_new.reshape((C,) + (1,) * (x.ndim - 1)), x,
                           torch.zeros_like(x))

    new_state = GaussianState(
        params=GaussianParams(*(clear_dead(new[f]) for f in FIELDS)),
        alive=alive_new, n_alive=n_alive,
        xyz_grad_accum=torch.zeros(C, device=dev),
        denom=torch.zeros(C, device=dev),
        max_radii2d=torch.zeros(C, device=dev),
    )
    info = DensifyInfo(
        n_cloned=int(cm.sum()), n_split=int(sm.sum()),
        n_pruned=int(prune_existing.sum()), n_alive=n_alive, overflow=overflow,
        clone_dest=clone_dest, split_dest=torch.stack(split_dests),
        written=written,
    )
    return new_state, opt_state, info


@torch.no_grad()
def reset_opacity(state: GaussianState, opt_state: Optional[AdamState]):
    """opacity <- inverse_sigmoid(min(sigmoid(opacity), 0.01)) on live rows;
    the opacity moments are zeroed there. opt_state may be None (moments kept
    elsewhere)."""
    p = state.params
    new_op = inverse_sigmoid(torch.clamp(torch.sigmoid(p.opacity), 1e-7, 0.01))
    new_op = torch.where(state.alive, new_op, torch.zeros_like(new_op))
    state = replace(state, params=replace(p, opacity=new_op))
    if opt_state is not None:
        opt_state = zero_opacity_rows(opt_state, state.alive)
    return state, opt_state


@torch.no_grad()
def add_densification_stats(state: GaussianState, means2d_grad, visibility,
                            width, height) -> GaussianState:
    """Accumulate screen-space gradient norms: the grad scaled by (W/2, H/2),
    its L2 norm added at visible rows; denom counts the visible rows."""
    scale = torch.tensor([[width * 0.5, height * 0.5]], device=means2d_grad.device)
    norm = torch.linalg.norm(means2d_grad * scale, dim=-1)
    vis = visibility.float()
    return replace(state, xyz_grad_accum=state.xyz_grad_accum + norm * vis,
                   denom=state.denom + vis)
