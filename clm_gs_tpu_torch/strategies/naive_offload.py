"""naive_offload strategy: parameters and Adam moments on the host
(clm_gs_tpu/strategies/naive_offload.py).

The canonical parameters live in host memory as (C, cols) float32 tensors
(pinned when the run is on the card), and every group's Adam moments in a
`HostAdam`; the card holds a copy of the parameters only for the duration
of a batch, an eval or a densification round. Per batch:

  1. one upload (H2D) of all parameters, `materialize`;
  2. the camera loop on that copy, `no_offload.batch_grads` (the gradients
     accumulate on the card);
  3. one download (D2H) of all gradients into a pinned staging buffer;
  4. the host Adam per group, dense or, with --sparse_adam, over the rows
     visible in the batch; the device copy is freed by returning a
     stripped state.

Between batches the only per-Gaussian tensors on the card are `alive` and
the densification statistics. The copies run on the current stream; before
the host reads the gradients it waits for an event recorded after their
download, and before it writes the parameter buffers it waits for the last
upload from them.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Optional

import numpy as np
import torch

from clm_gs_tpu_torch.models.gaussians import (GaussianParams, GaussianState,
                                               host_zeros)
from clm_gs_tpu_torch.optim import AdamConfig
from clm_gs_tpu_torch.strategies import no_offload
from clm_gs_tpu_torch.strategies.no_offload import StepOut
from clm_gs_tpu_torch.utils.native import HostAdam
from clm_gs_tpu_torch.utils.timer import Timer

GROUP_COLS = {"xyz": 3, "opacity": 1, "log_scale": 3, "quat": 4, "sh": 48}


@dataclass
class NaiveContext:
    params_host: Dict[str, torch.Tensor]  # canonical (C, cols) f32
    adams: Dict[str, HostAdam]
    grads_host: Dict[str, torch.Tensor]  # (C, cols) staging of the D2H
    device: torch.device  # where batches run
    uploaded: Optional[torch.cuda.Event] = None  # after the last H2D


def _device_shape(name: str, C: int):
    return (C,) if name == "opacity" else (C, GROUP_COLS[name])


def make_context(cfg, state: GaussianState, adam_cfg: AdamConfig) -> NaiveContext:
    """Host buffers holding `state`'s parameters and zero moments; pinned
    once here and again only on growth."""
    C = state.alive.shape[0]
    device = state.alive.device
    params_host, grads_host, adams = {}, {}, {}
    for n, cols in GROUP_COLS.items():
        params_host[n] = host_zeros(C, cols, device)
        params_host[n].view(_device_shape(n, C)).copy_(getattr(state.params, n))
        grads_host[n] = host_zeros(C, cols, device)
        adams[n] = HostAdam(C, cols, torch.zeros(cols), betas=adam_cfg.betas,
                            eps=adam_cfg.eps)
    return NaiveContext(params_host, adams, grads_host, device)


def host_params(ctx: NaiveContext) -> GaussianParams:
    """The canonical parameters as host views in the device layout."""
    C = ctx.params_host["xyz"].shape[0]
    return GaussianParams(**{n: ctx.params_host[n].view(_device_shape(n, C))
                             for n in GROUP_COLS})


def strip_device_params(state: GaussianState) -> GaussianState:
    """Replace every device parameter with a (1, cols) placeholder: the
    device copy exists only inside a batch, an eval or a densification
    round (naive_offload/engine.py:82-104).

    `state.capacity` reads params.xyz: use alive.shape[0] on a stripped
    state."""
    if _is_stripped(state):
        return state
    dev = state.alive.device
    return replace(state, params=GaussianParams(
        **{n: torch.zeros(_device_shape(n, 1), device=dev) for n in GROUP_COLS}))


def _is_stripped(state: GaussianState) -> bool:
    return state.params.xyz.shape[0] != state.alive.shape[0]


def materialize(state: GaussianState, ctx: NaiveContext) -> GaussianState:
    """The full state, its parameters uploaded from the host copy (a new
    copy on the CPU too, so the host Adam never writes through it)."""
    if not _is_stripped(state):
        return state
    params = GaussianParams(*(t.to(ctx.device, non_blocking=True, copy=True)
                              for t in host_params(ctx).astuple()))
    if ctx.device.type == "cuda":
        ctx.uploaded = torch.cuda.Event()
        ctx.uploaded.record()
    return replace(state, params=params)


def _before_host_write(ctx: NaiveContext):
    """Wait for the last upload from the parameter buffers."""
    if ctx.uploaded is not None:
        ctx.uploaded.synchronize()
        ctx.uploaded = None


def grow_context(ctx: NaiveContext, new_cap: int, cfg) -> NaiveContext:
    """Pad the host buffers and moments with zero rows to `new_cap`."""
    for n, arr in ctx.params_host.items():
        new = host_zeros(new_cap, arr.shape[1], ctx.device)
        new[: arr.shape[0]] = arr
        ctx.params_host[n] = new
        ctx.grads_host[n] = host_zeros(new_cap, arr.shape[1], ctx.device)
        ctx.adams[n].grow(new_cap)
    return ctx


def train_one_batch(
    state, opt_state, ctx: NaiveContext, cams, gt, sh_degree,
    lrs, adam_cfg, background, width, height, cfg, timers=None,
):
    """One batch: upload, the camera loop, the grads' download and the host
    Adam. `lrs` are host tensors (a scalar, or (cols,) for sh). Returns
    (stripped state, opt_state, ctx, StepOut)."""
    tm = timers if timers is not None else Timer(enabled=False)
    bsz = gt.shape[0]
    full = materialize(state, ctx)
    tm.start("naive.grads")
    bg = no_offload.batch_grads(
        full.params, full.alive, cams, gt, sh_degree, background, width, height,
        accumulate_stats=not cfg.opt.disable_auto_densification,
        lambda_dssim=cfg.opt.lambda_dssim, loss_scale=cfg.opt.lr_scale_loss,
    )
    del full
    tm.stop("naive.grads", sync=bg.losses)
    out = StepOut(bg.losses, max(bg.n_isects), bg.visible_any, bg.n_isects)
    if cfg.debug.stop_update_param:  # debug: skip all updates (engine.py:331)
        return strip_device_params(state), opt_state, ctx, out

    tm.start("naive.d2h_adam")
    for n, g in zip(GROUP_COLS, bg.grads.astuple()):
        ctx.grads_host[n].view(g.shape).copy_(g, non_blocking=True)
    mask = (state.alive & bg.visible_any) if cfg.aux.sparse_adam else state.alive
    upd_idx = torch.nonzero(mask).flatten().to(torch.int32)
    if ctx.device.type == "cuda":
        landed = torch.cuda.Event()
        landed.record()
        upd_idx = upd_idx.cpu()
        landed.synchronize()  # the grads are on the host
    _before_host_write(ctx)
    for n, cols in GROUP_COLS.items():
        adam = ctx.adams[n]
        adam.step_count += 1
        lr = lrs[n].to("cpu", torch.float32)
        adam.lr_cols = (lr.contiguous() if lr.ndim == 1
                        else torch.full((cols,), float(lr)))
        adam.sparse_step(ctx.params_host[n], ctx.grads_host[n], upd_idx,
                         grad_scale=1.0 / bsz, step=adam.step_count)
    tm.stop("naive.d2h_adam")

    new_state = GaussianState(
        params=strip_device_params(state).params,
        alive=state.alive, n_alive=state.n_alive,
        xyz_grad_accum=state.xyz_grad_accum + bg.grad_norm_sum,
        denom=state.denom + bg.vis_count,
        max_radii2d=state.max_radii2d,
    )
    return new_state, opt_state, ctx, out


def post_densify(ctx: NaiveContext, state: GaussianState, info) -> NaiveContext:
    """After densification on a materialized state: refresh the host copy
    and zero the moments of the rows it wrote."""
    _before_host_write(ctx)
    written = info.written.cpu()
    for n, p in zip(GROUP_COLS, host_params(ctx).astuple()):
        p.copy_(getattr(state.params, n))
        ctx.adams[n].exp_avg[written] = 0.0
        ctx.adams[n].exp_avg_sq[written] = 0.0
    return ctx


def post_opacity_reset(ctx: NaiveContext, state: GaussianState) -> NaiveContext:
    """After the opacity reset: refresh the host opacity, zero its moments."""
    _before_host_write(ctx)
    host_params(ctx).opacity.copy_(state.params.opacity)
    ctx.adams["opacity"].exp_avg.zero_()
    ctx.adams["opacity"].exp_avg_sq.zero_()
    return ctx


def checkpoint_extra(ctx: NaiveContext) -> dict:
    """The host moments and step counts, for `strategy_extra.npz`."""
    out = {}
    for n in GROUP_COLS:
        out[f"naive.{n}.exp_avg"] = ctx.adams[n].exp_avg.numpy()
        out[f"naive.{n}.exp_avg_sq"] = ctx.adams[n].exp_avg_sq.numpy()
        out[f"naive.{n}.step_count"] = np.asarray(ctx.adams[n].step_count)
    return out


def restore_extra(ctx: NaiveContext, arrays: dict) -> NaiveContext:
    for n in GROUP_COLS:
        for k in ("exp_avg", "exp_avg_sq"):
            setattr(ctx.adams[n], k, torch.from_numpy(
                np.array(arrays[f"naive.{n}.{k}"], np.float32, order="C")))
        ctx.adams[n].step_count = int(arrays[f"naive.{n}.step_count"])
    return ctx


# eval: train.py materializes the parameters once before the eval loop
eval_one_cam = no_offload.eval_one_cam
eval_batch = no_offload.eval_batch
