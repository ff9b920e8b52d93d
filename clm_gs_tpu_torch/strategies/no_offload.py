"""no_offload strategy: everything resident on the card
(clm_gs_tpu/strategies/no_offload.py:29-214).

``train_step`` is the reference's one-camera-at-a-time path (``G = 1``,
no_offload.py:81-126): ``batch_grads`` runs each camera's render -> loss ->
backward, the parameter gradients accumulate in ``.grad``, and after the
loop they are divided by the batch size before (selective) Adam. With
``micro_group=G`` (a keyword; no flag sets it, as in the JAX package) the
loop runs over groups of G cameras instead: one `render_cams` (projection
and SH batched, compositing per camera), the group's losses summed, one
backward. ``eval_one_cam`` and
``eval_batch`` are the eval renders of the training loop (train.py).

Spans (`utils/timer.py` `OFF`): a step is the root `step.batch`; each
camera's or group's render (`strategies/base.py`'s `render.*`),
`render.loss`, `render.backward` and `step.stats` (the densification
statistics); then `step.adam`.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from clm_gs_tpu_torch.models.gaussians import GaussianParams, GaussianState
from clm_gs_tpu_torch.optim import AdamConfig, AdamState, adam_step
from clm_gs_tpu_torch.strategies.base import (photometric_loss, photometric_loss_batch,
                                              render_cams, render_one_cam)
from clm_gs_tpu_torch.utils.timer import OFF


class StepOut(NamedTuple):
    losses: torch.Tensor  # (bsz,)
    max_isects: int
    visible_any: torch.Tensor  # (C,) bool
    n_isects: Tuple[int, ...] = ()  # per camera, as binned (port only)
    # the mesh step (parallel/shard.py): the most visible rows one rank's
    # shard gave one camera
    max_shard_vis: int = 0


class BatchGrads(NamedTuple):
    grads: GaussianParams  # summed over the batch's cameras
    grad_norm_sum: torch.Tensor  # (C,) densification statistics to add
    vis_count: torch.Tensor  # (C,)
    visible_any: torch.Tensor  # (C,) bool
    losses: torch.Tensor  # (bsz,)
    n_isects: Tuple[int, ...]  # per camera, as binned


def group_size(micro_group: int, bsz: int) -> int:
    """The cameras a group of `train_step(micro_group=...)` renders (the JAX
    package's G): micro_group when 0 < G < bsz, bsz when G >= bsz, 1 when
    0, and 1 when G does not divide bsz."""
    G = micro_group if 0 < micro_group < bsz else (bsz if micro_group else 1)
    return G if bsz % G == 0 else 1


def batch_grads(
    params: GaussianParams,
    alive: torch.Tensor,
    cams,
    gt_images,
    sh_degree: int,
    background,
    width: int,
    height: int,
    accumulate_stats: bool = True,
    lambda_dssim: float = 0.2,
    loss_scale: float = 1.0,
    micro_group: int = 0,
) -> BatchGrads:
    """The camera loop of a step without the optimizer: each camera runs
    render -> loss -> backward and the parameter gradients accumulate
    (naive_offload.py:124-170 runs the same loop); with G = `group_size(
    micro_group, B)` above 1, each group of G cameras runs `render_cams`,
    the sum of its losses and one backward."""
    C = params.capacity
    dev = params.xyz.device
    leaf = GaussianParams(
        *(t.detach().requires_grad_(True) for t in params.astuple())
    )
    losses = []
    vis_any = torch.zeros(C, dtype=torch.bool, device=dev)
    grad_norm_sum = torch.zeros(C, device=dev)
    vis_count = torch.zeros(C, device=dev)
    n_isects = []
    half_wh = torch.tensor([width * 0.5, height * 0.5], device=dev)
    bsz = gt_images.shape[0]
    G = group_size(micro_group, bsz)
    for b in range(0, bsz, G):
        if G == 1:
            out = render_one_cam(
                leaf, alive, cams.viewmats[b], cams.Ks[b], cams.camtoworlds[b, :3, 3],
                sh_degree, width, height, background,
            )
            with OFF.span("render.loss"):
                cam_losses = photometric_loss(out.image, gt_images[b], lambda_dssim,
                                              loss_scale)[None]
            n_isects.append(out.n_isects)
        else:
            g = slice(b, b + G)
            out = render_cams(leaf, alive, cams.viewmats[g], cams.Ks[g],
                              cams.camtoworlds[g, :3, 3], sh_degree, width, height,
                              background)
            with OFF.span("render.loss"):
                cam_losses = photometric_loss_batch(out.images, gt_images[g], lambda_dssim,
                                                    loss_scale)
            n_isects.extend(out.n_isects)
        out.means2d.retain_grad()
        # one backward of the group's summed losses: the gradients
        # accumulate over its cameras as over single cameras
        with OFF.span("render.backward"):
            cam_losses.sum().backward()
        losses.extend(cam_losses.detach())
        with OFF.span("step.stats"):
            vis = (out.radii > 0).reshape(-1, C)  # (G, C)
            vis_any |= vis.any(dim=0)
            if accumulate_stats:
                g2d = out.means2d.grad
                if g2d is None:
                    g2d = torch.zeros_like(out.means2d)
                visf = vis.float()
                grad_norm_sum += (torch.linalg.norm(g2d.reshape(-1, C, 2) * half_wh,
                                                    dim=-1) * visf).sum(dim=0)
                vis_count += visf.sum(dim=0)
    grads = GaussianParams(
        *(p.grad if p.grad is not None else torch.zeros_like(p)
          for p in leaf.astuple())
    )
    return BatchGrads(grads, grad_norm_sum, vis_count, vis_any,
                      torch.stack(losses), tuple(n_isects))


def train_step(
    state: GaussianState,
    opt_state: AdamState,
    cams,  # CameraBatch: viewmats (B,4,4), Ks (B,3,3), camtoworlds (B,4,4)
    gt_images,  # (B, 3, H, W) float in [0,1]
    sh_degree: int,
    lrs: Dict[str, torch.Tensor],
    adam_cfg: AdamConfig,
    background,
    width: int,
    height: int,
    sparse_adam: bool = False,
    accumulate_stats: bool = True,
    lambda_dssim: float = 0.2,
    loss_scale: float = 1.0,
    stop_update_param: bool = False,
    micro_group: int = 0,
):
    """One batched iteration (bsz = B cameras), the cameras rendered in
    groups of `group_size(micro_group, B)` (module docstring; one at a time
    by default). Returns (state, opt_state, StepOut)."""
    with OFF.batch_span("step.batch"):
        params = state.params
        alive = state.alive
        bsz = gt_images.shape[0]
        bg = batch_grads(params, alive, cams, gt_images, sh_degree, background,
                         width, height, accumulate_stats, lambda_dssim, loss_scale,
                         micro_group)
        with OFF.span("step.adam"):
            if stop_update_param:
                new_params, new_opt = params, opt_state
            else:
                grads = GaussianParams(*(g / bsz for g in bg.grads.astuple()))
                update_mask = (alive & bg.visible_any) if sparse_adam else alive
                new_params, new_opt = adam_step(
                    params, grads, opt_state, lrs, adam_cfg, update_mask
                )
        with OFF.span("step.stats"):
            new_state = GaussianState(
                params=new_params,
                alive=alive,
                n_alive=state.n_alive,
                xyz_grad_accum=state.xyz_grad_accum + bg.grad_norm_sum,
                denom=state.denom + bg.vis_count,
                max_radii2d=state.max_radii2d,
            )
    return new_state, new_opt, StepOut(bg.losses, max(bg.n_isects),
                                       bg.visible_any, bg.n_isects)


@torch.no_grad()
def eval_one_cam(state: GaussianState, viewmat, Kmat, camtoworld,
                 sh_degree: int, background, width: int, height: int):
    """Render one eval camera; returns (image, n_isects)."""
    out = render_one_cam(
        state.params, state.alive, viewmat, Kmat, camtoworld[:3, 3], sh_degree,
        width, height, background,
    )
    return out.image, out.n_isects


@torch.no_grad()
def eval_batch(state: GaussianState, cb, gts, sh_degree: int, background,
               width: int, height: int):
    """Render a batch of eval cameras; returns (l1s (E,), psnrs (E,)) as
    tensors, read by the caller once for the whole batch. PSNR is of the
    clamped image, with the mse floored at 1e-12."""
    l1s, psnrs = [], []
    for b in range(cb.viewmats.shape[0]):
        out = render_one_cam(
            state.params, state.alive, cb.viewmats[b], cb.Ks[b],
            cb.camtoworlds[b, :3, 3], sh_degree, width, height, background,
        )
        l1s.append(torch.mean(torch.abs(out.image - gts[b])))
        mse = torch.mean((torch.clamp(out.image, 0.0, 1.0) - gts[b]) ** 2)
        psnrs.append(-10.0 * torch.log10(torch.clamp_min(mse, 1e-12)))
    return torch.stack(l1s), torch.stack(psnrs)
