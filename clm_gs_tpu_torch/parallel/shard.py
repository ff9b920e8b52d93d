"""The sharded no_offload step over the (data x gauss) mesh
(clm_gs_tpu/parallel/shard.py:53 make_sharded_train_step).

Each rank holds C/n_gauss rows of every Gaussian buffer and renders its
bsz/n_data cameras of the batch. For each camera:

  1. project and SH-evaluate the rank's rows (`strategies/base.py`
     `rasterize_inputs`);
  2. compact the visible rows (radii > 0) into an (n_vis, 11) table: means2d,
     conic, colour, opacity, depth, radius;
  3. one small all_reduce(MAX) of n_vis over the gauss group; every rank pads
     its table to that count with zero rows (radius 0: culled), so the
     gather below has exact sizes, drops no row and needs no budget (the JAX
     step gathers into a fixed `gather_cap // n_gauss` rows a rank and drops
     the surplus, `shard.py:104`);
  4. all-gather the tables over the gauss group (`GatherRows`), rasterize
     the union through `ops/rasterize.py` (kernels 1, 2 and 4, kernel 3 in
     the backward), take the photometric loss and backward.

Every gauss rank of a data group renders the same camera from the same rows
and so differentiates the same loss. `GatherRows`' backward therefore
returns this rank's own slice of the cotangent and sums nothing: the
gradient of every row is the single-device gradient. (The JAX step takes
`value_and_grad` inside `shard_map`, and the transpose of its tiled
all_gather sums the n_gauss identical cotangents: its gradients and
densification statistics come out n_gauss times too large.
`torch.distributed.nn.functional.all_gather` would do the same.)

After the cameras, the gradients and the two statistics are summed over the
data group in one all_reduce; the largest instance and visible counts are
taken over the world; the losses and instance counts are gathered over the
data group in camera order. The gradients are divided by bsz and the
selective Adam of `optim.py` updates the rank's rows.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist

from clm_gs_tpu_torch.models.gaussians import GaussianParams, GaussianState
from clm_gs_tpu_torch.optim import AdamConfig, AdamState, adam_step
from clm_gs_tpu_torch.ops.rasterize import rasterize
from clm_gs_tpu_torch.parallel.mesh import Mesh, data_slice, gather_rows
from clm_gs_tpu_torch.parallel.multihost import fully_replicated_host_value
from clm_gs_tpu_torch.strategies.base import photometric_loss, rasterize_inputs
from clm_gs_tpu_torch.strategies.no_offload import StepOut

# columns of a compact row: means2d 2, conic 3, colour 3, opacity, depth, radius
ROW_COLS = 11


class GatherRows(torch.autograd.Function):
    """All-gather of (n, k) rows over a group, in rank order. The backward
    returns this rank's slice of the cotangent: every rank of the group
    computes the same loss from the gathered rows, so each holds the whole
    cotangent already."""

    @staticmethod
    def forward(ctx, rows, group, size: int, index: int):
        ctx.n, ctx.index = rows.shape[0], index
        return gather_rows(rows, group, size)

    @staticmethod
    def backward(ctx, grad):
        n = ctx.n
        return grad[ctx.index * n:(ctx.index + 1) * n], None, None, None


def table_rows(means2d, conics, colors, opac, depths, radii) -> torch.Tensor:
    """The (n, ROW_COLS) rows the rasterizer reads; depth and radius carry no
    gradient."""
    return torch.cat([means2d, conics, colors, opac[:, None], depths.detach()[:, None],
                      radii.detach()[:, None]], dim=1)


def gather_table(mesh: Mesh, rows):
    """This rank's (n, ROW_COLS) rows padded with zero rows (radius 0:
    culled) to the gauss group's largest n, then all-gathered in rank order
    (`GatherRows`). Returns (table, the padded count a rank)."""
    n_max = torch.tensor([rows.shape[0]], dtype=torch.int64, device=rows.device)
    dist.all_reduce(n_max, op=dist.ReduceOp.MAX, group=mesh.gauss_group)
    n_max = int(n_max)
    rows = torch.cat([rows, rows.new_zeros(n_max - rows.shape[0], ROW_COLS)])
    return GatherRows.apply(rows, mesh.gauss_group, mesh.n_gauss, mesh.gauss_index), n_max


def rasterize_table(table, width: int, height: int, background):
    """`ops/rasterize.rasterize` of a gathered table: (image, alpha, n_isects)."""
    return rasterize(table[:, 0:2], table[:, 2:5], table[:, 5:8], table[:, 8],
                     table[:, 9], table[:, 10], width, height, background)


def make_sharded_train_step(
    mesh: Mesh, width: int, height: int, sparse_adam: bool = False,
    lambda_dssim: float = 0.2, loss_scale: float = 1.0,
    stop_update_param: bool = False, accumulate_stats: bool = True,
):
    """The step for this mesh and resolution, with `no_offload.train_step`'s
    knobs, so one command line trains alike on any number of cards."""

    def render_loss(leaf, alive, vm, K, campos, gt, sh_degree, background):
        """One camera's loss over the gathered visible rows; returns (loss,
        this rank's means2d, radii, n_isects, n_vis)."""
        means2d, conics, colors, opac, depths, radii = rasterize_inputs(
            leaf, alive, vm, K, campos, sh_degree, width, height)
        means2d.retain_grad()
        idx = torch.nonzero(radii > 0).squeeze(1)
        rows = table_rows(means2d, conics, colors, opac, depths, radii)[idx]
        table, _ = gather_table(mesh, rows)
        image, _, n_isects = rasterize_table(table, width, height, background)
        loss = photometric_loss(image, gt, lambda_dssim, loss_scale)
        return loss, means2d, radii, n_isects, idx.numel()

    def train_step(
        state: GaussianState, opt_state: AdamState, cams, gt_images, sh_degree: int,
        lrs: Dict[str, torch.Tensor], adam_cfg: AdamConfig, background,
    ):
        """One batch over the rank's rows. `cams` and `gt_images` are the
        whole batch, the same on every rank; the rank renders its data slice.
        Returns (state, opt_state, StepOut): the new rows of this rank, the
        whole batch's losses and instance counts, and this rank's rows'
        visibility."""
        params, alive = state.params, state.alive
        bsz = gt_images.shape[0]
        cams, gts = data_slice((cams, gt_images), mesh)
        C = params.capacity
        dev = params.xyz.device
        leaf = GaussianParams(*(t.detach().requires_grad_(True)
                                for t in params.astuple()))
        half_wh = torch.tensor([width * 0.5, height * 0.5], device=dev)
        grad_norm_sum = torch.zeros(C, device=dev)
        vis_count = torch.zeros(C, device=dev)
        losses, n_isects, max_vis = [], [], 0
        for b in range(gts.shape[0]):
            loss, means2d, radii, n_i, n_vis = render_loss(
                leaf, alive, cams.viewmats[b], cams.Ks[b], cams.camtoworlds[b, :3, 3],
                gts[b], sh_degree, background)
            loss.backward()
            losses.append(loss.detach())
            n_isects.append(n_i)
            max_vis = max(max_vis, n_vis)
            visf = (radii > 0).float()
            vis_count += visf
            if accumulate_stats and means2d.grad is not None:
                grad_norm_sum += torch.linalg.norm(means2d.grad * half_wh, dim=-1) * visf

        # camera-parallel: one all_reduce of the gradients and statistics
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in leaf.astuple()]
        widths = [g[0].numel() for g in grads] + [1, 1]
        flat = torch.cat([g.reshape(C, -1) for g in grads]
                         + [grad_norm_sum[:, None], vis_count[:, None]], dim=1)
        dist.all_reduce(flat, group=mesh.data_group)
        parts = torch.split(flat, widths, dim=1)
        grads = GaussianParams(*(part.reshape(g.shape) / bsz
                                 for part, g in zip(parts, grads)))
        grad_norm_sum, vis_count = parts[-2][:, 0], parts[-1][:, 0]
        vis_any = vis_count > 0
        maxes = torch.tensor([max(n_isects), max_vis], dtype=torch.int64, device=dev)
        dist.all_reduce(maxes, op=dist.ReduceOp.MAX)
        mine = torch.stack([torch.stack(losses).double(),
                            torch.tensor(n_isects, dtype=torch.float64, device=dev)], 1)
        every = gather_rows(mine, mesh.data_group, mesh.n_data)
        max_isects, max_shard_vis = fully_replicated_host_value(maxes).tolist()

        if stop_update_param:
            new_params, new_opt = params, opt_state
        else:
            update_mask = (alive & vis_any) if sparse_adam else alive
            new_params, new_opt = adam_step(params, grads, opt_state, lrs, adam_cfg,
                                            update_mask)
        new_state = GaussianState(
            params=new_params, alive=alive, n_alive=state.n_alive,
            xyz_grad_accum=state.xyz_grad_accum + grad_norm_sum,
            denom=state.denom + (vis_count if accumulate_stats else 0.0),
            max_radii2d=state.max_radii2d,
        )
        counts = tuple(int(v) for v in fully_replicated_host_value(every[:, 1]))
        return new_state, new_opt, StepOut(every[:, 0].float(), max_isects, vis_any,
                                           counts, max_shard_vis)

    return train_step
