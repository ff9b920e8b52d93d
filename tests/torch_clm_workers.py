"""Rank processes of tests/test_torch_clm_mesh.py: the port's clm_offload on
a (data x gauss) mesh, each rank a spawned gloo process on the CPU
(`tests/torch_parallel_workers.launch`). Like that module, this one and what
it imports load no JAX; the parent passes numpy inputs.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from clm_gs_tpu_torch import config as tconfig, convert, optim
from clm_gs_tpu_torch.models.gaussians import GaussianParams
from clm_gs_tpu_torch.parallel import mesh as M
from clm_gs_tpu_torch.strategies import clm_offload as clm
from clm_gs_tpu_torch.strategies import offload_common as oc
from tests.torch_parallel_workers import init_gloo

GPU = ("xyz", "opacity", "log_scale", "quat")


def clm_cfg(sparse: bool = False, retention: bool = True, bsz: int = 4):
    """tests/test_strategies.py's clm configuration."""
    cfg = tconfig.Config()
    cfg.aux.clm_offload = True
    cfg.aux.sparse_adam = sparse
    cfg.opt.bsz = bsz
    cfg.opt.lr_scale_mode = "accumu"
    cfg.tpu.retention = retention
    return tconfig.init_config(cfg)


def start(case):
    """(cfg, stripped state, card moments, context) of a case: zero moments,
    or the case's seeded ones (the SH moments on the host)."""
    cfg = clm_cfg(case["sparse_adam"], case.get("retention", True))
    state = convert.state_from_numpy(case["state"], "cpu")
    ctx = clm.make_context(cfg, state, optim.AdamConfig())
    state = clm.strip_device_sh(state)
    opt = optim.init_adam(state.params)
    if case.get("opt") is not None:
        o = case["opt"]
        opt = optim.AdamState(
            *(GaussianParams(*(torch.from_numpy(o[g][f].copy()) for f in GPU),
                             torch.zeros((1, 48))) for g in ("mu", "nu")),
            torch.tensor(float(o["steps"])))
        ctx.adam.exp_avg = torch.from_numpy(o["mu"]["sh"].copy())
        ctx.adam.exp_avg_sq = torch.from_numpy(o["nu"]["sh"].copy())
        ctx.adam.step_count = int(o["steps"])
    return cfg, state, opt, ctx


def run_batches(case, mesh=None):
    """`case["batches"]` clm batches of a case, on `mesh` when given (the
    state, moments and context cut to this rank's shard first). Returns the
    losses of each batch, the last StepOut's counts, the whole state and
    moments (gathered), and this rank's own host rows and moments."""
    cfg, state, opt, ctx = start(case)
    cams = convert.cameras_from_numpy(case["cams"], "cpu")
    gts = torch.from_numpy(case["gts"])
    lrs = {k: torch.tensor(v) for k, v in case["lrs"].items()}
    if mesh is not None:
        opt = M.shard_capacity_tree(opt, mesh, state.capacity)
        state = M.shard_state(state, mesh)
        clm.shard_context(ctx, mesh)
    losses = []
    try:
        for _ in range(case["batches"]):
            state, opt, ctx, out = clm.train_one_batch(
                state, opt, ctx, cams, gts, 3, lrs, optim.AdamConfig(), torch.zeros(3),
                case["cams"]["width"], case["cams"]["height"], cfg)
            losses.append(out.losses.numpy().copy())
    finally:
        ctx.close()
    local = {"sh_host": ctx.sh_host.numpy().copy(),
             "exp_avg": ctx.adam.exp_avg.numpy().copy(),
             "exp_avg_sq": ctx.adam.exp_avg_sq.numpy().copy(),
             "sh_grad_host": ctx.sh_grad_host.numpy().copy(),
             "card_rows": state.params.xyz.shape[0]}
    vis = out.visible_any
    if mesh is not None:
        rows = state.capacity
        state = M.gather_capacity_tree(state, mesh, rows)
        opt = M.gather_capacity_tree(opt, mesh, rows)
        vis = M.gather_capacity_tree(vis, mesh, rows)
    whole = clm.materialize(state, ctx)
    mu = {f: getattr(opt.mu, f).numpy().copy() for f in GPU}
    nu = {f: getattr(opt.nu, f).numpy().copy() for f in GPU}
    extra = clm.checkpoint_extra(ctx)
    mu["sh"], nu["sh"] = extra["clm.exp_avg"], extra["clm.exp_avg_sq"]
    return {"losses": losses, "n_isects": out.n_isects, "max_isects": out.max_isects,
            "visible_any": vis.numpy(), "state": convert.state_to_numpy(whole),
            "mu": mu, "nu": nu, "local": local, "step_count": ctx.adam.step_count,
            "data_sum_bytes": ctx.data_sum_bytes, "n_batches": ctx.n_batches}


def order_inputs(case, mesh):
    """This rank's filters of the case's cameras (its gauss shard, globally
    phased sample) and `offload_common.order_inputs` over the group."""
    state = M.shard_state(convert.state_from_numpy(case["state"], "cpu"), mesh)
    cams = convert.cameras_from_numpy(case["cams"], "cpu")
    p = state.params
    row0 = mesh.gauss_index * state.capacity
    F = oc.calculate_filters(p.xyz, p.quat, p.log_scale, state.alive, cams.viewmats,
                             cams.Ks, case["cams"]["width"], case["cams"]["height"], 0.0,
                             sample_phase=-row0 % oc.SAMPLE_STRIDE)
    d, counts = oc.order_inputs(F, mesh)
    return {"dist": d.numpy(), "counts": counts.numpy(),
            "ids": [(i + row0).numpy() for i in F.ids]}


def clm_meshes(rank, world, port, meshes, cases):
    """Every case on every mesh shape of `meshes`: `run_batches`, and for
    each shape the order inputs of the first case."""
    init_gloo(rank, world, port)
    try:
        out = {}
        for shape in meshes:
            mesh = M.make_mesh(shape, "cpu")
            for name, case in cases.items():
                res = run_batches(case, mesh)
                res.update(mesh=mesh.shape, index=(mesh.data_index, mesh.gauss_index))
                out[shape, name] = res
            out[shape, "order"] = order_inputs(next(iter(cases.values())), mesh)
        return out
    finally:
        dist.destroy_process_group()
