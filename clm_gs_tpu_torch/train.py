"""Training CLI (clm_gs_tpu/train.py).

    python -m clm_gs_tpu_torch.train -s <scene> -m <out> [--clm_offload] [flags]
    python -m clm_gs_tpu_torch.train -s <scene> -m <out> --no_offload [flags]
    python -m clm_gs_tpu_torch.train -s <scene> -m <out> --naive_offload [flags]

The host-side loop of the JAX package with its flags and `python.log`
grammar: LR schedules, the SH-degree ramp, eval, densification with capacity
growth, opacity reset, PLY saves, checkpoints and resume. The device work is
one of three strategies: `strategies/no_offload.train_step`;
`strategies/naive_offload.train_one_batch`, with the parameters and moments
on the host (the state is then stripped between batches and materialized
for eval, densification, saves and checkpoints); or, the default,
`strategies/clm_offload.train_one_batch`, with the SH rows and their moments
on the host (the state carries a (1, 48) SH placeholder; densification
replays its row moves on the host, PLY saves read the host rows, each eval
camera gathers its visible rows, and the worker thread of the host Adam is
shut down when the run ends; with --pinned_host the card gathers the rows
out of the pinned host buffer itself and adds their gradients into the
pinned gradient buffer, and under the other strategies the flag changes
nothing). The port sizes its instance buffers to each
camera's true count, so the JAX package's `isect_cap`/`vis_cap`/`gather_cap`
adaptation has no counterpart here.

On several cards, one process each (`parallel/multihost.py`: torchrun or the
--dist_* flags), --no_offload and --clm_offload train on the (data x gauss)
mesh of --mesh_shape, each rank holding C/n_gauss rows of the state and
moments: no_offload through `parallel/shard.py`'s step, clm_offload through
its own batch on a context cut to the rank's gauss shard (its host SH rows
and moments too; `clm_offload.shard_context`), with n_data camera chains
where the data axis divides bsz. Densification, PLY saves and checkpoints
gather the whole state (and clm's host rows) onto every rank, and rank 0
alone writes the run's files; eval renders on the whole state on rank 0,
or under clm on every rank through the mesh, its SH rows never leaving
their rank. Checkpoints keep the single-device layout. As in the JAX
package, --naive_offload, or under no_offload a data axis that does not
divide bsz, runs the single-device step on every rank (and says so); under
clm such a data axis keeps the gauss sharding and runs one chain, the whole
tour, on every data rank.

`training` and `main` run on the card unless called with device="cpu".
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import replace
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from clm_gs_tpu_torch.config import Config, parse_config, save_config
from clm_gs_tpu_torch.data.cameras import CameraBatch, stack_cameras
from clm_gs_tpu_torch.data.dataset import iterate_eval, load_raw_image
from clm_gs_tpu_torch.models import densify as Dn
from clm_gs_tpu_torch.models import gaussians as G
from clm_gs_tpu_torch.optim import (AdamConfig, AdamState, init_adam,
                                    lr_batch_scale, sh_column_lr)
from clm_gs_tpu_torch.parallel import mesh as M
from clm_gs_tpu_torch.parallel.multihost import (is_rank0, maybe_initialize,
                                                 rank0_first)
from clm_gs_tpu_torch.parallel.shard import make_sharded_train_step
from clm_gs_tpu_torch.scene import Scene
from clm_gs_tpu_torch.strategies import clm_offload, naive_offload, no_offload
from clm_gs_tpu_torch.utils.checkpoint import (latest_checkpoint,
                                               load_checkpoint, save_checkpoint)
from clm_gs_tpu_torch.utils.general import (STAGES, check_device,
                                            check_update_at_this_iter,
                                            device_peak_bytes, get_expon_lr_func,
                                            memory_report, next_capacity,
                                            psnr as psnr_fn, rss_bytes)
from clm_gs_tpu_torch.utils.logger import NullLogger, RunLogger
from clm_gs_tpu_torch.utils.timer import End2endTimer, Timer

STRATEGIES = {"no_offload": no_offload, "naive_offload": naive_offload,
              "clm_offload": clm_offload}


def _grow_opt(opt: Optional[AdamState], new_cap: int) -> Optional[AdamState]:
    """Moments padded with zero rows to `new_cap`: new buffers, mu and nu
    distinct. None (moments kept by the strategy) stays None; the JAX
    package's training loop dereferences it there (train.py:517 -> :65). The
    (1, 48) SH placeholder of clm_offload stays (1, 48); the JAX package pads
    it by the added rows (train.py:59-66)."""
    if opt is None:
        return None
    C = opt.mu.xyz.shape[0]

    def pad(x):
        if x.shape[0] != C:
            return x
        return torch.cat([x, x.new_zeros((new_cap - C,) + x.shape[1:])])

    return AdamState(
        mu=G.GaussianParams(*(pad(a) for a in opt.mu.astuple())),
        nu=G.GaussianParams(*(pad(a) for a in opt.nu.astuple())),
        steps=opt.steps,
    )


def _device_gb(device) -> float:
    if device.type != "cuda":
        return 0.0
    return device_peak_bytes() / 2**30


def _host_gb() -> float:
    """The process's resident set in GiB, read from /proc (psutil's rss)."""
    return rss_bytes() / 2**30


def training(cfg: Config, device="cuda"):
    """Train per `cfg`; returns the final (state, opt_state). Under
    naive_offload the state's parameters are uploaded from the host copy and
    opt_state is None (the moments were on the host); under clm_offload the
    state's SH field is the (C, 48) host buffer itself (`materialize_host`:
    the card never holds the SH rows) and opt_state's SH moments are the
    (1, 48) placeholder; on a mesh, the whole state and moments on every
    rank."""
    device = check_device(device)
    with contextlib.ExitStack() as closing:
        return _training(cfg, device, closing)


def _training(cfg: Config, device, closing: contextlib.ExitStack):
    t_setup = time.time()
    # under a process group rank 0 alone writes the run's files
    writer = is_rank0()
    os.makedirs(cfg.model.model_path, exist_ok=True)
    if writer:
        logger = RunLogger(cfg.model.model_path,
                           append=bool(cfg.aux.auto_start_checkpoint),
                           quiet=cfg.aux.quiet)
        save_config(cfg, os.path.join(cfg.model.model_path, "args.json"))
    else:
        logger = NullLogger()
    closing.callback(logger.close)
    logger.write(f"config: {cfg}\n")

    strategy_name = cfg.strategy
    strategy = STRATEGIES[strategy_name]
    naive = strategy_name == "naive_offload"
    clm = strategy_name == "clm_offload"
    world = dist.get_world_size() if dist.is_initialized() else 1
    # the decoded image cache is written by rank 0 and then read by all
    with rank0_first():
        scene = Scene(cfg, logger, device=device, writer=writer)
    # the loop owns the state; the scene holds it only while saving
    state, scene.gaussians = scene.gaussians, None
    # naive_offload keeps every moment on the host (HostAdam)
    opt_state = None if naive else init_adam(state.params)
    generator = torch.Generator(device=device).manual_seed(cfg.debug.seed)
    start_iter = 1

    ckpt = cfg.aux.start_checkpoint or (
        latest_checkpoint(cfg.model.model_path)
        if cfg.aux.auto_start_checkpoint else None)
    if ckpt:
        state, opt_state, generator, start_iter = load_checkpoint(ckpt, device)
        logger.write(f"Resumed from {ckpt} at iteration {start_iter}\n")
        if cfg.debug.drop_duplicate_gaussians_coeff != 1.0:
            # resize on resume; the optimizer restarts cold
            if state.params.sh.shape[0] != state.capacity:
                # a clm checkpoint: its SH rows are in strategy_extra.npz;
                # the host buffers are rebuilt from the resized state below
                with np.load(os.path.join(ckpt, "strategy_extra.npz")) as z:
                    sh = torch.from_numpy(z["clm.sh_host"]).to(device)
                state = replace(state, params=replace(state.params, sh=sh))
            state = G.resize_rows(state, cfg.debug.drop_duplicate_gaussians_coeff)
            opt_state = init_adam(state.params)
            logger.write(
                f"drop_duplicate_gaussians: resized to {state.n_alive} rows\n")

    bsz = cfg.opt.bsz
    W, H = scene.width, scene.height
    spatial = scene.cameras_extent
    xyz_lr_fn = get_expon_lr_func(
        cfg.opt.position_lr_init * spatial * cfg.opt.lr_scale_pos_and_scale,
        cfg.opt.position_lr_final * spatial * cfg.opt.lr_scale_pos_and_scale,
        lr_delay_mult=cfg.opt.position_lr_delay_mult,
        max_steps=cfg.opt.position_lr_max_steps,
    )
    lr_scale = lr_batch_scale(bsz, cfg.opt.lr_scale_mode)
    adam_cfg = AdamConfig().scaled(bsz, cfg.opt.lr_scale_mode)

    # the (data x gauss) mesh: the state and moments sharded along capacity,
    # cameras along the batch (clm: its host rows too, below)
    mesh = sharded_step = None
    if dist.is_initialized() and cfg.tpu.shard_gaussians:
        if naive:
            logger.write("naive_offload does not support multi-chip sharding; "
                         "running single-device\n")
        elif clm:
            mesh = M.make_mesh(cfg.tpu.mesh_shape, device)
            logger.write(f"multi-chip mesh (clm gauss sharding): {mesh.shape}\n")
            if bsz % mesh.n_data:
                logger.write(f"mesh data axis {mesh.n_data} does not divide bsz {bsz}; "
                             "clm runs one camera chain, the whole tour, on every "
                             "data rank\n")
            elif mesh.n_data > 1:
                logger.write(f"clm data-parallel: {mesh.n_data} camera chains\n")
        else:
            n_data, _ = M.mesh_dims(cfg.tpu.mesh_shape, world)
            if bsz % n_data:
                logger.write(f"mesh data axis {n_data} does not divide bsz {bsz}; "
                             "running single-device\n")
            else:
                mesh = M.make_mesh(cfg.tpu.mesh_shape, device)
                opt_state = M.shard_capacity_tree(opt_state, mesh, state.capacity)
                state = M.shard_state(state, mesh)
                logger.write(f"multi-chip mesh: {mesh.shape}\n")
                sharded_step = make_sharded_train_step(
                    mesh, W, H, sparse_adam=cfg.aux.sparse_adam,
                    lambda_dssim=cfg.opt.lambda_dssim, loss_scale=cfg.opt.lr_scale_loss,
                    stop_update_param=cfg.debug.stop_update_param,
                    accumulate_stats=not cfg.opt.disable_auto_densification)

    def whole(state, opt_state):
        """The state and moments with every row, on every rank."""
        if mesh is None:
            return state, opt_state
        rows = state.capacity
        return (M.gather_capacity_tree(state, mesh, rows),
                M.gather_capacity_tree(opt_state, mesh, rows))

    strategy_ctx = None
    extra_path = os.path.join(ckpt, "strategy_extra.npz") if ckpt else ""
    if naive:
        opt_state = None
        strategy_ctx = strategy.make_context(cfg, state, adam_cfg)
        # a resized resume restarts the optimizer and changes the row count:
        # the saved moments no longer apply
        if (extra_path and os.path.exists(extra_path)
                and cfg.debug.drop_duplicate_gaussians_coeff == 1.0):
            with np.load(extra_path) as z:
                strategy_ctx = strategy.restore_extra(strategy_ctx, dict(z))
        # the parameters live on the host; the card holds a copy only within
        # a batch, an eval or a densification round
        state = strategy.strip_device_params(state)
    elif clm:
        if not ckpt:
            # the loader put the SH rows on the host; they never reach the card
            # (opt_state, made above, has the 4 card groups and the SH
            # placeholder's moments: a second one would sit beside it)
            strategy_ctx = strategy.make_context_from_host(cfg, scene.host_sh,
                                                           adam_cfg, device)
        elif state.params.sh.shape[0] != state.capacity:
            # a clm checkpoint: the card moments are restored, the SH rows
            # and their moments come from strategy_extra.npz
            if not os.path.exists(extra_path):
                raise FileNotFoundError(f"{extra_path}: a clm checkpoint needs it")
            strategy_ctx = strategy.make_context_empty(cfg, state.capacity,
                                                       adam_cfg, device)
            with np.load(extra_path) as z:
                strategy_ctx = strategy.restore_extra(strategy_ctx, dict(z))
        else:  # a full state: another strategy's checkpoint, or resized
            strategy_ctx = strategy.make_context(cfg, state, adam_cfg)
            state = strategy.strip_device_sh(state)
            opt_state = init_adam(state.params)
        scene.host_sh = None  # the context owns the host rows
        closing.callback(strategy_ctx.close)
        if mesh is not None:
            opt_state = M.shard_capacity_tree(opt_state, mesh, state.capacity)
            state = M.shard_state(state, mesh)
            strategy.shard_context(strategy_ctx, mesh)
        if cfg.tpu.pinned_host:
            how = ("csrc/pinned_gather.cu and csrc/pinned_scatter.cu"
                   if device.type == "cuda" else "their plain versions on the CPU")
            logger.write("pinned_host: card-side SH gather and gradient scatter on: the "
                         "device reads the rows it fetches out of the pinned host buffer "
                         "and adds the gradients of the rows it drops into the pinned "
                         f"gradient buffer ({how})\n")

    def scalar(v, dev=device):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    # the host Adam reads its learning rates on the host
    lr_dev = "cpu" if naive else device
    fixed_lrs = {
        "opacity": scalar(cfg.opt.opacity_lr * lr_scale, lr_dev),
        "log_scale": scalar(cfg.opt.scaling_lr * cfg.opt.lr_scale_pos_and_scale
                            * lr_scale, lr_dev),
        "quat": scalar(cfg.opt.rotation_lr * lr_scale, lr_dev),
        "sh": sh_column_lr(cfg.opt.feature_lr,
                           device="cpu" if naive or clm else device) * lr_scale,
    }
    background = scalar([1.0, 1.0, 1.0] if cfg.model.white_background
                        else [0.0, 0.0, 0.0])

    # uint8 ground truth on the card when the train set fits the budget:
    # uploaded once, each batch gathered and normalised there
    gt_cache = None
    gt_bytes = len(scene.train_cameras) * 3 * W * H
    if 0 < gt_bytes <= cfg.tpu.gt_device_cache_mb * 2**20:
        gt_cache = torch.from_numpy(np.stack([
            load_raw_image(cfg.aux.decode_dataset_path, c.image_name, W, H)
            for c in scene.train_cameras
        ])).to(device)
        logger.write(f"GT device cache: {len(scene.train_cameras)} images "
                     f"({gt_bytes / 2**20:.0f} MB u8)\n")
    dataset = scene.train_dataset(bsz, skip_load=gt_cache is not None)
    closing.callback(dataset.close)
    e2e = End2endTimer()
    timers = Timer(enabled=cfg.bench.enable_timer)
    profiler = None

    def frozen_probe():
        # naive_offload's canonical xyz is the host copy: the device
        # placeholder would pass vacuously
        xyz = strategy_ctx.params_host["xyz"] if naive else state.params.xyz
        return float(torch.abs(xyz).sum())

    def full_state():
        """The state with its parameters on the device (naive_offload and
        clm_offload: uploaded from the host copy; a mesh: gathered)."""
        if naive or clm:
            return strategy.materialize(whole(state, None)[0], strategy_ctx)
        return whole(state, None)[0]

    check_frozen = cfg.debug.stop_update_param and cfg.debug.stop_update_param_assert
    frozen_param_sum = frozen_probe() if check_frozen else None

    logger.write(f"setup time: {time.time() - t_setup:.1f} s\n")
    if cfg.bench.check_gpu_memory or cfg.bench.check_cpu_memory:
        # the load's peak: the state, the strategy's host buffers, the loader
        logger.write("memory after setup: " + memory_report(
            cfg.bench.check_gpu_memory, cfg.bench.check_cpu_memory) + "\n")
        if clm:
            logger.write(f"clm host state: {strategy.host_state_bytes(strategy_ctx)} "
                         "bytes\n")
    e2e.start()
    ema_loss = None
    iteration = start_iter
    while iteration <= cfg.opt.iterations:
        STAGES.enter("loop")
        sh_degree = min((iteration - 1) // 1000, cfg.model.sh_degree)
        lrs = dict(fixed_lrs, xyz=scalar(float(xyz_lr_fn(iteration)) * lr_scale,
                                         lr_dev))

        timers.start("data_next")
        cams, gt, b_idxs = dataset.next_batch()
        timers.start("stack_cameras")
        cb = stack_cameras(cams, device=device)
        timers.stop("stack_cameras", sync=cb.viewmats)
        if gt_cache is not None:
            idx = torch.tensor(b_idxs, dtype=torch.int64, device=device)
            gt = gt_cache[idx].float() / 255.0
        else:
            gt = torch.from_numpy(gt).to(device)
        timers.stop("data_next")
        if cfg.opt.random_background:
            background = torch.rand(3, generator=generator, device=device)

        if (cfg.debug.profile and iteration >= cfg.debug.profile_start_iter
                and profiler is None):
            profiler = _start_profiler(device)
        timers.start("train_step")
        STAGES.enter("train_step")
        if sharded_step is not None:
            state, opt_state, out = sharded_step(state, opt_state, cb, gt, sh_degree,
                                                 lrs, adam_cfg, background)
        elif naive or clm:
            state, opt_state, strategy_ctx, out = strategy.train_one_batch(
                state, opt_state, strategy_ctx, cb, gt, sh_degree, lrs, adam_cfg,
                background, W, H, cfg, timers=timers)
        else:
            state, opt_state, out = strategy.train_step(
                state, opt_state, cb, gt, sh_degree, lrs, adam_cfg, background,
                W, H, sparse_adam=cfg.aux.sparse_adam,
                accumulate_stats=not cfg.opt.disable_auto_densification,
                lambda_dssim=cfg.opt.lambda_dssim,
                loss_scale=cfg.opt.lr_scale_loss,
                stop_update_param=cfg.debug.stop_update_param,
            )
        timers.stop("train_step", sync=out.losses)
        STAGES.enter("loop")

        loss = float(out.losses.mean())
        ema_loss = loss if ema_loss is None else 0.6 * ema_loss + 0.4 * loss
        if (iteration - 1) % cfg.aux.log_interval < bsz:
            timers.start("log")
            logger.write(
                f"iteration[{iteration},{iteration+bsz}) loss: {loss:.6f} "
                f"ema: {ema_loss:.6f} n3dgs: {state.n_alive}\n")
            if cfg.bench.check_gpu_memory or cfg.bench.check_cpu_memory:
                logger.write("memory: " + memory_report(
                    cfg.bench.check_gpu_memory, cfg.bench.check_cpu_memory) + "\n")
            if check_frozen:
                cur = frozen_probe()
                if cur != frozen_param_sum:
                    raise RuntimeError(
                        f"stop_update_param violated: {cur} != {frozen_param_sum}")
            timers.stop("log")
        if clm and ((iteration - 1) % cfg.aux.log_interval < bsz
                    or cfg.bench.log_cpu_adam_trailing_overhead):
            nb = strategy_ctx.n_batches
            trail = strategy_ctx.trailing_s / nb
            work = strategy_ctx.host_work_s / nb
            hidden = max(0.0, 1.0 - trail / work) if work > 0 else 1.0
            logger.write(f"clm overlap: host work {work * 1e3:.1f} ms/batch, "
                         f"trailing {trail * 1e3:.1f} ms/batch, "
                         f"comm-hidden {hidden * 100:.0f}%\n")
            stored = (f", scatter stored {strategy_ctx.stored_rows} of "
                      f"{strategy_ctx.scatter_rows} rows" if strategy_ctx.scatter_rows else "")
            logger.write(f"clm transfer: up {strategy_ctx.h2d_bytes / nb:.0f} B/batch, "
                         f"down {strategy_ctx.d2h_bytes / nb:.0f} B/batch{stored}\n")
            if strategy_ctx.data_sum_bytes:
                logger.write(
                    f"clm data sum: {strategy_ctx.data_sum_s / nb * 1e3:.1f} ms/batch, "
                    f"{strategy_ctx.data_sum_bytes / nb / 2**20:.1f} MB/batch\n")

        # ---- eval ----
        if any(check_update_at_this_iter(iteration, bsz, ti, 0) or iteration == ti
               for ti in cfg.aux.test_iterations):
            e2e.pause(sync=out.losses)
            timers.start("eval")
            STAGES.enter("eval")
            # naive_offload: one upload for the whole eval, freed after it;
            # clm_offload: each camera gathers its visible SH rows (on a
            # mesh every rank renders each camera through the mesh); a
            # no_offload mesh: every rank gathers the state, rank 0 evaluates
            eval_state = (state, strategy_ctx) if clm else full_state()
            if writer or (clm and mesh is not None):
                training_report(cfg, scene, eval_state, sh_degree, background,
                                iteration, logger, device, strategy,
                                save_images=writer)
            del eval_state
            timers.stop("eval")
            STAGES.enter("loop")
            e2e.start()

        # ---- densification ----
        densify_window = (not cfg.opt.disable_auto_densification
                          and iteration <= cfg.opt.densify_until_iter)
        will_densify = iteration > cfg.opt.densify_from_iter and (
            check_update_at_this_iter(iteration, bsz,
                                      cfg.opt.densification_interval, 0))
        will_reset = check_update_at_this_iter(
            iteration, bsz, cfg.opt.opacity_reset_interval, 0)
        if densify_window and naive and (will_densify or will_reset):
            # densify and reset work on the device parameters: materialize
            # for the section, strip after it (post_densify and
            # post_opacity_reset refresh the host copy)
            state = full_state()
        if densify_window:
            # densification statistics are garbage without param updates
            if cfg.debug.stop_update_param:
                raise ValueError("stop_update_param must be false for "
                                 "densification; it is a debugging flag")
            if will_densify:
                # a mesh: every rank densifies the whole state alike (one
                # generator state), then takes its rows again (clm: its
                # host rows and moments too)
                if mesh is not None:
                    timers.start("mesh.gather")
                    state, opt_state = whole(state, opt_state)
                    if clm:
                        strategy.unshard_context(strategy_ctx, timers)
                    timers.stop("mesh.gather", sync=state.params.xyz)
                timers.start("count_densify")
                n_new = Dn.count_densify(state, cfg.opt.densify_grad_threshold,
                                         cfg.opt.percent_dense, spatial)
                timers.stop("count_densify")
                needed = state.n_alive + n_new
                if needed > 0.92 * state.capacity:
                    new_cap = next_capacity(needed, cfg.tpu.capacity_granule)
                    logger.write(f"capacity {state.capacity} -> {new_cap}\n")
                    timers.start("grow_capacity")
                    state = G.grow_capacity(state, new_cap)
                    opt_state = _grow_opt(opt_state, new_cap)
                    if naive:
                        strategy_ctx = strategy.grow_context(strategy_ctx,
                                                             new_cap, cfg)
                    elif clm:
                        strategy_ctx = strategy.grow_context(
                            strategy_ctx, new_cap, cfg, timers=timers)
                    timers.stop("grow_capacity", sync=state.params.xyz)
                size_prune = iteration > cfg.opt.opacity_reset_interval
                timers.start("densify")
                state, opt_state, info = Dn.densify_and_prune(
                    state, opt_state, generator, cfg.opt.densify_grad_threshold,
                    cfg.opt.min_opacity, spatial, cfg.opt.percent_dense, size_prune,
                    include_sh=not clm,
                )
                if naive or clm:
                    strategy_ctx = strategy.post_densify(strategy_ctx, state, info)
                if mesh is not None:
                    opt_state = M.shard_capacity_tree(opt_state, mesh, state.capacity)
                    state = M.shard_state(state, mesh)
                    if clm:
                        strategy.shard_context(strategy_ctx, mesh, timers)
                timers.stop("densify", sync=state.params.xyz)
                timers.start("log")
                logger.densify_report(iteration, iteration + bsz, info.n_alive,
                                      _device_gb(device), _host_gb())
                timers.stop("log")
            if will_reset:
                timers.start("reset_opacity")
                state, opt_state = Dn.reset_opacity(state, opt_state)
                if naive or clm:
                    strategy_ctx = strategy.post_opacity_reset(strategy_ctx, state)
                timers.stop("reset_opacity", sync=state.params.opacity)
                logger.write(f"iteration[{iteration},{iteration+bsz}) reset_opacity\n")
            if naive:
                state = strategy.strip_device_params(state)

        # ---- save / checkpoint ----
        save_hits = [s for s in cfg.aux.save_iterations
                     if iteration <= s < iteration + bsz]
        if save_hits and not cfg.debug.do_not_save:
            e2e.pause(sync=out.losses)
            timers.start("save")
            # clm_offload: the host SH buffer itself, never the card (a
            # mesh: the whole state and the gathered host rows)
            scene.gaussians = (strategy.materialize_host(whole(state, None)[0],
                                                         strategy_ctx)
                               if clm else full_state())
            if writer:
                scene.save(save_hits[-1], logger)
            scene.gaussians = None
            timers.stop("save")
            logger.write(f"[ITER {iteration}] Saving Gaussians\n")
            e2e.start()
        if any(iteration <= c < iteration + bsz for c in cfg.aux.checkpoint_iterations):
            e2e.pause(sync=out.losses)
            timers.start("checkpoint")
            if naive:
                # self-contained chkpnt.npz: the parameters, zero moments
                # (built on the host), and the host moments beside it
                ck_state, ck_opt = (full_state(),
                                    init_adam(strategy.host_params(strategy_ctx)))
            else:
                # clm_offload: the stripped state and card moments, and the
                # host SH rows and moments beside them; a mesh: every row,
                # the single-device layout
                ck_state, ck_opt = whole(state, opt_state)
            # every rank takes part in a mesh's gathers; rank 0 writes
            extra = strategy.checkpoint_extra(strategy_ctx) if naive or clm else None
            if writer:
                save_checkpoint(cfg.model.model_path, iteration + bsz, ck_state, ck_opt,
                                generator, strategy_extra=extra)
            del ck_state, ck_opt, extra
            timers.stop("checkpoint")
            logger.write(f"[ITER {iteration}] Saving Checkpoint\n")
            e2e.start()

        if profiler is not None and iteration + bsz > cfg.debug.profile_end_iter:
            _stop_profiler(profiler, cfg, logger)
            profiler = None
        iteration += bsz

    if profiler is not None:
        _stop_profiler(profiler, cfg, logger)
    STAGES.enter("end")
    e2e.pause(sync=state.params.xyz)
    if cfg.bench.end2end_time:
        logger.end2end(e2e.elapsed(), cfg.opt.iterations - start_iter + 1)
    if timers.enabled:
        logger.write(timers.report() + "\n")
    if clm:
        # the host SH buffer itself as the SH field: nothing parameter-sized
        # goes up to the card at the end of a run
        return (strategy.materialize_host(whole(state, None)[0], strategy_ctx),
                whole(state, opt_state)[1])
    if naive:
        return full_state(), whole(state, opt_state)[1]
    return whole(state, opt_state)


def _start_profiler(device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def _stop_profiler(prof, cfg, logger):
    prof.stop()
    out_dir = os.path.join(cfg.model.model_path, "profile")
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
    logger.write(f"profiler trace written to {out_dir}\n")


@torch.no_grad()
def training_report(cfg, scene, state, sh_degree, background, iteration, logger,
                    device, strategy=no_offload, save_images=True):
    """Eval: mean L1 and PSNR over the test cameras and a train subset,
    through `strategy`'s eval renders (`state` is what they take). A
    strategy without `eval_batch` (clm_offload) renders each camera alone.
    `save_images`: write the first --num_save_images_during_eval renders
    (off on a rank that writes no files)."""
    W, H = scene.width, scene.height
    # --eval_res_cap: render and compare at an integer-downsampled resolution
    res_f = 1
    if cfg.tpu.eval_res_cap and max(W, H) > cfg.tpu.eval_res_cap:
        res_f = -(-max(W, H) // cfg.tpu.eval_res_cap)
    We, He = W // res_f, H // res_f
    n_eval_train = min(len(scene.test_cameras) or 10, len(scene.train_cameras),
                       cfg.opt.max_num_images_to_evaluate)
    configs = [
        ("test", scene.test_cameras[: cfg.opt.max_num_images_to_evaluate]),
        ("train", scene.train_cameras[:n_eval_train]),
    ]
    eval_bsz = 8
    batch_fn = getattr(strategy, "eval_batch", None)
    for name, cams in configs:
        if not cams:
            continue
        l1s, psnrs = [], []
        saved = 0
        pend_vm, pend_K, pend_c2w, pend_gt = [], [], [], []

        def flush():
            """Up to eval_bsz cameras in one call, read back once."""
            if not pend_vm:
                return
            cb_b = CameraBatch(viewmats=torch.stack(pend_vm), Ks=torch.stack(pend_K),
                               camtoworlds=torch.stack(pend_c2w), width=We, height=He)
            bl1, bps = batch_fn(state, cb_b, torch.stack(pend_gt), sh_degree,
                               background, We, He)
            l1s.extend(bl1.tolist())
            psnrs.extend(bps.tolist())
            for lst in (pend_vm, pend_K, pend_c2w, pend_gt):
                lst.clear()

        for cam, gt in iterate_eval(cams, cfg.aux.decode_dataset_path, W, H):
            cb = stack_cameras([cam], device=device)
            Ke = cb.Ks[0]
            gtj = torch.from_numpy(gt).to(device)
            if res_f > 1:
                Ke = Ke.clone()
                Ke[:2] /= res_f
                gtj = gtj[:, : He * res_f, : We * res_f].reshape(
                    3, He, res_f, We, res_f).mean(dim=(2, 4))
            if saved < cfg.aux.num_save_images_during_eval or batch_fn is None:
                img, _ = strategy.eval_one_cam(
                    state, cb.viewmats[0], Ke, cb.camtoworlds[0], sh_degree,
                    background, We, He)
                l1s.append(float(torch.mean(torch.abs(img - gtj))))
                psnrs.append(float(psnr_fn(torch.clamp(img, 0, 1), gtj)))
                if saved < cfg.aux.num_save_images_during_eval:
                    if save_images:
                        _save_eval_image(cfg, iteration, name, cam, img, gtj)
                    saved += 1
            else:
                pend_vm.append(cb.viewmats[0])
                pend_K.append(Ke)
                pend_c2w.append(cb.camtoworlds[0])
                pend_gt.append(gtj)
                if len(pend_vm) == eval_bsz:
                    flush()
        flush()
        logger.eval_result(iteration, name, float(np.mean(l1s)),
                           float(np.mean(psnrs)), host_gb=_host_gb())


def _save_eval_image(cfg, iteration, split, cam, img, gt):
    from PIL import Image

    out_dir = os.path.join(cfg.model.model_path, "eval_images", str(iteration))
    os.makedirs(out_dir, exist_ok=True)
    for tag, arr in (("render", img), ("gt", gt)):
        a = (torch.clamp(arr, 0, 1) * 255).to(torch.uint8).cpu().numpy()
        Image.fromarray(a.transpose(1, 2, 0)).save(
            os.path.join(out_dir, f"{split}_{cam.image_name}_{tag}.png"))


def main(argv=None, device="cuda"):
    cfg = parse_config(argv)
    with contextlib.ExitStack() as closing:
        # the process group, if the run asks for one, before any card work
        if maybe_initialize(cfg, device):
            closing.callback(dist.destroy_process_group)
        np.random.seed(cfg.debug.seed)
        with torch.autograd.set_detect_anomaly(cfg.debug.detect_anomaly):
            return training(cfg, device=device)


if __name__ == "__main__":
    main()
