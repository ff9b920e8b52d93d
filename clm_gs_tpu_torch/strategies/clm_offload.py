"""clm_offload strategy: the selection-critical attributes on the card, the
SH coefficients streamed from the host by visibility
(clm_gs_tpu/strategies/clm_offload.py, single camera chain).

Placement: xyz, opacity, log_scale and quat (11 floats a Gaussian) and
their Adam moments stay on the card. The 48 SH floats, their gradients and
their Adam moments live on the host: `sh_host` and `sh_grad_host` are
(C, 48) float32 tensors, pinned when the run is on the card, and the moments
sit in a `HostAdam`. The state on the card carries a (1, 48) placeholder for
SH, and so do its device moments. Per batch:

  1. on the card, each camera's visible ids (`offload_common.calculate_filters`);
  2. on the host, a TSP camera order over sampled visibility bitmaps and each
     row's finish set: the position of the last camera that sees it;
  3. per camera in that order: the visible SH rows gathered on the host and
     uploaded, the fused forward and backward over the compact set
     (`clm_fused_step`), and the download of the SH gradients of the rows
     that leave the working set, scatter-added into `sh_grad_host`;
  4. a host Adam on one worker thread, submitted for each finish set once
     the gradients of its last camera have landed;
  5. the card's Adam for the four resident groups.

Retention (--retention, on by default): between consecutive cameras the
working set is advanced on the card. Rows both cameras see stay (D), only
the newly visible rows come from the host (H), and only the dropped rows'
accumulated gradients go down (G); the last camera flushes its whole set.
The advance is three row gathers with maps built on the host. Without
retention every camera fetches its whole set; the arithmetic is the same.

Copies run on a comm stream created with --comm_stream_priority. The
compute stream waits for each upload through an event, the comm stream for
the compute stream before each download, and the host for a download's
event before it reads the rows. Staging buffers are pinned, reused, and
rewritten only after the event of their last copy. On the CPU there are no
streams and the same code runs in order. Sizes are exact: the JAX package's
padding to `v_cap` and its bucketed transfer sizes have no counterpart, and
`h2d_bytes`/`d2h_bytes` count the bytes each batch moves.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field, replace
from typing import Optional

import numpy as np
import torch

from clm_gs_tpu_torch.models.gaussians import GaussianParams, GaussianState, host_zeros
from clm_gs_tpu_torch.optim import AdamConfig, adam_step
from clm_gs_tpu_torch.strategies import offload_common as oc
from clm_gs_tpu_torch.strategies.no_offload import StepOut
from clm_gs_tpu_torch.utils import native
from clm_gs_tpu_torch.utils.timer import Timer

SH_COLS = 48


class _Staging:
    """Two host buffers of `cols` columns for the copies between the host
    and the card, used in turn: pinned when the context runs on a card, a
    slot is rewritten only after the event of its last copy, and it grows
    only when a count exceeds it."""

    def __init__(self, cols: int, dtype, pin: bool):
        self.cols, self.dtype, self.pin = cols, dtype, pin
        self.bufs = [None, None]
        self.events = [None, None]
        self.k = 0

    def take(self, n: int) -> torch.Tensor:
        """The next slot's first n rows (contiguous), free to write."""
        self.k ^= 1
        if self.events[self.k] is not None:
            self.events[self.k].synchronize()
            self.events[self.k] = None
        buf = self.bufs[self.k]
        if buf is None or buf.shape[0] < n:
            rows = max(n + n // 4, 4096)
            buf = self.bufs[self.k] = torch.empty((rows, self.cols), dtype=self.dtype,
                                                  pin_memory=self.pin)
        return buf[:n]

    def used_until(self, event):
        self.events[self.k] = event


@dataclass
class ClmContext:
    sh_host: torch.Tensor  # (C, 48) the SH parameters
    sh_grad_host: torch.Tensor  # (C, 48) their gradients within a batch
    adam: native.HostAdam
    device: torch.device  # where batches run
    comm: Optional[torch.cuda.Stream]  # the copies' stream; None on the CPU
    up_rows: _Staging
    up_idx: _Staging
    down: _Staging
    executor: ThreadPoolExecutor = field(
        default_factory=lambda: ThreadPoolExecutor(max_workers=1,
                                                   thread_name_prefix="clm-adam"))
    # overlap meter (sums over batches): trailing_s is the time the host
    # takes after the card's last work of a batch (the last download's
    # scatter and the host Adam still running); scatter_work_s (main thread)
    # and adam_work_s (worker thread) are the host's busy times, in separate
    # fields, each written by one thread only
    trailing_s: float = 0.0
    scatter_work_s: float = 0.0
    adam_work_s: float = 0.0
    n_batches: int = 0
    # every byte the batches copy between the host and the card
    h2d_bytes: int = 0
    d2h_bytes: int = 0

    @property
    def host_work_s(self) -> float:
        return self.scatter_work_s + self.adam_work_s

    def close(self):
        """Stop the host-Adam worker (after its last submitted step)."""
        self.executor.shutdown(wait=True)


def _context(sh_host: torch.Tensor, adam_cfg: AdamConfig, device, cfg) -> ClmContext:
    device = torch.device(device)
    on_card = device.type == "cuda"
    C = sh_host.shape[0]
    comm = (torch.cuda.Stream(device, priority=cfg.aux.comm_stream_priority)
            if on_card else None)
    return ClmContext(
        sh_host=sh_host, sh_grad_host=host_zeros(C, SH_COLS, device),
        adam=native.HostAdam(C, SH_COLS, torch.zeros(SH_COLS), betas=adam_cfg.betas,
                             eps=adam_cfg.eps),
        device=device, comm=comm,
        up_rows=_Staging(SH_COLS, torch.float32, on_card),
        up_idx=_Staging(1, torch.int32, on_card),
        down=_Staging(SH_COLS, torch.float32, on_card),
    )


def make_context_empty(cfg, capacity: int, adam_cfg: AdamConfig,
                       device="cuda") -> ClmContext:
    """Zero buffers, to be filled by `restore_extra`."""
    return _context(host_zeros(capacity, SH_COLS, device), adam_cfg, device, cfg)


def make_context(cfg, state: GaussianState, adam_cfg: AdamConfig) -> ClmContext:
    """A context holding the full `state`'s SH rows and zero moments."""
    device = state.alive.device
    C = state.alive.shape[0]
    if tuple(state.params.sh.shape) != (C, SH_COLS):
        raise ValueError("the state's SH is stripped already: use make_context_empty "
                         "and restore_extra")
    sh_host = host_zeros(C, SH_COLS, device)
    sh_host.copy_(state.params.sh)
    return _context(sh_host, adam_cfg, device, cfg)


def make_context_from_host(cfg, sh_host: torch.Tensor, adam_cfg: AdamConfig,
                           device="cuda") -> ClmContext:
    """A context that takes over the (C, 48) host SH rows of a loader called
    with host_sh=True (pinned there when the run is on a card)."""
    device = torch.device(device)
    if device.type == "cuda" and not sh_host.is_pinned():
        sh_host = sh_host.pin_memory()
    native._require(sh_host, "sh_host", (sh_host.shape[0], SH_COLS))
    return _context(sh_host, adam_cfg, device, cfg)


def materialize_host(state: GaussianState, ctx: ClmContext) -> GaussianState:
    """The state with the host SH buffer itself as its SH field (no copy):
    for the PLY and tensor writers, which gather rows to the host."""
    return replace(state, params=replace(state.params, sh=ctx.sh_host))


def strip_device_sh(state: GaussianState) -> GaussianState:
    """The state with a (1, 48) zero placeholder for SH on the card."""
    sh = torch.zeros((1, SH_COLS), dtype=torch.float32, device=state.alive.device)
    return replace(state, params=replace(state.params, sh=sh))


def materialize(state: GaussianState, ctx: ClmContext) -> GaussianState:
    """The full state, its SH rows uploaded from the host buffer (a copy)."""
    sh = ctx.sh_host.to(state.alive.device, copy=True)
    return replace(state, params=replace(state.params, sh=sh))


def grow_context(ctx: ClmContext, new_cap: int, cfg, timers=None) -> ClmContext:
    """Pad the host buffers and moments with zero rows to `new_cap`; the
    spans split the allocation of the new (pinned) buffers from the copy."""
    tm = timers if timers is not None else Timer(enabled=False)
    C = ctx.sh_host.shape[0]
    tm.start("clm.grow_pin")
    new = [torch.empty((new_cap, SH_COLS), dtype=torch.float32,
                       pin_memory=ctx.device.type == "cuda") for _ in range(2)]
    tm.stop("clm.grow_pin")
    tm.start("clm.grow_copy")
    for buf, old in zip(new, (ctx.sh_host, ctx.sh_grad_host)):
        buf[:C] = old
        buf[C:] = 0.0
    ctx.sh_host, ctx.sh_grad_host = new
    ctx.adam.grow(new_cap)
    tm.stop("clm.grow_copy")
    return ctx


def _order_and_finish_sets(ids_host, dist, alive, reorder_min_last: bool):
    """Camera order and finish sets. `ids_host`: each camera's ascending
    int32 visible ids; `dist` (B, B) int32; `alive` (C,) bool, all on the
    host. Returns (order (B,) int32, finish_sets: the ascending int32 rows
    whose last camera is order[s], for each s, never: the ascending live
    rows no camera sees)."""
    B = len(ids_host)
    order = native.find_tour(dist)
    if reorder_min_last and B > 1:
        # the sparsest camera last
        counts = torch.tensor([len(ids_host[int(c)]) for c in order])
        k = int(torch.argmin(counts))
        order = torch.cat([order[k + 1:], order[:k + 1]])
    last_use = torch.full((alive.shape[0],), -1, dtype=torch.int16)
    for s in range(B):
        native.stamp_rows(last_use, ids_host[int(order[s])], s)
    vis = native.nonzero_stamp(last_use, None, 0)
    by_pos, bucket_counts = native.counting_sort_perm(last_use[vis.long()], B)
    finish_sets = list(torch.split(vis[by_pos.long()], bucket_counts.tolist()))
    never = native.nonzero_stamp(last_use, alive, 1)
    return order, finish_sets, never


def _classify_transition(prev_ids, next_ids):
    """H/D/G split of one camera pair (ascending unique int32 id lists):
    (pd, pn) the positions in prev and next of the rows both see, gp the
    positions in prev of the rows that leave, hn the positions in next of
    the rows that arrive."""
    return native.classify_sorted(prev_ids, next_ids)


def _invert_transition(pd, pn, hn, n_prev: int, n_next: int):
    """Gather maps of the working-set advance, (n_next,) int32 each: the
    next set's row k is row src[k] of [prev rows | arriving rows], and its
    carried gradient row gsrc[k] of [prev gradients | a zero row]."""
    src = torch.full((n_next,), n_prev + len(hn), dtype=torch.int32)
    src[pn.long()] = pd
    src[hn.long()] = n_prev + torch.arange(len(hn), dtype=torch.int32)
    gsrc = torch.full((n_next,), n_prev, dtype=torch.int32)
    gsrc[pn.long()] = pd
    return src, gsrc


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _upload(ctx: ClmContext, host: torch.Tensor, staging: _Staging) -> torch.Tensor:
    """`host` (a view of `staging`'s current slot) copied to the card on the
    comm stream; the compute stream waits for it. On the CPU, a copy."""
    if ctx.comm is None:
        return host.clone()
    compute = torch.cuda.current_stream(ctx.device)
    with torch.cuda.stream(ctx.comm):
        dst = torch.empty(host.shape, dtype=host.dtype, device=ctx.device)
        dst.copy_(host, non_blocking=True)
        done = torch.cuda.Event()
        done.record(ctx.comm)
    compute.wait_event(done)
    dst.record_stream(compute)
    staging.used_until(done)
    return dst


def _download(ctx: ClmContext, rows: torch.Tensor):
    """Start the copy of the (n, 48) `rows` into a download slot after the
    compute stream's work so far; returns (host view, event or None)."""
    host = ctx.down.take(rows.shape[0])
    if ctx.comm is None:
        host.copy_(rows)
        return host, None
    ctx.comm.wait_stream(torch.cuda.current_stream(ctx.device))
    with torch.cuda.stream(ctx.comm):
        host.copy_(rows, non_blocking=True)
        landed = torch.cuda.Event()
        landed.record(ctx.comm)
    rows.record_stream(ctx.comm)
    ctx.down.used_until(landed)
    return host, landed


def _fetch(ctx: ClmContext, ids: torch.Tensor) -> torch.Tensor:
    """The SH rows `ids` gathered on the host and uploaded."""
    host = native.gather_rows(ctx.sh_host, ids, out=ctx.up_rows.take(len(ids)))
    return _upload(ctx, host, ctx.up_rows)


def _advance(ctx: ClmContext, shc, grad_buf, prev_ids, next_ids):
    """Advance the working set from the camera with `prev_ids` to the one
    with `next_ids`. Returns (next SH rows, their carried gradients, the
    gradient rows that leave, their ids)."""
    pd, pn, gp, hn = _classify_transition(prev_ids, next_ids)
    n_prev, n_next = len(prev_ids), len(next_ids)
    h_dev = _fetch(ctx, next_ids[hn.long()])
    src, gsrc = _invert_transition(pd, pn, hn, n_prev, n_next)
    maps = ctx.up_idx.take(2 * n_next + len(gp)).view(-1)
    torch.cat([src, gsrc, gp], out=maps)
    ctx.h2d_bytes += _nbytes(h_dev) + _nbytes(maps)
    maps = _upload(ctx, maps, ctx.up_idx).long()
    shc_next = torch.cat([shc, h_dev])[maps[:n_next]]
    grad_next = torch.cat([grad_buf, grad_buf.new_zeros((1, SH_COLS))])[
        maps[n_next:2 * n_next]]
    return shc_next, grad_next, grad_buf[maps[2 * n_next:]], prev_ids[gp.long()]


def _timed_sparse_step(ctx: ClmContext, rows, grad_scale: float, step: int):
    """The worker thread's host Adam over `rows`, timed for the meter."""
    t0 = time.perf_counter()
    ctx.adam.sparse_step(ctx.sh_host, ctx.sh_grad_host, rows, grad_scale, step)
    ctx.adam_work_s += time.perf_counter() - t0


def _drain(ctx: ClmContext, pending, futures, grad_scale: float, step: int,
           stop_update: bool):
    """Wait for one download, scatter-add its rows into the host gradients,
    then submit the finish set whose last gradients those were."""
    host, landed, ids, rows = pending
    if landed is not None:
        landed.synchronize()
    t0 = time.perf_counter()
    if len(ids):
        native.scatter_add_rows(ctx.sh_grad_host, host, ids)
    ctx.scatter_work_s += time.perf_counter() - t0
    if len(rows) and not stop_update:
        futures.append(ctx.executor.submit(_timed_sparse_step, ctx, rows,
                                           grad_scale, step))


def train_one_batch(state, opt_state, ctx: ClmContext, cams, gt, sh_degree,
                    lrs, adam_cfg, background, width, height, cfg, timers=None):
    """One batch (module docstring). `lrs` holds the four card groups' rates
    on the card and "sh", (48,), read on the host. Returns (state, opt_state,
    ctx, StepOut) with the losses in the cameras' TSP order."""
    tm = timers if timers is not None else Timer(enabled=False)
    p = state.params
    bsz = gt.shape[0]

    # 1. visibility filters on the card, the id lists brought to the host
    tm.start("clm.filters")
    F = oc.calculate_filters(p.xyz, p.quat, p.log_scale, state.alive, cams.viewmats,
                             cams.Ks, width, height, cfg.model.radius_clip)
    flat = torch.cat(F.ids).cpu()
    ids_host = list(torch.split(flat, F.counts.tolist()))
    tm.stop("clm.filters")

    # 2-3. camera order and finish sets on the host
    tm.start("clm.order")
    dist = oc.hamming_distance_matrix(F.sample).cpu()
    alive_host = state.alive.cpu()
    ctx.d2h_bytes += _nbytes(flat) + _nbytes(dist) + _nbytes(alive_host)
    order, finish_sets, never = _order_and_finish_sets(
        ids_host, dist, alive_host, cfg.aux.reorder_by_min_sparsity_at_end)
    tm.stop("clm.order")

    ctx.adam.lr_cols = lrs["sh"].to("cpu", torch.float32).contiguous()
    ctx.adam.step_count += 1
    step = ctx.adam.step_count
    grad_scale = 1.0 / bsz
    sparse_adam = cfg.aux.sparse_adam
    stop_update = cfg.debug.stop_update_param

    # 4. the camera loop. A camera's gradient download is drained one
    # camera later, once the next camera's work is queued on the card.
    acc = oc.make_clm_acc(p)
    campos = cams.camtoworlds[:, :3, 3]
    losses, futures = [], []
    pending = None  # (host rows, landed event, their ids, finish rows)
    shc = grad_buf = None  # the working set's SH rows and gradients
    B = len(order)
    for pos in range(B):
        cam = int(order[pos])
        ids_h = ids_host[cam]
        if shc is None:  # the first camera, or retention off
            tm.start("clm.fetch_h2d")
            shc = _fetch(ctx, ids_h)
            ctx.h2d_bytes += _nbytes(shc)
            grad_buf = torch.zeros_like(shc)
            tm.stop("clm.fetch_h2d", sync=shc)

        tm.start("clm.micro")
        loss, grad_buf = oc.clm_fused_step(
            p, shc, grad_buf, F.ids[cam], cams.viewmats[cam], cams.Ks[cam],
            campos[cam], gt[cam], acc, sh_degree, background, width, height,
            lambda_dssim=cfg.opt.lambda_dssim, loss_scale=cfg.opt.lr_scale_loss)
        losses.append(loss)
        tm.stop("clm.micro", sync=loss)

        rows = finish_sets[pos]
        if pos == 0 and not sparse_adam and len(never):
            rows = torch.cat([never, rows])
        if cfg.tpu.retention and pos + 1 < B:
            tm.start("clm.advance")
            shc, grad_buf, g_out, g_ids = _advance(ctx, shc, grad_buf, ids_h,
                                                   ids_host[int(order[pos + 1])])
            tm.stop("clm.advance")
        else:  # the last camera, or retention off: flush the whole set
            g_out, g_ids = grad_buf, ids_h
            shc = grad_buf = None
        ctx.d2h_bytes += _nbytes(g_out)
        new_pending = (*_download(ctx, g_out), g_ids, rows)
        if pending is not None:
            tm.start("clm.d2h_scatter")
            _drain(ctx, pending, futures, grad_scale, step, stop_update)
            tm.stop("clm.d2h_scatter")
        pending = new_pending

    # 5. Adam of the four card groups; the SH placeholder passes through
    if stop_update:
        new_params, new_opt = p, opt_state
    else:
        grads = GaussianParams(acc.g_xyz / bsz, acc.g_opacity / bsz,
                               acc.g_log_scale / bsz, acc.g_quat / bsz, p.sh)
        mask = (state.alive & acc.vis_any) if sparse_adam else state.alive
        new_params, new_opt = adam_step(
            p, grads, opt_state, {k: lrs[k] for k in oc.GPU_FIELDS}, adam_cfg, mask)

    # the last download and the host Adam, after the card's work is done
    if ctx.device.type == "cuda":
        torch.cuda.current_stream(ctx.device).synchronize()
    t_dev_done = time.perf_counter()
    _drain(ctx, pending, futures, grad_scale, step, stop_update)
    for f in futures:
        f.result()
    ctx.trailing_s += time.perf_counter() - t_dev_done
    ctx.n_batches += 1

    new_state = GaussianState(
        params=new_params, alive=state.alive, n_alive=state.n_alive,
        xyz_grad_accum=state.xyz_grad_accum + acc.accum,
        denom=state.denom + acc.denom, max_radii2d=state.max_radii2d,
    )
    return new_state, new_opt, ctx, StepOut(torch.stack(losses), max(acc.n_isects),
                                            acc.vis_any, tuple(acc.n_isects))


def post_densify(ctx: ClmContext, state: GaussianState, info) -> ClmContext:
    """Replay densification's row moves on the host SH rows: each clone or
    split child copies its source's row. Every source row is gathered
    before any write, as children may land in the freed slots of split
    sources (the card's scatter reads the pre-densify rows too). The moments
    and gradients of the written rows are zeroed."""
    C = state.alive.shape[0]
    moves = []
    for dest in [info.clone_dest] + list(info.split_dest):
        dest = dest.cpu().long()
        src = torch.nonzero(dest < C).flatten()
        moves.append((dest[src], ctx.sh_host[src]))
    for dest, rows in moves:
        ctx.sh_host[dest] = rows
    written = info.written.cpu()
    ctx.adam.exp_avg[written] = 0.0
    ctx.adam.exp_avg_sq[written] = 0.0
    ctx.sh_grad_host[written] = 0.0
    return ctx


def post_opacity_reset(ctx: ClmContext, state: GaussianState) -> ClmContext:
    return ctx  # opacity lives on the card; SH untouched


def checkpoint_extra(ctx: ClmContext) -> dict:
    """The host SH rows, moments and step count, for `strategy_extra.npz`
    (the JAX package's keys)."""
    return {
        "clm.sh_host": ctx.sh_host.numpy(),
        "clm.exp_avg": ctx.adam.exp_avg.numpy(),
        "clm.exp_avg_sq": ctx.adam.exp_avg_sq.numpy(),
        "clm.step_count": np.asarray(ctx.adam.step_count),
    }


def restore_extra(ctx: ClmContext, arrays: dict) -> ClmContext:
    """The host SH rows, moments and step count of `strategy_extra.npz`
    (copied: the context updates them in place)."""
    sh = torch.from_numpy(np.array(arrays["clm.sh_host"], np.float32, order="C"))
    ctx.sh_host = sh.pin_memory() if ctx.device.type == "cuda" else sh
    ctx.sh_grad_host = host_zeros(sh.shape[0], SH_COLS, ctx.device)
    for k in ("exp_avg", "exp_avg_sq"):
        setattr(ctx.adam, k, torch.from_numpy(
            np.array(arrays[f"clm.{k}"], np.float32, order="C")))
    ctx.adam.step_count = int(arrays["clm.step_count"])
    return ctx


@torch.no_grad()
def eval_one_cam(state_and_ctx, viewmat, Kmat, camtoworld, sh_degree: int,
                 background, width: int, height: int):
    """Eval of one camera: its filter, its SH rows gathered from the host,
    the render of the compact set. `state_and_ctx` is (state, context).
    Returns (image, n_isects)."""
    state, ctx = state_and_ctx
    p = state.params
    F = oc.calculate_filters(p.xyz, p.quat, p.log_scale, state.alive, viewmat[None],
                             Kmat[None], width, height, 0.0)
    shc = _fetch(ctx, F.ids[0].cpu())
    return oc.eval_visible(p, F.ids[0], shc, viewmat, Kmat, camtoworld[:3, 3],
                           sh_degree, background, width, height)
