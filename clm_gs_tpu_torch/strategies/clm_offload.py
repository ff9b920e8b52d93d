"""clm_offload strategy: the selection-critical attributes on the card, the
SH coefficients streamed from the host by visibility
(clm_gs_tpu/strategies/clm_offload.py).

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
     that leave the working set, scatter-added into `sh_grad_host` (by the
     card under --pinned_host, below);
  4. a host Adam on one worker thread, submitted for each finish set once
     the gradients of its last camera have landed;
  5. the card's Adam for the four resident groups, in place over row chunks
     (`optim.adam_update_`; the JAX package's donated `_adam_tail`).

The card holds the resident state (the four groups, their two moments,
alive and the three statistics: 145 bytes a row), a batch's accumulators
(53 bytes a row) and a bounded working set: the filters' row chunks, a
camera's compact set, the tail's row chunks.

Retention (--retention, on by default): between consecutive cameras the
working set is advanced on the card. Rows both cameras see stay (D), only
the newly visible rows come from the host (H), and only the dropped rows'
accumulated gradients go down (G); the last camera flushes its whole set.
The advance is three row gathers with maps built on the host. Without
retention every camera fetches its whole set; the arithmetic is the same.

With --pinned_host (`ClmContext.card_gather`) the card moves the SH rows
itself, both ways, through the pinned buffers' mapped addresses:
- it gathers the SH rows out of `sh_host` by ids on the card
  (`utils/hostmem.gather_rows_pinned`, csrc/pinned_gather.cu): the first
  fetch and the eval by the filter's ids, the advance by the arriving rows'
  ids, which go up with its maps. No host gather, no staging slot and no
  row upload; each gather runs on the compute stream, so it is ordered
  before its camera's gradients go down and thus before the host Adam
  rewrites any row it reads;
- it adds the leaving gradient rows into `sh_grad_host` by ids on the card
  (`utils/hostmem.scatter_add_rows_pinned`, csrc/pinned_scatter.cu), on the
  comm stream after the compute stream's work: a flush by the camera's
  filter ids, an advance's leaving rows by those ids at the positions its
  maps already carry up. No download slot and no host scatter; the drain
  waits for the scatter's event, then submits the finish set's host Adam.
  The rows of a launch are unique, and a row a finish set hands to the host
  Adam is written by no later launch of the batch.
- a row's first departure in a batch goes to a zero slot: the host Adam
  zeroes every row it consumes, and every row a batch sees is in one finish
  set. So each launch's rows are ordered [first departures | repeats] on
  the host (a (C,) bool of the rows that left, `_stores_first`; a flush's
  order goes up as a permutation), and the kernel stores the first ones
  without reading their slots (`n_store`). Only a row that leaves, comes
  back and leaves again is read back and added to. This holds while
  `ClmContext.grad_zero` does: a batch under --stop_update_param leaves its
  gradients in the buffer, and clears it.
`h2d_bytes` counts the rows the gather reads as an upload's, the rows the
scatter reads back for its add, and a flush's permutation; `d2h_bytes` the
rows it writes.

Copies run on a comm stream created with --comm_stream_priority. The
compute stream waits for each upload through an event, the comm stream for
the compute stream before each download, and the host for a download's
event before it reads the rows. Staging buffers are pinned, reused, and
rewritten only after the event of their last copy. On the CPU there are no
streams and the same code runs in order. Sizes are exact: the JAX package's
padding to `v_cap` and its bucketed transfer sizes have no counterpart, and
`h2d_bytes`/`d2h_bytes` count the bytes each batch moves.

On a (data x gauss) mesh (`shard_context`; one process a card) rank (d, g)
holds C/n_gauss rows of everything: the card state (`parallel/mesh.py`)
and, in its own host memory, the SH rows of its gauss shard, their
gradients and moments. No SH row crosses ranks. The n_data ranks of a gauss
group hold bit-identical copies of its host state. Per batch:

  1. every rank filters its own rows for all B cameras (local ids); the
     Hamming matrix and visible counts are summed over the gauss group
     (`offload_common.order_inputs`), so every rank finds the same tour;
  2. where the data axis divides the batch, the tour is cut into n_data
     chains of S = B / n_data cameras, run in lockstep: data rank d runs
     cameras order[d*S:(d+1)*S], step s the s-th of each, with retention
     within the chain. Finish sets are bucketed by step: a row finishes at
     its last step over every chain (JAX `_order_and_finish_sets(...,
     n_chains)`). Otherwise one chain, the whole tour on every data rank;
  3. each camera's micro step gathers the gauss group's projected rows
     (`offload_common.micro_step_visible`); the rank gets the gradients of
     its own compact rows;
  4. once step s's download is scatter-added, finish set s's gradient rows
     are summed over the data group (one all_reduce; none with one chain),
     then the host Adam runs on them, alike on every data replica;
  5. the card's gradients and statistics are summed over the data group in
     one all_reduce, the losses and instance counts gathered in step-major
     order (each step's chains in data order), and the card's Adam runs on
     the rank's rows.

Every collective is issued by the main thread, in the same order on every
rank, on the compute stream; the host-Adam worker never calls one.

`prepare_device_loop` splits the card's share of a batch from the host's: it
stages a whole batch on the card and replays only the card's work.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field, replace
from typing import Optional

import numpy as np
import torch

import torch.distributed as dist

from clm_gs_tpu_torch.models.gaussians import GaussianParams, GaussianState, host_zeros
from clm_gs_tpu_torch.optim import AdamConfig, adam_update_
from clm_gs_tpu_torch.parallel import mesh as M
from clm_gs_tpu_torch.strategies import offload_common as oc
from clm_gs_tpu_torch.strategies.no_offload import StepOut
from clm_gs_tpu_torch.utils import hostmem, native
from clm_gs_tpu_torch.utils.general import STAGES
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
    # (C, 48) their gradients within a batch, and their moments; None in a
    # context for eval alone (`_context`)
    sh_grad_host: Optional[torch.Tensor]
    adam: Optional[native.HostAdam]
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
    # --pinned_host: the card gathers the SH rows out of sh_host itself
    card_gather: bool = False
    # every row of sh_grad_host is zero between batches (new buffers; the
    # host Adam zeroes the rows it consumes): cleared by a batch under
    # --stop_update_param. Under card_gather the card's scatter then stores
    # each row's first departure of a batch; `departed` marks those rows
    # (C,) on the host, and the meter counts the rows the scatter wrote and
    # of them those it stored without a read (sums over batches)
    grad_zero: bool = True
    departed: Optional[torch.Tensor] = None
    scatter_rows: int = 0
    stored_rows: int = 0
    # the mesh whose gauss shard the buffers hold (`shard_context`), or None
    mesh: Optional[M.Mesh] = None
    # finish sets' gradient rows summed over the data group: staging, and
    # the meter (sums over batches)
    sum_rows: Optional[_Staging] = None
    data_sum_s: float = 0.0
    data_sum_bytes: int = 0
    # bytes of the whole host state (SH rows and both moments) that
    # `unshard_context` assembled, over all its calls
    host_gather_bytes: int = 0

    @property
    def host_work_s(self) -> float:
        return self.scatter_work_s + self.adam_work_s

    def close(self):
        """Stop the host-Adam worker (after its last submitted step)."""
        self.executor.shutdown(wait=True)


def _context(sh_host: torch.Tensor, adam_cfg: Optional[AdamConfig], device,
             cfg) -> ClmContext:
    """adam_cfg None: a context for `eval_one_cam` alone (the renderer), with
    no gradient buffer and no moments: 192 bytes of host memory a row, not
    768 (78.5 GB at 102M rows)."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    C = sh_host.shape[0]
    comm = (torch.cuda.Stream(device, priority=cfg.aux.comm_stream_priority)
            if on_card else None)
    train = adam_cfg is not None
    return ClmContext(
        sh_host=sh_host, sh_grad_host=host_zeros(C, SH_COLS, device) if train else None,
        adam=(native.HostAdam(C, SH_COLS, torch.zeros(SH_COLS), betas=adam_cfg.betas,
                              eps=adam_cfg.eps) if train else None),
        device=device, comm=comm,
        up_rows=_Staging(SH_COLS, torch.float32, on_card),
        up_idx=_Staging(1, torch.int32, on_card),
        down=_Staging(SH_COLS, torch.float32, on_card),
        card_gather=bool(cfg.tpu.pinned_host),
        sum_rows=_Staging(SH_COLS, torch.float32, on_card),
    )


def make_context_empty(cfg, capacity: int, adam_cfg: AdamConfig,
                       device="cuda") -> ClmContext:
    """Zero buffers, to be filled by `restore_extra`."""
    return _context(host_zeros(capacity, SH_COLS, device), adam_cfg, device, cfg)


def make_context(cfg, state: GaussianState, adam_cfg: Optional[AdamConfig]) -> ClmContext:
    """A context holding the full `state`'s SH rows and zero moments (none
    when adam_cfg is None: for eval alone, `_context`)."""
    device = state.alive.device
    C = state.alive.shape[0]
    if tuple(state.params.sh.shape) != (C, SH_COLS):
        raise ValueError("the state's SH is stripped already: use make_context_empty "
                         "and restore_extra")
    sh_host = host_zeros(C, SH_COLS, device)
    sh_host.copy_(state.params.sh)
    return _context(sh_host, adam_cfg, device, cfg)


def make_context_from_host(cfg, sh_host: torch.Tensor, adam_cfg: Optional[AdamConfig],
                           device="cuda") -> ClmContext:
    """A context that takes over the (C, 48) host SH rows of a loader called
    with host_sh=True (pinned there when the run is on a card); with
    adam_cfg None, for eval alone (`_context`)."""
    device = torch.device(device)
    if device.type == "cuda" and not sh_host.is_pinned():
        sh_host = host_zeros(*sh_host.shape, device).copy_(sh_host)
    native._require(sh_host, "sh_host", (sh_host.shape[0], SH_COLS))
    return _context(sh_host, adam_cfg, device, cfg)


def shard_context(ctx: ClmContext, mesh: M.Mesh, timers=None) -> ClmContext:
    """The context cut to this rank's gauss shard, in place: C/n_gauss rows
    of the host SH buffer, its gradients and both moments (page-locked
    copies where the buffers were); it then trains on `mesh`."""
    tm = timers if timers is not None else Timer(enabled=False)
    tm.start("clm.host_shard")
    ctx.sh_host = M.shard_host_rows(ctx.sh_host, mesh)
    ctx.sh_grad_host = M.shard_host_rows(ctx.sh_grad_host, mesh)
    for k in ("exp_avg", "exp_avg_sq"):
        setattr(ctx.adam, k, M.shard_host_rows(getattr(ctx.adam, k), mesh))
    ctx.mesh = mesh
    tm.stop("clm.host_shard")
    return ctx


def host_state_bytes(ctx: ClmContext) -> int:
    """Bytes of the context's host state: the SH rows, their gradients and
    both moments (768 a row of its shard)."""
    return sum(_nbytes(t) for t in (ctx.sh_host, ctx.sh_grad_host, ctx.adam.exp_avg,
                                    ctx.adam.exp_avg_sq))


def _whole_rows(ctx: ClmContext, x: torch.Tensor) -> torch.Tensor:
    """The whole buffer of a host buffer's shard (a collective over the
    gauss group), or `x` itself off a mesh."""
    if ctx.mesh is None:
        return x
    return M.gather_host_rows(x, ctx.mesh, ctx.device)


def unshard_context(ctx: ClmContext, timers=None) -> M.Mesh:
    """Inverse of `shard_context`, in place and alike on every rank: the
    whole host SH buffer and moments gathered over the gauss group, the
    gradients zero (as between batches). Returns the mesh."""
    tm = timers if timers is not None else Timer(enabled=False)
    tm.start("clm.host_gather")
    mesh = ctx.mesh
    ctx.sh_host = _whole_rows(ctx, ctx.sh_host)
    for k in ("exp_avg", "exp_avg_sq"):
        setattr(ctx.adam, k, _whole_rows(ctx, getattr(ctx.adam, k)))
    ctx.sh_grad_host = host_zeros(ctx.sh_host.shape[0], SH_COLS, ctx.device)
    ctx.grad_zero = True
    ctx.host_gather_bytes += 3 * _nbytes(ctx.sh_host)
    ctx.mesh = None
    tm.stop("clm.host_gather")
    return mesh


def materialize_host(state: GaussianState, ctx: ClmContext) -> GaussianState:
    """The state with the host SH buffer itself as its SH field (no copy):
    for the PLY and tensor writers, which gather rows to the host. On a
    mesh, `state` is the whole state and the buffer is gathered (a
    collective)."""
    return replace(state, params=replace(state.params, sh=_whole_rows(ctx, ctx.sh_host)))


def strip_device_sh(state: GaussianState) -> GaussianState:
    """The state with a (1, 48) zero placeholder for SH on the card."""
    sh = torch.zeros((1, SH_COLS), dtype=torch.float32, device=state.alive.device)
    return replace(state, params=replace(state.params, sh=sh))


def materialize(state: GaussianState, ctx: ClmContext) -> GaussianState:
    """The full state, its SH rows uploaded from the host buffer (a copy; on
    a mesh `state` is the whole state, the buffer gathered first)."""
    sh = _whole_rows(ctx, ctx.sh_host).to(state.alive.device, copy=True)
    return replace(state, params=replace(state.params, sh=sh))


def grow_context(ctx: ClmContext, new_cap: int, cfg, timers=None) -> ClmContext:
    """Pad the host buffers and moments with zero rows to `new_cap`; the
    spans split the allocation of the new (pinned) buffers from the copy."""
    tm = timers if timers is not None else Timer(enabled=False)
    C = ctx.sh_host.shape[0]
    tm.start("clm.grow_pin")
    new = [host_zeros(new_cap, SH_COLS, ctx.device) for _ in range(2)]
    tm.stop("clm.grow_pin")
    tm.start("clm.grow_copy")
    for buf, old in zip(new, (ctx.sh_host, ctx.sh_grad_host)):
        buf[:C] = old
    ctx.sh_host, ctx.sh_grad_host = new
    ctx.adam.grow(new_cap)
    tm.stop("clm.grow_copy")
    return ctx


def _order_and_finish_sets(ids_host, dist_m, alive, reorder_min_last: bool,
                           counts=None, n_chains: int = 1):
    """Camera order and finish sets. `ids_host`: each camera's ascending
    int32 visible ids; `dist_m` (B, B) int32; `alive` (C,) bool; `counts`
    (B,) the cameras' visible counts (on a gauss shard the whole scene's;
    by default the lengths of `ids_host`), all on the host. With n_chains >
    1 the tour is cut into n_chains segments of S = B / n_chains cameras run
    in lockstep, chain d the cameras order[d*S:(d+1)*S], and a row finishes
    at its last step over every chain. Returns (order (B,) int32,
    finish_sets: for each step s the ascending int32 rows that finish
    there, never: the ascending live rows no camera sees)."""
    B = len(ids_host)
    order = native.find_tour(dist_m)
    if counts is None:
        counts = torch.tensor([len(i) for i in ids_host])
    if reorder_min_last and B > 1:
        # the sparsest camera last
        k = int(torch.argmin(counts[order.long()]))
        order = torch.cat([order[k + 1:], order[:k + 1]])
    S = B // n_chains
    last_use = torch.full((alive.shape[0],), -1, dtype=torch.int16)
    for s in range(S):  # step-major: a later step overwrites an earlier one
        for d in range(n_chains):
            native.stamp_rows(last_use, ids_host[int(order[d * S + s])], s)
    vis = native.nonzero_stamp(last_use, None, 0)
    by_pos, bucket_counts = native.counting_sort_perm(last_use[vis.long()], S)
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


def _scatter(ctx: ClmContext, rows: torch.Tensor, ids_dev: torch.Tensor, n_store: int = 0):
    """Under card_gather: the (n, 48) gradient `rows` added into sh_grad_host
    at `ids_dev` (unique ids on the rows' device) by the card, the first
    `n_store` into zero slots, on the comm stream after the compute
    stream's work so far; returns (None, the event the host waits on before
    it reads the rows, or None on the CPU, where the add is done on
    return)."""
    if ctx.comm is None:
        hostmem.scatter_add_rows_pinned(ctx.sh_grad_host, rows, ids_dev, n_store=n_store)
        return None, None
    ctx.comm.wait_stream(torch.cuda.current_stream(ctx.device))
    with torch.cuda.stream(ctx.comm):
        hostmem.scatter_add_rows_pinned(ctx.sh_grad_host, rows, ids_dev, n_store=n_store)
        landed = torch.cuda.Event()
        landed.record(ctx.comm)
    rows.record_stream(ctx.comm)
    ids_dev.record_stream(ctx.comm)
    return None, landed


def _fetch(ctx: ClmContext, ids_dev: torch.Tensor, ids_host=None) -> torch.Tensor:
    """The SH rows `ids_dev` (ids on the batch's device) on that device:
    under card_gather gathered there out of sh_host, else gathered on the
    host by `ids_host` (ids_dev read back when not given) and uploaded."""
    if ctx.card_gather:
        return hostmem.gather_rows_pinned(ctx.sh_host, ids_dev)
    if ids_host is None:
        ids_host = ids_dev.cpu()
    host = native.gather_rows(ctx.sh_host, ids_host, out=ctx.up_rows.take(len(ids_host)))
    return _upload(ctx, host, ctx.up_rows)


def _transition(prev_ids, next_ids):
    """The host side of one working-set advance, from the camera with
    `prev_ids` to the one with `next_ids` (host ids): (maps, the arriving
    rows' ids), maps being [src | gsrc | gp] (`_invert_transition`, then
    the positions in prev of the rows that leave)."""
    pd, pn, gp, hn = _classify_transition(prev_ids, next_ids)
    src, gsrc = _invert_transition(pd, pn, hn, len(prev_ids), len(next_ids))
    return [src, gsrc, gp], next_ids[hn.long()]


def _advance_rows(shc, grad_buf, h_dev, maps, n_next: int):
    """The card side of the advance: (next SH rows, their carried
    gradients, the gradient rows that leave) from the current rows, the
    arriving rows `h_dev` and the int64 maps of `_transition`."""
    shc_next = torch.cat([shc, h_dev])[maps[:n_next]]
    grad_next = torch.cat([grad_buf, grad_buf.new_zeros((1, SH_COLS))])[
        maps[n_next:2 * n_next]]
    return shc_next, grad_next, grad_buf[maps[2 * n_next:]]


def _stores_first(departed, ids, pos):
    """`pos` (int32 positions into the host ids `ids` of rows that leave)
    ordered [the rows' first departures of the batch | repeats], and the
    rows marked in `departed`. Returns (pos, the number of first
    departures)."""
    rows = ids[pos.long()].long()
    first = ~departed[rows]
    departed[rows] = True
    n_store = int(first.sum())
    if 0 < n_store < len(pos):
        pos = torch.cat([pos[first], pos[~first]])
    return pos, n_store


def _departed(ctx: ClmContext, stop_update: bool):
    """The cleared (C,) bool `_stores_first` marks, when this batch's
    first departures may be stored: under card_gather, with every gradient
    row zero at its start (`grad_zero`) and updates on (the host Adam then
    zeroes each row after its finish set). Else None: every row is added."""
    if not (ctx.card_gather and ctx.grad_zero) or stop_update:
        return None
    C = ctx.sh_grad_host.shape[0]
    if ctx.departed is None or ctx.departed.shape[0] != C:
        ctx.departed = torch.zeros(C, dtype=torch.bool)
    else:
        ctx.departed.zero_()
    return ctx.departed


def _advance(ctx: ClmContext, shc, grad_buf, prev_ids, next_ids, prev_dev=None,
             departed=None):
    """Advance the working set from the camera with `prev_ids` to the one
    with `next_ids` (host ids). Returns (next SH rows, their carried
    gradients, the gradient rows that leave, their ids: on the host, or
    under card_gather on the card, `prev_dev` (prev_ids there) at the
    leaving positions of the uploaded maps, and the number of leading
    leaving rows to store: with `departed` (`_departed`), the leaving rows
    go [first departures | repeats]). Under card_gather the arriving rows'
    ids go up after the maps and the card gathers the rows by them."""
    parts, h_ids = _transition(prev_ids, next_ids)
    n_store = 0
    if departed is not None:
        parts[2], n_store = _stores_first(departed, prev_ids, parts[2])
    n_next, gp = len(next_ids), parts[2]
    if ctx.card_gather:
        parts.append(h_ids)
    else:
        h_dev = _fetch(ctx, None, h_ids)
    maps = ctx.up_idx.take(sum(len(t) for t in parts)).view(-1)
    torch.cat(parts, out=maps)
    maps_dev = _upload(ctx, maps, ctx.up_idx)
    g_end = 2 * n_next + len(gp)
    if ctx.card_gather:
        h_dev = _fetch(ctx, maps_dev[g_end:])  # the arriving ids
    ctx.h2d_bytes += _nbytes(h_dev) + _nbytes(maps)
    maps_dev = maps_dev[:g_end].long()
    shc_next, grad_next, g_out = _advance_rows(shc, grad_buf, h_dev, maps_dev, n_next)
    if ctx.card_gather:
        return shc_next, grad_next, g_out, prev_dev[maps_dev[2 * n_next:]], n_store
    return shc_next, grad_next, g_out, prev_ids[gp.long()], n_store


def _flush(ctx: ClmContext, grad_buf, ids_dev, ids_host, departed=None):
    """The whole working set leaves (the last camera, or every camera
    without retention): (its gradient rows, their ids: on the host, or
    under card_gather on the card, and the number of leading rows to
    store). With `departed` the rows go [first departures | repeats], by a
    permutation that goes up when both kinds are there."""
    if not ctx.card_gather:
        return grad_buf, ids_host, 0
    if departed is None:
        return grad_buf, ids_dev, 0
    n = len(ids_host)
    perm, n_store = _stores_first(departed, ids_host, torch.arange(n, dtype=torch.int32))
    if not 0 < n_store < n:
        return grad_buf, ids_dev, n_store
    host = ctx.up_idx.take(n).view(-1)
    host.copy_(perm)
    perm_dev = _upload(ctx, host, ctx.up_idx).long()
    ctx.h2d_bytes += _nbytes(host)
    return grad_buf[perm_dev], ids_dev[perm_dev], n_store


def _timed_sparse_step(ctx: ClmContext, rows, grad_scale: float, step: int):
    """The worker thread's host Adam over `rows`, timed for the meter."""
    t0 = time.perf_counter()
    ctx.adam.sparse_step(ctx.sh_host, ctx.sh_grad_host, rows, grad_scale, step)
    ctx.adam_work_s += time.perf_counter() - t0


def _sum_over_data(ctx: ClmContext, ids):
    """The host gradient rows `ids` (a finish set) summed over the data
    group, in place (one all_reduce; through the card under NCCL): every
    data rank then holds the whole batch's gradients of those rows."""
    t0 = time.perf_counter()
    rows = native.gather_rows(ctx.sh_grad_host, ids, out=ctx.sum_rows.take(len(ids)))
    if ctx.comm is None:
        dist.all_reduce(rows, group=ctx.mesh.data_group)
    else:
        summed = rows.to(ctx.device, non_blocking=True)
        dist.all_reduce(summed, group=ctx.mesh.data_group)
        rows.copy_(summed)
    native.scatter_add_rows(ctx.sh_grad_host, rows, ids, accumulate=False)
    ctx.data_sum_bytes += _nbytes(rows)
    ctx.data_sum_s += time.perf_counter() - t0


def _drain(ctx: ClmContext, pending, futures, grad_scale: float, step: int,
           stop_update: bool):
    """Wait for one download and scatter-add its rows into the host
    gradients (under card_gather: wait for the card's scatter-add), sum the
    finish set over the data group where the chains split the batch, then
    submit the finish set whose last gradients those were."""
    host, landed, ids, rows, summed = pending
    if landed is not None:
        landed.synchronize()
    t0 = time.perf_counter()
    if host is not None and len(ids):
        native.scatter_add_rows(ctx.sh_grad_host, host, ids)
    ctx.scatter_work_s += time.perf_counter() - t0
    if summed is not None and len(summed) and not stop_update:
        _sum_over_data(ctx, summed)
    if len(rows) and not stop_update:
        futures.append(ctx.executor.submit(_timed_sparse_step, ctx, rows,
                                           grad_scale, step))


def _plan(state, ctx: ClmContext, cams, width: int, height: int, cfg, n_chains: int = 1,
          tm=None):
    """Steps 1-2 of a batch: the visibility filters on the card, their ids
    brought to the host, the camera order and the finish sets. Returns
    (filters, host ids per camera, order, finish sets, never-seen rows,
    the bytes read back)."""
    tm = tm if tm is not None else Timer(enabled=False)
    p = state.params
    mesh = ctx.mesh
    tm.start("clm.filters")
    STAGES.enter("clm.filters")
    row0 = 0 if mesh is None else mesh.gauss_index * ctx.sh_host.shape[0]
    F = oc.calculate_filters(p.xyz, p.quat, p.log_scale, state.alive, cams.viewmats,
                             cams.Ks, width, height, cfg.model.radius_clip,
                             sample_phase=-row0 % oc.SAMPLE_STRIDE)
    flat = torch.cat(F.ids).cpu()
    ids_host = list(torch.split(flat, F.counts.tolist()))
    tm.stop("clm.filters")

    tm.start("clm.order")
    STAGES.enter("clm.order")
    dist_m, counts = oc.order_inputs(F, mesh)
    alive_host = state.alive.cpu()
    order, finish_sets, never = _order_and_finish_sets(
        ids_host, dist_m, alive_host, cfg.aux.reorder_by_min_sparsity_at_end, counts,
        n_chains)
    tm.stop("clm.order")
    d2h = _nbytes(flat) + _nbytes(dist_m) + _nbytes(alive_host)
    return F, ids_host, order, finish_sets, never, d2h


def train_one_batch(state, opt_state, ctx: ClmContext, cams, gt, sh_degree,
                    lrs, adam_cfg, background, width, height, cfg, timers=None):
    """One batch (module docstring); on the context's mesh, this rank's
    chain of it. `lrs` holds the four card groups' rates on the card and
    "sh", (48,), read on the host. Returns (state, opt_state, ctx, StepOut)
    with the losses in the cameras' TSP order (on a mesh with chains,
    step-major: each step's cameras in data order).

    Donation: the batch updates `state` and `opt_state` in place and
    returns the same objects (the JAX package's `donate_argnums=(0, 1, 2, 3,
    4)` of its `_adam_tail`): the four card groups' parameters and both
    moments and `steps` (`optim.adam_update_`; not under
    --stop_update_param), and the two densification statistics. No
    parameter-sized copy is made; a caller that needs the starting state
    clones it first."""
    tm = timers if timers is not None else Timer(enabled=False)
    p = state.params
    bsz = gt.shape[0]
    mesh = ctx.mesh
    # camera chains: data rank d runs segment d of the tour where the data
    # axis divides the batch; else every data rank runs the whole tour
    n_chains = mesh.n_data if mesh is not None and bsz % mesh.n_data == 0 else 1
    chain = mesh.data_index if n_chains > 1 else 0

    F, ids_host, order, finish_sets, never, d2h = _plan(state, ctx, cams, width, height,
                                                        cfg, n_chains, tm)
    ctx.d2h_bytes += d2h

    ctx.adam.lr_cols = lrs["sh"].to("cpu", torch.float32).contiguous()
    ctx.adam.step_count += 1
    step = ctx.adam.step_count
    grad_scale = 1.0 / bsz
    sparse_adam = cfg.aux.sparse_adam
    stop_update = cfg.debug.stop_update_param
    departed = _departed(ctx, stop_update)

    # 4. the camera loop over this rank's chain. A camera's gradient
    # download is drained one camera later, once the next camera's work is
    # queued on the card.
    STAGES.enter("clm.micro")
    acc = oc.make_clm_acc(p)
    campos = cams.camtoworlds[:, :3, 3]
    losses, futures = [], []
    # (host rows or None after the card's scatter, landed event, their ids,
    # finish rows, rows to sum)
    pending = None
    shc = grad_buf = None  # the working set's SH rows and gradients
    S = len(order) // n_chains
    mine = order[chain * S:(chain + 1) * S]
    for pos in range(S):
        cam = int(mine[pos])
        ids_h = ids_host[cam]
        if shc is None:  # the first camera, or retention off
            tm.start("clm.fetch_h2d")
            shc = _fetch(ctx, F.ids[cam], ids_h)
            ctx.h2d_bytes += _nbytes(shc)
            grad_buf = torch.zeros_like(shc)
            tm.stop("clm.fetch_h2d", sync=shc)

        tm.start("clm.micro")
        loss, grad_buf = oc.clm_fused_step(
            p, shc, grad_buf, F.ids[cam], cams.viewmats[cam], cams.Ks[cam],
            campos[cam], gt[cam], acc, sh_degree, background, width, height,
            lambda_dssim=cfg.opt.lambda_dssim, loss_scale=cfg.opt.lr_scale_loss,
            mesh=mesh)
        losses.append(loss)
        tm.stop("clm.micro", sync=loss)

        rows = finish_sets[pos]
        summed = rows if n_chains > 1 else None
        if pos == 0 and not sparse_adam and len(never):
            rows = torch.cat([never, rows])
        if cfg.tpu.retention and pos + 1 < S:
            tm.start("clm.advance")
            shc, grad_buf, g_out, g_ids, n_store = _advance(
                ctx, shc, grad_buf, ids_h, ids_host[int(mine[pos + 1])], F.ids[cam],
                departed)
            tm.stop("clm.advance")
        else:  # the last camera, or retention off: flush the whole set
            g_out, g_ids, n_store = _flush(ctx, grad_buf, F.ids[cam], ids_h, departed)
            shc = grad_buf = None
        ctx.d2h_bytes += _nbytes(g_out)
        if ctx.card_gather:  # the scatter reads back each row it adds to
            ctx.h2d_bytes += _nbytes(g_out[n_store:])
            ctx.scatter_rows += len(g_out)
            ctx.stored_rows += n_store
            new_pending = (*_scatter(ctx, g_out, g_ids, n_store), g_ids, rows, summed)
        else:
            new_pending = (*_download(ctx, g_out), g_ids, rows, summed)
        if pending is not None:
            tm.start("clm.d2h_scatter")
            _drain(ctx, pending, futures, grad_scale, step, stop_update)
            tm.stop("clm.d2h_scatter")
        pending = new_pending

    # the chains' card gradients, statistics and visibility summed over the
    # data group in one all_reduce; losses and instance counts gathered
    losses = torch.stack(losses)
    n_isects = tuple(acc.n_isects)
    if n_chains > 1:
        acc, losses, n_isects = _sum_chains(acc, losses, n_isects, mesh)

    # 5. Adam of the four card groups in place, the accumulators divided in
    # their own storage; the SH placeholder passes through
    STAGES.enter("clm.adam")
    if not stop_update:
        for f in oc.GPU_FIELDS:
            getattr(acc, "g_" + f).div_(bsz)
        grads = GaussianParams(acc.g_xyz, acc.g_opacity, acc.g_log_scale, acc.g_quat,
                               p.sh)
        mask = (state.alive & acc.vis_any) if sparse_adam else state.alive
        adam_update_(p, grads, opt_state, {k: lrs[k] for k in oc.GPU_FIELDS}, adam_cfg,
                     mask)
    state.xyz_grad_accum.add_(acc.accum)
    state.denom.add_(acc.denom)
    if stop_update:  # no host Adam consumed this batch's gradient rows
        ctx.grad_zero = False

    # the last download and the host Adam, after the card's work is done
    if ctx.device.type == "cuda":
        torch.cuda.current_stream(ctx.device).synchronize()
    t_dev_done = time.perf_counter()
    _drain(ctx, pending, futures, grad_scale, step, stop_update)
    for f in futures:
        f.result()
    ctx.trailing_s += time.perf_counter() - t_dev_done
    ctx.n_batches += 1
    return state, opt_state, ctx, StepOut(losses, max(n_isects), acc.vis_any, n_isects)


def prepare_device_loop(state, ctx: ClmContext, cams, gt, sh_degree, background,
                        width: int, height: int, cfg):
    """The card's share of a clm batch, alone (the JAX package's
    `prepare_device_loop`). Runs the batch's filters, order and finish sets
    as `train_one_batch` does, then stages on the card everything the batch
    needs: the first camera's SH rows and, for each of the B - 1
    transitions, the arriving rows and the maps of `_transition`. Returns
    (run, n_launch_groups): run() replays the B micro steps and B - 1
    advances with no host work, no upload and no gradient download, and
    returns (the last camera's loss, the batch's `ClmAcc`); it may be
    called again, as it writes none of its staged inputs. The card's Adam
    and the host's are not part of it. n_launch_groups = 2B + 1: B micro
    steps, B - 1 advances, the gradient buffer's and the accumulators'
    allocations. Sizes are exact. On one process only (no mesh)."""
    if ctx.mesh is not None:
        raise ValueError("prepare_device_loop runs on one process, not on a mesh shard")
    p = state.params
    F, ids_host, order, _, _, _ = _plan(state, ctx, cams, width, height, cfg)
    order = [int(c) for c in order]
    dev = ctx.device
    shc0 = native.gather_rows(ctx.sh_host, ids_host[order[0]]).to(dev)
    staged = []
    for a, b in zip(order[:-1], order[1:]):
        parts, h_ids = _transition(ids_host[a], ids_host[b])
        staged.append((native.gather_rows(ctx.sh_host, h_ids).to(dev),
                       torch.cat(parts).to(dev).long(), len(ids_host[b])))
    campos = cams.camtoworlds[:, :3, 3]

    def run():
        shc = shc0
        grad_buf = torch.zeros_like(shc0)
        acc = oc.make_clm_acc(p)
        loss = None
        for pos, cam in enumerate(order):
            loss, grad_buf = oc.clm_fused_step(
                p, shc, grad_buf, F.ids[cam], cams.viewmats[cam], cams.Ks[cam],
                campos[cam], gt[cam], acc, sh_degree, background, width, height,
                lambda_dssim=cfg.opt.lambda_dssim, loss_scale=cfg.opt.lr_scale_loss)
            if pos + 1 < len(order):
                h_dev, maps, n_next = staged[pos]
                shc, grad_buf, _ = _advance_rows(shc, grad_buf, h_dev, maps, n_next)
        return loss, acc

    return run, 2 * len(order) + 1


def _sum_chains(acc: oc.ClmAcc, losses, n_isects, mesh: M.Mesh):
    """The data group's chains combined: the accumulators summed (visibility
    as a count) in one all_reduce, and the (S,) losses and instance counts
    of each chain gathered into the batch's (B,), step-major."""
    parts = [acc.g_xyz, acc.g_opacity[:, None], acc.g_log_scale, acc.g_quat,
             acc.accum[:, None], acc.denom[:, None], acc.vis_any[:, None].float()]
    flat = torch.cat(parts, dim=1)
    dist.all_reduce(flat, group=mesh.data_group)
    g_xyz, g_op, g_ls, g_q, accum, denom, vis = torch.split(
        flat, [p.shape[1] for p in parts], dim=1)
    acc = replace(acc, g_xyz=g_xyz, g_opacity=g_op[:, 0], g_log_scale=g_ls,
                  g_quat=g_q, accum=accum[:, 0], denom=denom[:, 0], vis_any=vis[:, 0] > 0)
    S = losses.shape[0]
    mine = torch.stack([losses.double(), torch.tensor(
        n_isects, dtype=torch.float64, device=losses.device)], dim=1)
    every = M.gather_rows(mine, mesh.data_group, mesh.n_data)
    every = every.view(mesh.n_data, S, 2).transpose(0, 1).reshape(-1, 2)
    return acc, every[:, 0].float(), tuple(int(v) for v in every[:, 1].tolist())


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
    (the JAX package's keys); on a mesh every row, gathered (a
    collective)."""
    return {
        "clm.sh_host": _whole_rows(ctx, ctx.sh_host).numpy(),
        "clm.exp_avg": _whole_rows(ctx, ctx.adam.exp_avg).numpy(),
        "clm.exp_avg_sq": _whole_rows(ctx, ctx.adam.exp_avg_sq).numpy(),
        "clm.step_count": np.asarray(ctx.adam.step_count),
    }


def restore_extra(ctx: ClmContext, arrays: dict) -> ClmContext:
    """The host SH rows, moments and step count of `strategy_extra.npz`
    (copied: the context updates them in place)."""
    sh = torch.from_numpy(np.array(arrays["clm.sh_host"], np.float32, order="C"))
    ctx.sh_host = (host_zeros(*sh.shape, ctx.device).copy_(sh) if ctx.device.type == "cuda"
                   else sh)
    ctx.sh_grad_host = host_zeros(sh.shape[0], SH_COLS, ctx.device)
    ctx.grad_zero = True
    for k in ("exp_avg", "exp_avg_sq"):
        setattr(ctx.adam, k, torch.from_numpy(
            np.array(arrays[f"clm.{k}"], np.float32, order="C")))
    ctx.adam.step_count = int(arrays["clm.step_count"])
    return ctx


@torch.no_grad()
def eval_one_cam(state_and_ctx, viewmat, Kmat, camtoworld, sh_degree: int,
                 background, width: int, height: int):
    """Eval of one camera: its filter, its SH rows gathered from the host
    buffer (on the card under card_gather), the render of the compact set.
    `state_and_ctx` is (state, context). On the context's mesh every rank
    calls it for the same camera: each renders the gauss group's gathered
    rows, and no SH row leaves its rank. Returns (image, n_isects)."""
    state, ctx = state_and_ctx
    p = state.params
    F = oc.calculate_filters(p.xyz, p.quat, p.log_scale, state.alive, viewmat[None],
                             Kmat[None], width, height, 0.0)
    shc = _fetch(ctx, F.ids[0])
    return oc.eval_visible(p, F.ids[0], shc, viewmat, Kmat, camtoworld[:3, 3],
                           sh_degree, background, width, height, ctx.mesh)
