"""The traced run's instruments: host ranges around the calls into each
layer of the port, the clm Timer's spans as ranges, a torch.profiler trace
of a bounded number of batches, and its reading: the card's busy time (the
union of its kernels, copies and memsets), the kernels' times by name and
in launch order, and the card's idle time attributed to the innermost
benchmark range open on the main thread at the time.

`_union` and `_covered` are frozen copies of the port's
`utils/trace_clm.py` arithmetic.
"""

from __future__ import annotations

import bisect
import contextlib
import importlib
import json
import os
import tempfile
from collections import defaultdict

import torch

from clm_gs_tpu_torch.utils.timer import Timer

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench.window"
BATCH = "bench.batch"
# the calls into the port's layers that the traced batches open a range
# around: (module, attribute, range name)
LAYER_CALLS = (
    ("clm_gs_tpu_torch.strategies.base", "fully_fused_projection", "layer.projection"),
    ("clm_gs_tpu_torch.strategies.base", "sh_basis", "layer.sh"),
    ("clm_gs_tpu_torch.strategies.base", "rasterize", "layer.rasterize"),
    ("clm_gs_tpu_torch.ops.rasterize", "isect_tiles", "layer.binning"),
    ("clm_gs_tpu_torch.ops.rasterize", "rasterize_fwd", "layer.composite_fwd"),
    ("clm_gs_tpu_torch.ops.rasterize", "rasterize_bwd", "layer.composite_bwd"),
    ("clm_gs_tpu_torch.ops.rasterize", "segment_reduce_sorted", "layer.segreduce"),
    ("clm_gs_tpu_torch.strategies.no_offload", "photometric_loss", "layer.loss"),
    ("clm_gs_tpu_torch.strategies.offload_common", "photometric_loss", "layer.loss"),
    ("torch.autograd", "backward", "layer.backward"),
    ("clm_gs_tpu_torch.strategies.no_offload", "adam_step", "layer.adam"),
    ("clm_gs_tpu_torch.strategies.clm_offload", "adam_update_", "layer.adam"),
    ("clm_gs_tpu_torch.strategies.clm_offload", "_timed_sparse_step", "layer.host_adam"),
)


class RangedTimer(Timer):
    """The port's Timer whose spans also open a profiler range of their
    name; it drains the stream and sums only when `enabled`."""

    def __init__(self, enabled: bool):
        super().__init__(enabled)
        self._ranges = {}

    def start(self, key, sync=None):
        super().start(key, sync)
        rf = torch.profiler.record_function(key)
        rf.__enter__()
        self._ranges[key] = rf

    def stop(self, key, sync=None):
        super().stop(key, sync)
        rf = self._ranges.pop(key, None)
        if rf is not None:
            rf.__exit__(None, None, None)


@contextlib.contextmanager
def patched(wraps):
    """Replace module attributes for the block: `wraps` is a list of
    (module name, attribute, wrapper(original) -> replacement)."""
    undo = []
    try:
        for mod_name, attr, make in wraps:
            mod = importlib.import_module(mod_name)
            orig = getattr(mod, attr)
            setattr(mod, attr, make(orig))
            undo.append((mod, attr, orig))
        yield
    finally:
        for mod, attr, orig in reversed(undo):
            setattr(mod, attr, orig)


def ranged(name):
    def make(fn):
        def call(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return call
    return make


def layer_ranges():
    return [(m, a, ranged(n)) for m, a, n in LAYER_CALLS]


@contextlib.contextmanager
def profiled(out: dict):
    """Profile the block (CPU and CUDA activities) inside a WINDOW range;
    on exit, `out` gets `read` of the trace, written to and deleted from a
    temporary directory."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with tempfile.TemporaryDirectory(prefix="perfbench-trace-") as d:
        path = os.path.join(d, "trace.json")
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function(WINDOW):
                yield
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        prof.export_chrome_trace(path)
        del prof
        out.update(read(path))


def _union(intervals):
    """Sorted disjoint (start, end) pairs covering `intervals`."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _covered(union, a, b, starts):
    """Length of [a, b] covered by the disjoint sorted `union` (its starts
    in `starts`)."""
    k = max(bisect.bisect_right(starts, a) - 1, 0)
    total = 0.0
    while k < len(union) and union[k][0] < b:
        lo, hi = max(union[k][0], a), min(union[k][1], b)
        if hi > lo:
            total += hi - lo
        k += 1
    return total


def _gaps(union, a, b):
    """The (start, end) stretches of [a, b] that `union` leaves uncovered."""
    out, t = [], a
    for lo, hi in union:
        if hi <= t:
            continue
        if lo >= b:
            break
        if lo > t:
            out.append((t, lo))
        t = max(t, hi)
    if t < b:
        out.append((t, b))
    return out


def innermost(ranges, times):
    """For each of the sorted `times`, the name of the innermost of the
    nested (start, end, name) `ranges` open then, or None."""
    ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
    out, stack, i = [], [], 0
    for t in times:
        while i < len(ranges) and ranges[i][0] <= t:
            while stack and stack[-1][1] < ranges[i][0]:
                stack.pop()
            stack.append(ranges[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def read(path) -> dict:
    """{"window_s", "busy_s", "kernels": {name: [(start, seconds) in launch
    order]}, "idle_by_range": {range: seconds}} of the Chrome trace at
    `path`, within its WINDOW range."""
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    dev, ranges, window, main_tid = [], [], None, None
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a = float(e["ts"])
        b = a + float(e["dur"])
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            dev.append((a, b, cat, e.get("name", "")))
        elif cat == "user_annotation":
            if e["name"] == WINDOW:
                window, main_tid = (a, b), e.get("tid")
            ranges.append((a, b, e["name"], e.get("tid")))
    if window is None:
        raise RuntimeError("the trace holds no benchmark window")
    a, b = window
    dev = [d for d in dev if d[1] > a and d[0] < b]
    union = _union([(max(x, a), min(y, b)) for x, y, _, _ in dev])
    starts = [u[0] for u in union]
    busy = _covered(union, a, b, starts)
    kernels = defaultdict(list)
    for x, y, cat, name in sorted(dev):
        if cat == "kernel":
            kernels[name].append((x, (y - x) * 1e-6))
    main = [(x, y, n) for x, y, n, tid in ranges if tid == main_tid and n != WINDOW]
    gaps = _gaps(union, a, b)
    mids = sorted(((lo + hi) / 2, hi - lo) for lo, hi in gaps)
    idle = defaultdict(float)
    for name, (_, length) in zip(innermost(main, [m for m, _ in mids]), mids):
        idle[name or "outside any range"] += length * 1e-6
    return {"window_s": (b - a) * 1e-6, "busy_s": busy * 1e-6, "kernels": dict(kernels),
            "idle_by_range": dict(idle)}


def breakdown(tr: dict, top: int = 10) -> dict:
    """The device operations that took most time and the idle time by the
    host range open, at most `top` of each, as [name, seconds]."""
    ops = sorted(((n, sum(s for _, s in d)) for n, d in tr["kernels"].items()),
                 key=lambda x: -x[1])
    idle = sorted(tr["idle_by_range"].items(), key=lambda x: -x[1])
    return {"device_ops": [[n[:160], s] for n, s in ops[:top]],
            "idle_gaps": [[n, s] for n, s in idle[:top]]}


def kernel_times(tr: dict, name: str):
    """Seconds of each launch, in launch order, of the kernels whose name
    contains `name`."""
    return [s for _, s in sorted(x for k, d in tr["kernels"].items() if name in k
                                 for x in d)]
