"""Where the card idles in a clm batch: a torch.profiler trace of one batch
of a BigCity run, with the `--enable_timer` spans as trace ranges, read span
by span against the card's activity.

    python -m clm_gs_tpu_torch.utils.trace_clm run ROOT OUT [--iters 192]
        [--trace_batch 3] [-- TRAIN FLAGS]
    python -m clm_gs_tpu_torch.utils.trace_clm read TRACE.json

`run` trains the BigCity scene at ROOT (`utils/bigcity.py run`, with
`--enable_timer --do_not_save` and the flags after `--`, which override)
for `iters` iterations, traces batch `trace_batch` (1-based) with the
training CLI's `--profile` window (CPU and CUDA activities, the Chrome
trace in OUT/profile/trace.json), and has every `Timer` span of the run
open a `torch.profiler.record_function` range of its name, so that the
trace shows the spans on the main thread. Then it reads the trace and
prints one JSON line: the card and its power limit, the run's record, and
`read`'s result.

`read` takes a Chrome trace and returns, for each span name, its calls,
its host milliseconds, and of those the milliseconds in which the card ran
nothing (no kernel, copy or memset on any stream: the union of the device
events' intervals is subtracted), and the same for the traced window (the
`train_step` span). Times are the traced run's: the profiler slows the host
work it records.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "train_step"


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
    import bisect

    k = max(bisect.bisect_right(starts, a) - 1, 0)
    total = 0.0
    while k < len(union) and union[k][0] < b:
        lo, hi = max(union[k][0], a), min(union[k][1], b)
        if hi > lo:
            total += hi - lo
        k += 1
    return total


def read(path, spans=None) -> dict:
    """{span: {calls, host_ms, card_idle_ms, card_busy_ms}} of the Chrome
    trace at `path` for the user ranges named in `spans` (default: every
    range), with `window_*` the same summed over the `train_step` ranges,
    and the device events counted."""
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    dev, ranges = [], defaultdict(list)
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a = float(e["ts"])
        b = a + float(e["dur"])
        if e.get("cat") in DEVICE_CATS:
            dev.append((a, b))
        elif e.get("cat") == "user_annotation" and (spans is None or e["name"] in spans):
            ranges[e["name"]].append((a, b))
    union = _union(dev)
    starts = [u[0] for u in union]
    out = {}
    for name, rs in sorted(ranges.items()):
        host = sum(b - a for a, b in rs)
        busy = sum(_covered(union, a, b, starts) for a, b in rs)
        out[name] = {"calls": len(rs), "host_ms": host / 1e3,
                     "card_busy_ms": busy / 1e3, "card_idle_ms": (host - busy) / 1e3}
    return {"spans": out, "device_events": len(dev),
            "window": out.get(WINDOW),
            "window_idle_share": (out[WINDOW]["card_idle_ms"] / out[WINDOW]["host_ms"]
                                  if out.get(WINDOW) else None)}


def _ranged_timer():
    """Patch `utils.timer.Timer` so that an enabled timer's spans also open
    and close a record_function range of their name; returns the undo."""
    import torch

    from clm_gs_tpu_torch.utils import timer as T

    start, stop = T.Timer.start, T.Timer.stop

    def ranged_start(self, key, sync=None):
        start(self, key, sync)
        if self.enabled:
            rf = torch.profiler.record_function(key)
            rf.__enter__()
            self.__dict__.setdefault("_ranges", {})[key] = rf

    def ranged_stop(self, key, sync=None):
        stop(self, key, sync)
        rf = self.__dict__.get("_ranges", {}).pop(key, None)
        if rf is not None:
            rf.__exit__(None, None, None)

    T.Timer.start, T.Timer.stop = ranged_start, ranged_stop

    def undo():
        T.Timer.start, T.Timer.stop = start, stop
    return undo


def run(root, out, iters: int = 192, trace_batch: int = 3, extra=(), device="cuda") -> dict:
    """Train the BigCity scene at `root` into `out` with batch `trace_batch`
    traced (module docstring); returns the run's record and `read` of the
    trace."""
    import os

    from clm_gs_tpu_torch.utils import bigcity
    from clm_gs_tpu_torch.utils.general import nvidia_smi

    bsz = int(bigcity.BIGCITY_ARGS[bigcity.BIGCITY_ARGS.index("--bsz") + 1])
    if "--bsz" in extra:
        bsz = int(extra[list(extra).index("--bsz") + 1])
    first = (trace_batch - 1) * bsz + 1
    flags = ["--enable_timer", "--do_not_save", "--profile",
             "--profile_start_iter", str(first),
             "--profile_end_iter", str(first + bsz - 1)] + list(extra)
    undo = _ranged_timer()
    try:
        rec = bigcity.run(root, out, iters, extra=flags, device=device)
    finally:
        undo()
    trace = os.path.join(out, "profile", "trace.json")
    return {"card": nvidia_smi(), "trace": trace, "traced_iters": [first, first + bsz - 1],
            "flags": flags, "run": {k: rec.get(k) for k in (
                "n_gaussians", "capacity", "run_s", "overlap_last", "end2end",
                "spans_ms", "peak_device_bytes")},
            "read": read(trace)}


def main(argv=None, device="cuda") -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    rn = sub.add_parser("run", help="train a BigCity scene with one batch traced")
    rn.add_argument("root")
    rn.add_argument("out")
    rn.add_argument("--iters", type=int, default=192)
    rn.add_argument("--trace_batch", type=int, default=3)
    rd = sub.add_parser("read", help="the card's idle time within each span of a trace")
    rd.add_argument("trace")
    argv = list(sys.argv[1:] if argv is None else argv)
    extra = []
    if "--" in argv:
        argv, extra = argv[:argv.index("--")], argv[argv.index("--") + 1:]
    args = ap.parse_args(argv)
    if args.cmd == "run":
        res = run(args.root, args.out, args.iters, args.trace_batch, extra, device)
    else:
        res = read(args.trace)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
