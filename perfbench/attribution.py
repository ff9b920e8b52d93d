"""The card's time by the program span that launched it, from the traced
run's Chrome trace.

Every kernel, copy and memset in the benchmark window is matched to its
launch (a `cuda_runtime` or `cuda_driver` event) by the trace's
`correlation` id, and the launch is placed among the ranges the main thread
had open at its host time: by time and not by thread, as autograd launches
the backward's kernels from a thread of its own while the main thread waits
inside `render.backward`. `read` gives, in seconds of device time, what was
launched within each range (the range or any range inside it: `within_s`)
and what was launched where each range was the innermost (`self_s`, by
`perfbench.trace.innermost`). A launch outside every range counts for none.

The trace is deleted when `trace.profiled` has read it, so the readers take
this module's reading through one capture of `trace.read`, `CAPTURE`: the
traced run patches `trace.read` before `profiled` calls it, and the capture
reads the same file.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict

from perfbench import trace

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
KEY = "attribution"


def read(path) -> dict:
    """{"within_s": {range: s}, "self_s": {range: s}, "launched_s": s} of
    the Chrome trace at `path`, within its benchmark window."""
    with open(path) as f:
        events = json.load(f)
    events = events["traceEvents"] if isinstance(events, dict) else events
    launch, dev, ranges, window, main_tid = {}, [], [], None, None
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, args = e.get("cat"), e.get("args") or {}
        if cat in LAUNCH_CATS and "correlation" in args:
            launch[args["correlation"]] = float(e["ts"])
        elif cat in trace.DEVICE_CATS and "correlation" in args:
            dev.append((args["correlation"], float(e["dur"])))
        elif cat == "user_annotation":
            a = float(e["ts"])
            if e["name"] == trace.WINDOW:
                window, main_tid = (a, a + float(e["dur"])), e.get("tid")
            ranges.append((a, a + float(e["dur"]), e["name"], e.get("tid")))
    if window is None:
        raise RuntimeError("the trace holds no benchmark window")
    lo, hi = window
    launched = sorted((launch[c], d * 1e-6) for c, d in dev
                      if c in launch and lo <= launch[c] <= hi)
    times = [t for t, _ in launched]
    main = [(a, b, n) for a, b, n, tid in ranges if tid == main_tid and n != trace.WINDOW]
    own = defaultdict(float)
    for name, (_, s) in zip(trace.innermost(main, times), launched):
        if name is not None:
            own[name] += s
    total = [0.0]
    for _, s in launched:
        total.append(total[-1] + s)
    spans = defaultdict(list)
    for a, b, n in main:
        spans[n].append((a, b))
    within = {}
    for n, iv in spans.items():
        within[n] = sum(total[bisect.bisect_right(times, b)] - total[bisect.bisect_left(times, a)]
                        for a, b in trace._union(iv))
    return {"within_s": within, "self_s": dict(own), "launched_s": total[-1]}


def _record(args, kwargs, result):
    return read(args[0])


CAPTURE = ("perfbench.trace", "read", KEY, _record)


def per_batch_ms(ctx, names):
    """The device time launched within the ranges `names`, summed, in ms a
    traced batch; None where the trace has none of them, or no device
    event at all (a run on the CPU)."""
    recs = ctx["records"].get(KEY)
    if not recs or not recs[-1]["launched_s"] or not ctx["batches"]:
        return None
    within = recs[-1]["within_s"]
    if not any(n in within for n in names):
        return None
    return sum(within.get(n, 0.0) for n in names) / len(ctx["batches"]) * 1e3
