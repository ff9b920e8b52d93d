"""The traced run's two phases and its per-layer metrics.

Phase A profiles `trace_batches` batches with the clm Timer off (its spans
open profiler ranges but drain nothing), every call into a layer inside a
range of its own, and each per-layer metric's captures recorded: the card's
busy and window time, the breakdown and the rooflines come from it. Phase B
runs as many batches with the Timer on (each span's edge drains the stream,
so its spans are layer times and not overlap) and reads clm's counters over
them. Each per-layer metric is read by metrics/<name>.py from what both
phases left (`ctx`).
"""

from __future__ import annotations

import torch

from perfbench import harness, trace

COUNTERS = ("h2d_bytes", "adam_work_s")


def recorder(record, out: list):
    """A wrapper that calls the function and appends record(args, kwargs,
    result) to `out` when it is not None."""
    def make(fn):
        def call(*args, **kwargs):
            result = fn(*args, **kwargs)
            rec = record(args, kwargs, result)
            if rec is not None:
                out.append(rec)
            return result
        return call
    return make


def traced(prog, step, k: int, traffic: dict, bench: dict, cell: str) -> dict:
    """Both phases from batch k on; returns the per-layer metrics, the
    device's busy and window seconds, the breakdown and the batches run."""
    mods = {m["name"]: harness.metric_module(m["name"])
            for m in bench["per_layer"] if harness.applies(m, cell)}
    records, wraps = {}, trace.layer_ranges()
    for mod in mods.values():
        for module, attr, key, record in getattr(mod, "CAPTURES", ()):
            if key not in records:
                records[key] = []
                wraps.append((module, attr, recorder(record, records[key])))
    n = traffic["trace_batches"]
    tr, batches = {}, []
    timer = trace.RangedTimer(False)
    with trace.patched(wraps), trace.profiled(tr):
        for _ in range(n):
            with torch.profiler.record_function(trace.BATCH):
                _, _, o = step(k, timer)
                float(o.losses.mean())
            batches.append({"updated_rows": int(o.visible_any.sum())
                            if prog.cfg.aux.sparse_adam else prog.n})
            k += 1
    counters = None
    timer = trace.RangedTimer(True)
    if prog.clm:
        before = {c: getattr(prog.ctx, c) for c in COUNTERS}
        for _ in range(n):
            step(k, timer)
            k += 1
        counters = {c: getattr(prog.ctx, c) - before[c] for c in COUNTERS}
    ctx = {"trace": tr, "records": records, "cache": {}, "batches": batches,
           "card_floats": 11 if prog.clm else 59,
           "timer": {"sums": dict(timer.sums), "counts": dict(timer.counts)},
           "timer_batches": n if prog.clm else 0, "counters": counters}
    metrics = {}
    for name, mod in mods.items():
        v = mod.read(ctx)
        if v is not None:
            metrics[name] = {"value": v, "unit": mod.UNIT}
    return {"metrics": metrics, "batches": n,
            "device": {"busy_s": tr["busy_s"], "window_s": tr["window_s"]},
            "breakdown": trace.breakdown(tr)}
