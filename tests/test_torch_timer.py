"""utils/timer.py, the port's tracer, and the spans and counters of the two
benchmarked strategies.

- Under a CPU `torch.profiler`, a disabled and an enabled Timer both open a
  range of each span's name, nested as the spans nest; a batch's root span
  carries its number. An enabled Timer sums and counts as it always did,
  draining at an edge given `sync`.
- With neither a profiler nor an enabled Timer a span edge opens no range,
  allocates nothing, runs no tensor op and reads nothing back.
- A `no_offload.train_step` and a clm `train_one_batch` under the profiler
  show each named span the expected number of times, clm's host Adam on its
  worker thread with its batch's number, and return the bits they return
  without it.
- `ClmContext.needed_rows` and `fetched_rows` equal a hand count from the
  filters' ids, with retention on and off, on the host path and under
  --pinned_host; on the host path the batch's `h2d_bytes` are 192 bytes a
  fetched row and the uploaded maps.
"""

import json
import tracemalloc
from collections import Counter

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from clm_gs_tpu_torch import convert, optim as toptim
from clm_gs_tpu_torch.optim import AdamConfig
from clm_gs_tpu_torch.strategies import clm_offload as t_clm
from clm_gs_tpu_torch.strategies import no_offload as t_no_offload
from clm_gs_tpu_torch.strategies import offload_common as t_oc
from clm_gs_tpu_torch.utils import timer as T
from tests.test_torch_naive import T_BG, T_LRS, _cams
from tests.test_torch_pinned import _start
from tests.test_torch_train_step import _inputs
from tests.test_train_synthetic import H, W

torch.set_num_threads(1)

CPU = [torch.profiler.ProfilerActivity.CPU]


def _ranges(prof, tmp_path):
    """The trace's ranges: [(name, start, end, thread, arguments)]."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [(e["name"], e["ts"], e["ts"] + e["dur"], e["tid"],
             e["args"].get("Concrete Inputs"))
            for e in events if e.get("cat") == "user_annotation"]


def _within(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.mark.parametrize("enabled", [False, True])
def test_timer_spans_are_nested_ranges(enabled, tmp_path):
    tm = T.Timer(enabled=enabled)
    with torch.profiler.profile(activities=CPU, record_shapes=True) as prof:
        for _ in range(2):
            with tm.batch_span("a.batch"):
                tm.start("a.outer")
                with tm.span("a.inner", 7, 9):
                    torch.ones(4).sum()
                tm.stop("a.outer")
    r = _ranges(prof, tmp_path)
    by = {}
    for x in r:
        by.setdefault(x[0], []).append(x)
    assert {k: len(v) for k, v in by.items()} == {"a.batch": 2, "a.outer": 2, "a.inner": 2}
    for k in range(2):
        assert _within(by["a.outer"][k], by["a.batch"][k])
        assert _within(by["a.inner"][k], by["a.outer"][k])
        assert by["a.inner"][k][4] == ["7", "9"]
    assert sorted(x[4] for x in by["a.batch"]) == [["1"], ["2"]]
    assert tm.batch == 2
    if enabled:
        assert dict(tm.counts) == {"a.batch": 2, "a.outer": 2, "a.inner": 2}
    else:
        assert not tm.sums and not tm.counts


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func)
        return func(*args, **(kwargs or {}))


def test_span_edges_off_do_nothing(monkeypatch):
    """No profiler, Timer disabled: no range is opened (the calls into the
    profiler counted), no drain, no tensor op, and no object that outlives
    its edge."""
    calls = Counter()

    def count(name):
        def f(*args, **kwargs):
            calls[name] += 1
        return f

    monkeypatch.setattr(torch._C._autograd, "_record_function_with_args_enter",
                        count("enter"))
    monkeypatch.setattr(torch._C._autograd, "_record_function_with_args_exit",
                        count("exit"))
    monkeypatch.setattr(torch.profiler, "record_function", count("record_function"))
    monkeypatch.setattr(T, "drain", count("drain"))
    x = torch.ones(3)
    tm = T.Timer(enabled=False)

    def edges():
        for _ in range(200):
            tm.start("k", sync=x)
            tm.stop("k", sync=x)
            with tm.span("s", 5):
                pass
            with tm.batch_span("b"):
                pass
            with T.OFF.span("o"):
                pass

    ops = _Ops()
    with ops:
        edges()
    assert not calls and not ops.ops
    assert tm.batch == 0 and not tm.sums and not tm._range_open
    tracemalloc.start()
    try:
        edges()  # what a first traced pass leaves (the tracer's own tables)
        base, _ = tracemalloc.get_traced_memory()
        tracemalloc.reset_peak()
        edges()
        current, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    # 2,000 span edges keep nothing (an object kept per edge would be 32 kB
    # at least), and only a few of the interpreter's objects (a bound
    # method, an argument tuple) live at once
    assert current - base < 256 and peak - base < 2048


def test_enabled_timer_sums_counts_and_drains(monkeypatch):
    drained = []
    monkeypatch.setattr(T, "drain", drained.append)
    x = torch.ones(3)
    tm = T.Timer(enabled=True)
    for _ in range(3):
        tm.start("k", sync=x)
        tm.stop("k", sync="y")
        with tm.span("s"):
            pass
    tm.stop("never started")
    assert dict(tm.counts) == {"k": 3, "s": 3}
    assert set(tm.sums) == {"k", "s"} and all(v >= 0 for v in tm.sums.values())
    assert [id(d) for d in drained] == [id(d) for d in [x, "y", None, None] * 3]
    assert "k: sum" in tm.report()


def _count(r, tid=None):
    return Counter(n for n, _, _, t, _ in r if tid is None or t == tid)


def _no_offload_step():
    state_np, opt_np, gts = _inputs()
    state = convert.state_from_numpy(state_np, device="cpu")
    opt = toptim.init_adam(state.params)
    state, opt, out = t_no_offload.train_step(
        state, opt, _cams(), torch.from_numpy(gts), 3, T_LRS, AdamConfig(), T_BG, W, H)
    return [t.clone() for t in state.params.astuple() + opt.mu.astuple()] + [out.losses]


def test_no_offload_step_spans(tmp_path):
    plain = _no_offload_step()
    with torch.profiler.profile(activities=CPU) as prof:
        traced = _no_offload_step()
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)
    n = _count(_ranges(prof, tmp_path))
    want = {"step.batch": 1, "render.project": 4, "render.sh": 4, "render.rasterize": 4,
            "render.loss": 4, "render.backward": 4, "step.stats": 5, "step.adam": 1}
    assert {k: n[k] for k in want} == want


def _clm_batch(pinned=False, retention=True, timers=None):
    state_np, opt_np, gts = _inputs()
    cfg, state, opt, ctx = _start(state_np, opt_np, pinned, retention)
    steps = []
    real = ctx.adam.sparse_step

    def sparse_step(*args):
        steps.append(len(args[2]))
        return real(*args)

    ctx.adam.sparse_step = sparse_step
    try:
        state, opt, ctx, out = t_clm.train_one_batch(
            state, opt, ctx, _cams(), torch.from_numpy(gts), 3, T_LRS, AdamConfig(),
            T_BG, W, H, cfg, timers=timers)
    finally:
        ctx.close()
    res = [t.clone() for t in state.params.astuple()[:4] + opt.mu.astuple()[:4]]
    res += [out.losses, ctx.sh_host.clone(), ctx.adam.exp_avg.clone()]
    return res, steps


def test_clm_batch_spans(tmp_path):
    """The host Adam's ranges are on the worker thread: this torch records a
    range on a thread the profiler did not start on only with
    `profile_all_threads` (as the CLI's --profile sets it)."""
    plain, _ = _clm_batch()
    tm = T.Timer(enabled=False)
    cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with torch.profiler.profile(activities=CPU, record_shapes=True,
                                experimental_config=cfg) as prof:
        traced, steps = _clm_batch(timers=tm)
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)
    r = _ranges(prof, tmp_path)
    root = next(x for x in r if x[0] == "clm.batch")
    main = _count(r, root[3])
    want = {"clm.batch": 1, "clm.filters": 1, "clm.filters.project": 1,
            "clm.filters.readback": 2, "clm.order": 1, "clm.fetch_h2d": 1,
            "clm.micro": 4, "render.project": 4, "render.sh": 4, "render.rasterize": 4,
            "render.loss": 4, "render.backward": 4, "clm.accumulate": 4,
            "clm.advance": 3, "clm.advance.transition": 3, "clm.advance.fetch": 3,
            "clm.advance.rows": 3, "clm.d2h_scatter": 3, "clm.adam": 1, "clm.tail": 1}
    assert {k: main[k] for k in want} == want and main["clm.host_adam"] == 0
    adam = [x for x in r if x[0] == "clm.host_adam"]
    assert len(adam) == len(steps) > 0
    assert all(x[3] != root[3] and _within(x, root) for x in adam)
    assert root[4] == ["1"]
    assert sorted(x[4] for x in adam) == sorted([["1", str(n)] for n in steps])
    for name in want:  # every range of the main thread lies in the batch's
        assert all(_within(x, root) for x in r if x[0] == name)


def _hand_count(pinned, retention):
    """(needed, fetched, maps bytes) of the batch by hand: each camera's
    visible ids from the filters, in the batch's camera order."""
    state_np, opt_np, _ = _inputs()
    cfg, state, _, ctx = _start(state_np, opt_np, pinned, retention)
    try:
        F, ids_host, order, *_ = t_clm._plan(state, ctx, _cams(), W, H, cfg)
    finally:
        ctx.close()
    p = state.params
    again = t_oc.calculate_filters(p.xyz, p.quat, p.log_scale, state.alive,
                                   _cams().viewmats, _cams().Ks, W, H,
                                   cfg.model.radius_clip)
    sets = [set(again.ids[int(c)].tolist()) for c in order]
    assert [set(ids_host[int(c)].tolist()) for c in order] == sets
    needed = sum(len(s) for s in sets)
    if not retention:
        return needed, needed, 0
    fetched = len(sets[0]) + sum(len(b - a) for a, b in zip(sets, sets[1:]))
    maps = sum(4 * (2 * len(b) + len(a - b)) for a, b in zip(sets, sets[1:]))
    return needed, fetched, maps


@pytest.mark.parametrize("retention", [True, False])
@pytest.mark.parametrize("pinned", [False, True])
def test_retention_counters(pinned, retention):
    needed, fetched, maps = _hand_count(pinned, retention)
    assert 0 < fetched <= needed
    if retention:
        assert fetched < needed  # the tiny scene's cameras share rows
    state_np, opt_np, gts = _inputs()
    cfg, state, opt, ctx = _start(state_np, opt_np, pinned, retention)
    try:
        h2d = ctx.h2d_bytes
        state, opt, ctx, _ = t_clm.train_one_batch(
            state, opt, ctx, _cams(), torch.from_numpy(gts), 3, T_LRS, AdamConfig(),
            T_BG, W, H, cfg)
    finally:
        ctx.close()
    assert (ctx.needed_rows, ctx.fetched_rows) == (needed, fetched)
    if not pinned:
        assert ctx.h2d_bytes - h2d == 192 * fetched + maps
    assert np.isclose(1 - ctx.fetched_rows / ctx.needed_rows, 1 - fetched / needed)
