"""utils/trace_clm.py: the card's idle time within each span of a Chrome
trace (`read`), and the Timer's spans as the profiler ranges it reads.

`read` is held to hand-counted intervals: device events on two streams that
overlap each other and straddle the span edges, a span with no device
event, and the host's own events, which must not count as the card's.
"""

import json

import pytest
import torch

from clm_gs_tpu_torch.utils import trace_clm
from clm_gs_tpu_torch.utils.timer import Timer


def _event(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": tid}


def _trace(tmp_path, events, wrap=True):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events} if wrap else events))
    return str(path)


@pytest.mark.parametrize("wrap", [True, False])
def test_read_counts_idle_time_within_spans(tmp_path, wrap):
    events = [
        _event("train_step", "user_annotation", 0, 1000),
        _event("clm.d2h_scatter", "user_annotation", 100, 200),  # 100..300
        _event("clm.d2h_scatter", "user_annotation", 600, 100),  # 600..700, idle
        _event("clm.micro", "user_annotation", 300, 300),        # 300..600
        # the card: [50, 150) and [120, 180) on two streams, [250, 450)
        _event("k1", "kernel", 50, 100, tid=7),
        _event("k2", "kernel", 120, 60, tid=8),
        _event("Memcpy DtoH", "gpu_memcpy", 250, 200, tid=9),
        _event("Memset", "gpu_memset", 900, 50, tid=7),
        # host events do not count as the card's
        _event("aten::add", "cpu_op", 0, 1000),
        {"ph": "i", "name": "marker", "ts": 10},
    ]
    got = trace_clm.read(_trace(tmp_path, events, wrap))
    s = got["spans"]
    assert got["device_events"] == 4
    # d2h_scatter: [100, 300) meets [100, 180) and [250, 300): 130 busy
    assert s["clm.d2h_scatter"]["calls"] == 2
    assert s["clm.d2h_scatter"]["host_ms"] == pytest.approx(0.3)
    assert s["clm.d2h_scatter"]["card_busy_ms"] == pytest.approx(0.13)
    assert s["clm.d2h_scatter"]["card_idle_ms"] == pytest.approx(0.17)
    # micro: [300, 600) meets [300, 450)
    assert s["clm.micro"]["card_busy_ms"] == pytest.approx(0.15)
    # the window: busy [50, 180) + [250, 450) + [900, 950) within [0, 1000)
    assert got["window"]["card_busy_ms"] == pytest.approx(0.38)
    assert got["window_idle_share"] == pytest.approx(0.62)
    assert "aten::add" not in s


def test_read_selects_spans(tmp_path):
    events = [_event("clm.advance", "user_annotation", 0, 10),
              _event("clm.order", "user_annotation", 10, 10)]
    got = trace_clm.read(_trace(tmp_path, events), spans={"clm.order"})
    assert list(got["spans"]) == ["clm.order"] and got["window"] is None
    assert got["spans"]["clm.order"]["card_idle_ms"] == pytest.approx(0.01)


def test_timer_spans_become_profiler_ranges(tmp_path):
    """The Timer itself opens ranges under a profiler: an enabled timer's
    spans and a disabled timer's alike (nested ones too), which `read` finds
    in the exported trace; outside a profiler, none."""
    on, off = Timer(enabled=True), Timer(enabled=False)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        on.start("train_step")
        on.start("clm.micro")
        torch.ones(4).sum()
        on.stop("clm.micro")
        off.start("clm.order")
        off.stop("clm.order")
        on.stop("train_step")
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    spans = trace_clm.read(str(path))["spans"]
    assert {k: v["calls"] for k, v in spans.items()} == {
        "train_step": 1, "clm.micro": 1, "clm.order": 1}
    assert on.counts == {"train_step": 1, "clm.micro": 1} and not off.counts
    on.start("after")
    off.start("after")
    assert not on._range_open and not off._range_open
    on.stop("after")
    off.stop("after")
