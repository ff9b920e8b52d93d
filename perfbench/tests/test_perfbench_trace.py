"""The trace reading on a synthetic Chrome trace: busy time as the union of
device intervals, the idle gaps attributed to the innermost range on the
main thread, kernel times in launch order."""

import json
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from perfbench import trace  # noqa: E402


def _x(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid, "pid": 1}


def test_union_and_covered():
    u = trace._union([(0, 2), (1, 3), (5, 6), (6, 7)])
    assert u == [[0, 3], [5, 7]]
    assert trace._covered(u, 2, 6, [0, 5]) == 2
    assert trace._gaps(u, -1, 9) == [(-1, 0), (3, 5), (7, 9)]


def test_read(tmp_path):
    ev = [
        _x("bench.window", "user_annotation", 0, 100),
        _x("clm.filters", "user_annotation", 0, 40),
        _x("layer.binning", "user_annotation", 10, 10),
        _x("clm.micro", "user_annotation", 50, 50),
        _x("other thread", "user_annotation", 0, 100, tid=2),
        _x("kern_a(int)", "kernel", 5, 5),
        _x("kern_b", "kernel", 30, 10),
        _x("kern_a(int)", "kernel", 60, 20),
        _x("memcpy", "gpu_memcpy", 70, 20),
        _x("kern_a(int)", "kernel", 150, 20),  # after the window
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    r = trace.read(path)
    assert r["window_s"] == pytest.approx(100e-6)
    # busy: [5,10] + [30,40] + [60,90]
    assert r["busy_s"] == pytest.approx(45e-6)
    # idle: [0,5] filters, [10,30] binning midpoint 20, [40,60] midpoint 50
    # clm.micro, [90,100] clm.micro
    assert r["idle_by_range"] == pytest.approx(
        {"clm.filters": 5e-6, "layer.binning": 20e-6, "clm.micro": 30e-6})
    assert trace.kernel_times(r, "kern_a") == pytest.approx([5e-6, 20e-6])
    b = trace.breakdown(r)
    assert b["device_ops"][0][0] == "kern_a(int)"
    assert b["idle_gaps"][0] == ["clm.micro", pytest.approx(30e-6)]


def test_innermost_nested():
    ranges = [(0, 10, "a"), (2, 5, "b"), (3, 4, "c"), (6, 8, "d")]
    assert trace.innermost(ranges, [1, 3.5, 4.5, 7, 9, 11]) == ["a", "c", "b", "d", "a", None]
