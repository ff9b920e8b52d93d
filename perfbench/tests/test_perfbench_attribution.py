"""The card's time by the span that launched it (`perfbench/attribution.py`)
on a hand-made Chrome trace, and the new per-layer metrics on the small CPU
cells: the program's spans and counters read there, the device metrics
only on a card, and nothing raised on a program without them."""

import json
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench import attribution, harness  # noqa: E402
from perfbench.tests import small  # noqa: E402

MAIN, AUTOGRAD, STREAM = 1, 2, 7


def _x(name, cat, ts, dur, tid=MAIN, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _launch(corr, ts, tid=MAIN, cat="cuda_runtime"):
    return _x("cudaLaunchKernel", cat, ts, 1, tid=tid, corr=corr)


def _read(tmp_path, events):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return attribution.read(path)


def test_attribution(tmp_path):
    ev = [
        _x("bench.window", "user_annotation", 0, 1000),
        _x("step.batch", "user_annotation", 10, 900),
        _x("render.project", "user_annotation", 20, 100),
        _x("layer.projection", "user_annotation", 40, 50),
        _x("render.backward", "user_annotation", 200, 100),
        _x("autograd thread's own", "user_annotation", 200, 100, tid=AUTOGRAD),
        # launched in render.project, outside its child: 5 us
        _launch(1, 25), _x("k1", "kernel", 500, 5, tid=STREAM, corr=1),
        # in the child layer.projection: 7 us, runs long after its launch
        _launch(2, 50), _x("k2", "kernel", 600, 7, tid=STREAM, corr=2),
        # a memcpy launched in the child, by the driver API: 11 us
        _launch(3, 60, cat="cuda_driver"),
        _x("Memcpy HtoD", "gpu_memcpy", 610, 11, tid=STREAM, corr=3),
        # from autograd's thread while the main thread is in render.backward
        _launch(4, 250, tid=AUTOGRAD), _x("k4", "kernel", 700, 13, tid=STREAM, corr=4),
        # in step.batch only: 17 us
        _launch(5, 400), _x("k5", "gpu_memset", 720, 17, tid=STREAM, corr=5),
        # outside every range, inside the window: left out
        _launch(6, 950), _x("k6", "kernel", 960, 19, tid=STREAM, corr=6),
        # launched before the window: left out
        _launch(7, -5), _x("k7", "kernel", 5, 23, tid=STREAM, corr=7),
        # a device event without its launch in the trace: left out
        _x("k8", "kernel", 800, 29, tid=STREAM, corr=8),
    ]
    r = _read(tmp_path, ev)
    us = 1e-6
    assert r["self_s"] == pytest.approx({"render.project": 5 * us, "layer.projection": 18 * us,
                                         "render.backward": 13 * us, "step.batch": 17 * us})
    assert r["within_s"] == pytest.approx({
        "step.batch": 53 * us, "render.project": 23 * us, "layer.projection": 18 * us,
        "render.backward": 13 * us})
    assert r["launched_s"] == pytest.approx(72 * us)


def test_attribution_needs_the_window(tmp_path):
    with pytest.raises(RuntimeError, match="window"):
        _read(tmp_path, [_x("step.batch", "user_annotation", 0, 10)])


def _ctx(records, batches=2):
    return {"records": records, "batches": [{}] * batches,
            "timer": {"sums": {}, "counts": {}}, "timer_batches": batches, "counters": None}


@pytest.mark.parametrize("metric,names", [
    ("clm.micro_device_ms", ("clm.micro",)),
    ("step.render_device_ms.card", ("render.project", "render.sh")),
    ("step.backward_device_ms.card", ("render.backward",)),
    ("step.adam_device_ms.card", ("step.adam",)),
])
def test_device_readers(metric, names):
    mod = harness.metric_module(metric)
    assert attribution.CAPTURE in mod.CAPTURES
    within = {n: 0.003 * (k + 1) for k, n in enumerate(names)}
    rec = {"within_s": dict(within, other=1.0), "self_s": {}, "launched_s": 2.0}
    want = sum(within.values()) / 2 * 1e3
    assert mod.read(_ctx({attribution.KEY: [rec]})) == pytest.approx(want)
    # a program without the spans, a trace without device events, no trace
    assert mod.read(_ctx({attribution.KEY: [dict(rec, within_s={"other": 1.0})]})) is None
    assert mod.read(_ctx({attribution.KEY: [dict(rec, launched_s=0.0)]})) is None
    assert mod.read(_ctx({})) is None


def test_retained_reader():
    mod = harness.metric_module("clm.retained_pct")
    (_, _, key, record), = mod.CAPTURES
    ctx = SimpleNamespace(needed_rows=400, fetched_rows=100)
    assert record((), {}, (None, None, ctx, None)) == (400, 100)
    assert record((), {}, (None, None, SimpleNamespace(), None)) is None
    assert mod.read(_ctx({key: [(100, 90), (400, 100)]})) == pytest.approx(75.0)
    assert mod.read(_ctx({})) is None


@pytest.mark.parametrize("cell", sorted(small.CELLS))
def test_new_metrics_on_small_cells(cell):
    """On the CPU the program's spans and counters read; the device metrics
    read only on a card, and are left out of the line here."""
    cfg, trf = small.cell(cell)
    r = harness.run_cell(cell, 2147483901, 0.2, True, "cpu", config=cfg, traffic=trf)
    m = r["metrics"]
    device = {"clm.micro_device_ms", "step.render_device_ms.card",
              "step.backward_device_ms.card", "step.adam_device_ms.card"}
    assert not device & set(m)
    if cell.endswith(".clm"):
        assert m["clm.tail_ms"]["value"] > 0
        assert 0 <= m["clm.retained_pct"]["value"] < 100
    else:
        assert "clm.tail_ms" not in m and "clm.retained_pct" not in m
