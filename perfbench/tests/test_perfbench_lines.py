"""BENCHMARK.json's metrics fit its cells: each per-layer metric has its
reader and moves an end-to-end metric that every cell it lists reports, each
cell reports `setup_s`, another end-to-end metric and a per-layer metric,
an untraced run's line carries exactly the cell's end-to-end metrics, and
the line of either run gives every key of `device` that the contract asks
for."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench import harness  # noqa: E402
from perfbench.tests import small  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def _e2e(cell):
    return {m["name"] for m in BENCH["end_to_end"] if harness.applies(m, cell)}


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_per_layer_moves_what_its_cells_report(metric):
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    assert (ROOT / "perfbench" / "metrics" / f"{metric}.py").is_file()
    assert harness.metric_module(metric).UNIT == m["unit"]
    for cell in m.get("workloads", CELLS):
        assert m["moves"] in _e2e(cell), (metric, cell)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_enough(cell):
    e2e = _e2e(cell)
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(harness.applies(m, cell) for m in BENCH["per_layer"])


@pytest.mark.parametrize("cell", sorted(small.CELLS))
def test_untraced_line_has_the_cells_metrics(cell):
    cfg, trf = small.cell(cell)
    r = harness.run_cell(cell, 77, 0.2, False, "cpu", config=cfg, traffic=trf)
    assert set(r["metrics"]) == _e2e(cell)
    assert all(v["value"] >= 0 for v in r["metrics"].values())
    assert "memory_peak_bytes" in r["device"]


@pytest.mark.parametrize("cell", sorted(small.CELLS))
def test_traced_line_has_the_device_keys(cell):
    cfg, trf = small.cell(cell)
    r = harness.run_cell(cell, 78, 0.2, True, "cpu", config=cfg, traffic=trf)
    assert {"memory_peak_bytes", "busy_s", "window_s"} <= set(r["device"])
    assert 0 <= r["device"]["busy_s"] <= r["device"]["window_s"]
