"""Rubble-4K-28M's cell and the pinned BigCity cell of the benchmark
(`perfbench/`), and the span and counter their metrics read.

- Both cells, cut to a small size, run through the benchmark's harness on
  the CPU and are `correct` against the plain reference within the cells'
  own limits: `rubble4k-28m` at 3,000 rows, 16 cameras of 200x150 (partial
  tiles on both axes), bsz 2 under its dense clm traffic, and BigCity's
  small city under `--pinned_host`. The harness refuses a process that has
  a JAX package loaded, and this directory's conftest loads one, so each
  runs in a subprocess.
- The harness finds the new cells' configuration, traffic and limits by
  name in a copy of `perfbench/`, takes the Rubble camera spec, and writes
  no file of the copy.
- `ops/rasterize.py` `rasterize` opens the span `render.bin` around the
  binning, nested in `render.rasterize`, from `render_one_cam` and from
  `render_cams`.
- `ClmContext.adam_rows` counts the rows the host Adam stepped: every live
  row once a batch under dense Adam, the rows some camera saw under
  --sparse_adam.
- The readers `render.bin_device_ms` and `host.adam_ns_per_row` give None
  on what a program without the span or the counter leaves, and the value
  on what one with them records.
"""

import json
import shutil
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

from clm_gs_tpu_torch import convert
from clm_gs_tpu_torch.optim import AdamConfig
from clm_gs_tpu_torch.strategies import base as t_base
from clm_gs_tpu_torch.strategies import clm_offload as t_clm
from tests.test_torch_naive import T_BG, T_LRS, _cams
from tests.test_torch_pinned import _start
from tests.test_torch_timer import CPU, _ranges, _within
from tests.test_torch_train_step import _inputs
from tests.test_train_synthetic import H, W

ROOT = Path(__file__).resolve().parents[1]
NEW_CELLS = {"rubble4k-28m.clm": ("rubble4k-28m", "clm-bsz4-50k"),
             "bigcity-25m.clm_pinned": ("bigcity-25m", "clm-bsz64-sparse-pinned")}

SMALL = """
import json, sys
sys.path.insert(0, {root!r})
from perfbench import harness
from perfbench.tests import small

cell = {cell!r}
if cell.startswith("rubble4k"):
    cfg = json.loads(open({root!r} + "/perfbench/configs/rubble4k-28m.json").read())
    cfg["scene"].update(n=3000, extent=8.0, buildings=12)
    cfg["cameras"].update(extent=8.0, elevation=4.6, count=16, width=200, height=150)
    cfg["capacity_granule"] = 1024
else:
    cfg = small.config("bigcity-25m")
trf = small.traffic({traffic!r})
r = harness.run_cell(cell, 3000000019, 0.2, True, "cpu", config=cfg, traffic=trf)
print(json.dumps(r))
"""


@pytest.mark.parametrize("cell", sorted(NEW_CELLS))
def test_small_cell_is_correct(cell):
    """The cell at a small size, traced: `correct` within the cell's limits,
    and the host Adam's rate read from the new counter."""
    out = subprocess.run(
        [sys.executable, "-c", SMALL.format(root=str(ROOT), cell=cell,
                                            traffic=NEW_CELLS[cell][1])],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] is True, r["checks"]
    assert all(c["limit"] is not None for c in r["checks"].values())
    assert r["metrics"]["host.adam_ns_per_row"]["value"] > 0
    # the CPU trace has no device event to attribute
    assert "render.bin_device_ms" not in r["metrics"]


FIND = """
import sys
sys.path[:0] = [{tmp!r}]
import perfbench
assert perfbench.__file__.startswith({tmp!r}), perfbench.__file__
from perfbench import check, harness
from perfbench.cameras import make_cameras
bench = harness.load_json({tmp!r} + "/BENCHMARK.json")
for name, (config, traffic) in {cells!r}.items():
    cell, cfg, trf = harness.load_cell(name, bench)
    assert (cell["config"], cfg["name"], cell["traffic"]) == (config, config, traffic)
    assert trf["flags"][0] == "--clm_offload" and cell["chips"] == 1
    assert set(check.limits(name)) == {{"loss_gap", "grad_gap", "change_gap"}}
cams = make_cameras(harness.load_cell("rubble4k-28m.clm", bench)[1]["cameras"], "cpu")
print(len(cams["train"]), cams["width"], cams["height"], cams["extent"])
"""


def test_harness_takes_the_new_cells(tmp_path):
    """In a copy of perfbench/ and BENCHMARK.json, the harness finds each new
    cell's files by name and builds Rubble's 166 survey cameras (164 train at
    llffhold 83), writing nothing."""
    pb = tmp_path / "perfbench"
    shutil.copytree(ROOT / "perfbench", pb, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    before = {p: p.read_bytes() for p in tmp_path.rglob("*") if p.is_file()}
    # every new cell is served by files of its own
    for name, (config, traffic) in NEW_CELLS.items():
        assert (pb / "limits" / f"{name}.json").is_file()
        assert (pb / "configs" / f"{config}.json").is_file()
        assert (pb / "traffic" / f"{traffic}.json").is_file()
    for metric in ("render.bin_device_ms", "host.adam_ns_per_row"):
        assert (pb / "metrics" / f"{metric}.py").is_file()
    out = subprocess.run(
        [sys.executable, "-c", FIND.format(tmp=str(tmp_path), cells=NEW_CELLS)],
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    n_train, w, h, extent = out.stdout.split()
    assert (int(n_train), int(w), int(h)) == (164, 3840, 2880)
    assert float(extent) > 0
    after = {p: p.read_bytes() for p in tmp_path.rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert after == before


def _render(kind):
    state_np, _, _ = _inputs()
    state = convert.state_from_numpy(state_np, device="cpu")
    cams = _cams()
    campos = cams.camtoworlds[:, :3, 3]
    if kind == "one_cam":
        for b in range(2):
            t_base.render_one_cam(state.params, state.alive, cams.viewmats[b], cams.Ks[b],
                                  campos[b], 3, W, H, T_BG)
    else:
        t_base.render_cams(state.params, state.alive, cams.viewmats[:2], cams.Ks[:2],
                           campos[:2], 3, W, H, T_BG)


@pytest.mark.parametrize("kind", ["one_cam", "cams"])
def test_render_bin_span_nests_in_rasterize(kind, tmp_path):
    with torch.profiler.profile(activities=CPU) as prof:
        _render(kind)
    r = _ranges(prof, tmp_path)
    bins = [x for x in r if x[0] == "render.bin"]
    outer = [x for x in r if x[0] == "render.rasterize"]
    assert len(bins) == 2 and len(outer) == (2 if kind == "one_cam" else 1)
    assert all(any(_within(b, o) for o in outer) for b in bins)


@pytest.mark.parametrize("sparse", [False, True])
def test_adam_rows_counts_the_stepped_rows(sparse):
    state_np, opt_np, gts = _inputs()
    cfg, state, opt, ctx = _start(state_np, opt_np, False, True)
    cfg.aux.sparse_adam = sparse
    try:
        assert ctx.adam_rows == 0
        rows = []
        for _ in range(2):
            state, opt, ctx, out = t_clm.train_one_batch(
                state, opt, ctx, _cams(), torch.from_numpy(gts), 3, T_LRS, AdamConfig(),
                T_BG, W, H, cfg)
            seen = out.visible_any & state.alive
            rows.append(int(seen.sum()) if sparse else int(state.alive.sum()))
            assert ctx.adam_rows == sum(rows)
    finally:
        ctx.close()
    assert 0 < rows[0] <= int(state.alive.sum())
    if sparse:
        assert rows[0] < int(state.alive.sum())  # some live row is seen by no camera


def _reader(name):
    from perfbench import harness

    return harness.metric_module(name)


def test_render_bin_reader():
    from perfbench import attribution

    mod = _reader("render.bin_device_ms")
    assert mod.CAPTURES == (attribution.CAPTURE,)
    rec = {"launched_s": 0.5, "within_s": {"render.rasterize": 0.3, "clm.micro": 0.4}}
    ctx = {"records": {attribution.KEY: [rec]}, "batches": [{}, {}]}
    assert mod.read(ctx) is None  # a program without the span
    rec["within_s"]["render.bin"] = 0.012
    assert mod.read(ctx) == pytest.approx(6.0)  # 12 ms over two batches
    assert mod.read({"records": {}, "batches": [{}]}) is None


def test_host_adam_reader():
    mod = _reader("host.adam_ns_per_row")
    ((module, attr, key, record),) = mod.CAPTURES
    assert (module, attr) == ("clm_gs_tpu_torch.strategies.clm_offload", "train_one_batch")
    old = types.SimpleNamespace(adam_work_s=0.25)  # a context without the counter
    assert record((), {}, (None, None, old, None)) is None
    assert mod.read({"records": {}}) is None
    state_np, opt_np, gts = _inputs()
    cfg, state, opt, ctx = _start(state_np, opt_np, False, True)
    try:
        result = t_clm.train_one_batch(state, opt, ctx, _cams(), torch.from_numpy(gts), 3,
                                       T_LRS, AdamConfig(), T_BG, W, H, cfg)
    finally:
        ctx.close()
    rec = record((), {}, result)
    assert rec == (ctx.adam_work_s, ctx.adam_rows) and ctx.adam_rows > 0
    got = mod.read({"records": {key: [(0.0, 0), rec]}})
    assert got == pytest.approx(ctx.adam_work_s / ctx.adam_rows * 1e9)
