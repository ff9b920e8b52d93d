"""A later change adds a configuration, a traffic mix, a cell and a
per-layer metric as files of their own and entries in BENCHMARK.json, and
the harness finds them by name with no existing file edited."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

SCRIPT = """
import json, sys
sys.path[:0] = [{tmp!r}, {root!r}]
import perfbench
assert perfbench.__file__.startswith({tmp!r}), perfbench.__file__
from perfbench import harness
bench = harness.load_json({tmp!r} + "/BENCHMARK.json")
cell, cfg, trf = harness.load_cell("tiny-city.clm-bsz2")
assert cfg["name"] == "tiny-city" and trf["flags"][0] == "--clm_offload"
r = harness.run_cell("tiny-city.clm-bsz2", 3, 0.2, True, "cpu", config=cfg, traffic=trf,
                     bench=bench)
print(json.dumps(r))
"""


def test_added_files_are_found(tmp_path):
    pb = tmp_path / "perfbench"
    shutil.copytree(ROOT / "perfbench", pb,
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p.relative_to(tmp_path): p.read_bytes() for p in pb.rglob("*") if p.is_file()}

    sys.path.insert(0, str(ROOT))
    from perfbench.tests import small

    cfg = small.config("bigcity-25m")
    cfg["name"] = "tiny-city"
    (pb / "configs" / "tiny-city.json").write_text(json.dumps(cfg))
    (pb / "traffic" / "clm-bsz2.json").write_text(json.dumps(small.traffic("clm-bsz64-sparse")))
    (pb / "limits" / "tiny-city.clm-bsz2.json").write_text(json.dumps(
        {"limits": {"loss_gap": 1e-4, "grad_gap": 3e-4, "change_gap": 3e-4}}))
    (pb / "metrics" / "tiny.rows_per_batch.py").write_text(
        'UNIT = "rows"\n\n\ndef read(ctx):\n    return float(ctx["batches"][0]["updated_rows"])\n')
    bench["configs"].append({"name": "tiny-city", "source": "a test", "file":
                             "perfbench/configs/tiny-city.json", "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny-city.clm-bsz2", "config": "tiny-city",
                               "traffic": "clm-bsz2", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "tiny.rows_per_batch", "unit": "rows",
                               "better": "higher", "source": "program_counter",
                               "layer": "a test", "moves": "train_mpix_s",
                               "workloads": ["tiny-city.clm-bsz2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    out = subprocess.run([sys.executable, "-c", SCRIPT.format(tmp=str(tmp_path), root=str(ROOT))],
                         capture_output=True, text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] is True
    assert r["metrics"]["tiny.rows_per_batch"]["value"] > 0
    assert "clm.h2d_mb" not in r["metrics"]  # listed for other cells only
    after = {p.relative_to(tmp_path): p.read_bytes() for p in pb.rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items() if "__pycache__" not in k.parts)
