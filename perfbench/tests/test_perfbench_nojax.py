"""Nothing the benchmark runs loads JAX or the JAX package: a cell's import
path and a small run with the reference, in a fresh process, checked by
top-level module names compared whole; and no file of the reference imports
the port."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
PERFBENCH = ROOT / "perfbench"

SCRIPT = """
import sys
sys.path.insert(0, {root!r})
from perfbench import harness
from perfbench.tests import small
cfg, trf = small.cell("bicycle-6m.clm")
r = harness.run_cell("bicycle-6m.clm", 5, 0.2, False, "cpu", config=cfg, traffic=trf)
print(sorted({{m.split(".")[0] for m in sys.modules}}))
print(harness.forbidden_modules())
"""


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_a_run_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", SCRIPT.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded, forbidden = out.stdout.strip().splitlines()[-2:]
    tops = set(eval(loaded))
    assert "clm_gs_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "clm_gs_tpu"}
    assert forbidden == "[]"


@pytest.mark.parametrize("path", sorted((PERFBENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & {"clm_gs_tpu_torch", "clm_gs_tpu", "jax", "jaxlib", "flax"}


def test_no_file_of_the_benchmark_imports_jax():
    for path in PERFBENCH.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"clm_gs_tpu", "jax", "jaxlib", "flax"}, path
