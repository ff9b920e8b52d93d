"""The command refuses to run where it cannot: without enough cards, and in
a directory that holds only BENCHMARK.json and the benchmark's files. It
prints no result line then."""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
ARGS = ["--workload", "bicycle-6m.clm", "--seed", "3000000000", "--seconds", "1",
        "--trace", "0"]


def _run(cwd):
    return subprocess.run([sys.executable, "perfbench/run.py", *ARGS], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def _no_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")


def test_without_a_card():
    _no_card()
    out = _run(ROOT)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA" in out.stderr


def test_alone_without_the_program(tmp_path):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout == ""
