"""`correct` against planted faults and the control, at small sizes on the
CPU. A run skips the look for a card and otherwise runs whole: set-up, the
window, the reference and the check. It comes out correct as it stands,
and not correct with each fault a cell can have planted in the program
(faults.py): a step that returns its state unchanged, half of the batch
left out with the mean over the rest, an answer altered where it is
produced. (One card holds everything: there is no exchange between chips to
leave out.) The control, the reference in bfloat16 put in the program's
place, fails the cell's limits too."""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from perfbench import check, faults, harness  # noqa: E402
from perfbench.tests import small  # noqa: E402

CELLS = sorted(small.CELLS)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [None] + sorted(faults.FAULTS))
def test_fault_is_caught(cell, fault, monkeypatch):
    cfg, trf = small.cell(cell)
    if fault is not None:
        start = harness.start

        def broken(*args):
            prog, feed, step = start(*args)
            faults.plant(fault, prog)
            return prog, feed, step

        monkeypatch.setattr(harness, "start", broken)
    r = harness.run_cell(cell, 31, 0.3, False, "cpu", config=cfg, traffic=trf)
    assert r["correct"] is (fault is None), r["checks"]
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell):
    cfg, trf = small.cell(cell)
    scene = harness.Scene(cfg, 32, "cpu")
    prog, feed, step = harness.start(scene, trf, 32, "cpu")
    seen = harness.check_steps(prog, step, scene.first, trf["check_steps"])
    prog.close()
    ref = harness.reference(scene, seen, feed.bsz, trf, "cpu")
    low = harness.reference(scene, seen, feed.bsz, trf, "cpu", torch.bfloat16)
    _, ok = check.judge(check.readings(low, ref), check.limits(cell))
    assert not ok
