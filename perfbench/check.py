"""What decides `correct`: the program's first steps against the plain
reference's from the same start and inputs.

Three numbers, each a gap of norms (not the norm of a difference), taken by
the worst leaf (xyz, opacity, log_scale, quat, sh):
- `loss_gap`: the largest relative gap of a step's batch-mean loss;
- `grad_gap`: the gap of the first step's gradient as the optimizer got it
  (the program's first moment after one step over 1 - beta1), against the
  reference's norm of that leaf or of the median leaf, whichever is larger;
- `change_gap`: the same of the parameters' change after the check's last
  step, leaving out the leaves whose reference gradient is under a
  thousandth of the median leaf's (they move by round-off alone).
Each number's limit is in limits/<cell>.json.
"""

from __future__ import annotations

import json
import math
import statistics
from pathlib import Path

from perfbench.reference.gs3d import LEAVES, adam_constants

HERE = Path(__file__).resolve().parent
NORM_ROWS = 1 << 22
ZERO_GRAD = 1e-3


def norm(x, y=None, device=None) -> float:
    """The float64 norm of x (or of x - y), NORM_ROWS rows at a time on
    `device` (x's own by default)."""
    device = device or (y.device if y is not None else x.device)
    acc = 0.0
    for lo in range(0, x.shape[0], NORM_ROWS):
        a = x[lo:lo + NORM_ROWS].to(device).double()
        if y is not None:
            a = a - y[lo:lo + NORM_ROWS].to(device).double()
        acc += float((a * a).sum())
    return math.sqrt(acc)


class ProgramReadings:
    """The program's side, read as its check steps run: each step's cameras,
    rates and mean loss, the first step's gradient norms and the change
    after the last."""

    def __init__(self, prog, p0: dict, n_steps: int):
        self.prog, self.p0, self.n_steps = prog, p0, n_steps
        self.steps, self.losses = [], []
        self.grad, self.change = {}, {}
        self.b1 = adam_constants(prog.bsz)[0]

    def after_step(self, t: int, ids, rates, out):
        dev = self.p0["xyz"].device
        self.steps.append((ids, rates))
        self.losses.append(float(out.losses.double().mean()))
        if t == 1:
            self.grad = {k: norm(self.prog.leaf(k, moment=True), device=dev) / (1 - self.b1)
                         for k in LEAVES}
        if t == self.n_steps:
            self.change = {k: norm(self.prog.leaf(k), self.p0[k]) for k in LEAVES}
            self.prog = self.p0 = None

    def result(self) -> dict:
        return {"losses": self.losses, "grad": self.grad, "change": self.change}


def _leaf_gap(prog: dict, ref: dict, leaves) -> float:
    med = statistics.median(ref[k] for k in leaves)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in leaves)


def readings(prog: dict, ref: dict) -> dict:
    """{"loss_gap", "grad_gap", "change_gap"} of the program's readings
    against the reference's (module docstring)."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"]))
    g_med = statistics.median(ref["grad"][k] for k in LEAVES)
    moving = [k for k in LEAVES if ref["grad"][k] >= ZERO_GRAD * g_med]
    return {"loss_gap": loss, "grad_gap": _leaf_gap(prog["grad"], ref["grad"], LEAVES),
            "change_gap": _leaf_gap(prog["change"], ref["change"], moving)}


def limits(cell: str):
    """The cell's limits, or None where it has none yet."""
    path = HERE / "limits" / f"{cell}.json"
    if not path.exists():
        return None
    with open(path) as f:
        return json.load(f)["limits"]


def judge(values: dict, lims) -> tuple:
    """({number: {"value", "limit"}}, correct): every number finite and at
    or under its limit; no limits, not correct."""
    checks = {k: {"value": v, "limit": (lims or {}).get(k)} for k, v in values.items()}
    ok = lims is not None and all(
        c["limit"] is not None and math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())
    return checks, ok

