"""`step_mfu` in the cells that keep every row on the card, where it moves
`train_mpix_s.card`: the same reader (metrics/step_mfu.py)."""

from perfbench.harness import metric_module

_base = metric_module("step_mfu")
UNIT, CAPTURES, read = _base.UNIT, _base.CAPTURES, _base.read
