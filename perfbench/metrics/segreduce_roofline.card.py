"""`segreduce_roofline` in the cells that keep every row on the card, where it moves
`train_mpix_s.card`: the same reader (metrics/segreduce_roofline.py)."""

from perfbench.harness import metric_module

_base = metric_module("segreduce_roofline")
UNIT, CAPTURES, read = _base.UNIT, _base.CAPTURES, _base.read
