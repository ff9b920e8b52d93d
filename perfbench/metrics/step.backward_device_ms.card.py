"""The card's time in no_offload's backward passes, ms a traced batch: the
kernels, copies and memsets launched, from any thread, while the main
thread was within the span `render.backward` (`strategies/no_offload.py`
`batch_grads`; `perfbench/attribution.py`)."""

from perfbench import attribution

UNIT = "ms/batch"
CAPTURES = (attribution.CAPTURE,)


def read(ctx):
    return attribution.per_batch_ms(ctx, ("render.backward",))
