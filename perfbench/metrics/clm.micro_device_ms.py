"""The card's time in clm's micro step, ms a traced batch: the kernels,
copies and memsets launched within the span `clm.micro`
(`offload_common.clm_fused_step`: the render, loss, backward and
accumulation of each camera; `perfbench/attribution.py`)."""

from perfbench import attribution

UNIT = "ms/batch"
CAPTURES = (attribution.CAPTURE,)


def read(ctx):
    return attribution.per_batch_ms(ctx, ("clm.micro",))
