"""The card's time in the projection and SH colours of no_offload's
cameras, ms a traced batch: the kernels, copies and memsets launched within
the spans `render.project` and `render.sh` (`strategies/base.py`
`rasterize_inputs`; `perfbench/attribution.py`)."""

from perfbench import attribution

UNIT = "ms/batch"
CAPTURES = (attribution.CAPTURE,)


def read(ctx):
    return attribution.per_batch_ms(ctx, ("render.project", "render.sh"))
