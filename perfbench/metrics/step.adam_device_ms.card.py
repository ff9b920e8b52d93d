"""The card's time in no_offload's Adam over every row, ms a traced batch:
the kernels, copies and memsets launched within the span `step.adam`
(`strategies/no_offload.py` `train_step` over `optim.py` `adam_step`;
`perfbench/attribution.py`)."""

from perfbench import attribution

UNIT = "ms/batch"
CAPTURES = (attribution.CAPTURE,)


def read(ctx):
    return attribution.per_batch_ms(ctx, ("step.adam",))
