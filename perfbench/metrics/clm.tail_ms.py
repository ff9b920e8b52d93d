"""The tail of a clm batch (`strategies/clm_offload.py` `train_one_batch`
after the card Adam is queued: the wait for the card, the last drain, the
host Adam's futures), ms a batch: its span `clm.tail` over the Timer-on
batches."""

from perfbench.spans import per_batch_ms

UNIT = "ms/batch"


def read(ctx):
    return per_batch_ms(ctx, ("clm.tail",))
