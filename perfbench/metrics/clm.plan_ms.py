"""clm's visibility filters and camera order (`clm_offload._plan`), ms a
batch: its spans `clm.filters` and `clm.order` over the Timer-on batches."""

from perfbench.spans import per_batch_ms

UNIT = "ms/batch"


def read(ctx):
    return per_batch_ms(ctx, ("clm.filters", "clm.order"))
