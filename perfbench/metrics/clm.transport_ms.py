"""clm's SH transport (`clm_offload._fetch`, `_advance`, `_drain`), ms a
batch: its spans `clm.fetch_h2d`, `clm.advance` and `clm.d2h_scatter` over
the Timer-on batches."""

from perfbench.spans import per_batch_ms

UNIT = "ms/batch"


def read(ctx):
    return per_batch_ms(ctx, ("clm.fetch_h2d", "clm.advance", "clm.d2h_scatter"))
