"""clm's micro step (`offload_common.clm_fused_step` over
`strategies/base.py` `render_one_cam`), ms a batch: its span `clm.micro`
over the Timer-on batches."""

from perfbench.spans import per_batch_ms

UNIT = "ms/batch"


def read(ctx):
    return per_batch_ms(ctx, ("clm.micro",))
