"""The bytes clm's transport moves to the card, MB a batch: the growth of
`ClmContext.h2d_bytes` over the Timer-on batches."""

UNIT = "MB/batch"


def read(ctx):
    c = ctx["counters"]
    if not c or not ctx["timer_batches"]:
        return None
    return c["h2d_bytes"] / ctx["timer_batches"] / 1e6
