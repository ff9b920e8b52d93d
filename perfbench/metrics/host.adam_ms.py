"""The host Adam's busy time (`utils/native.py` over
`csrc/host/cpu_adam.cpp`, on clm's worker thread), ms a batch: the growth of
`ClmContext.adam_work_s` over the Timer-on batches."""

UNIT = "ms/batch"


def read(ctx):
    c = ctx["counters"]
    if not c or not ctx["timer_batches"]:
        return None
    return c["adam_work_s"] / ctx["timer_batches"] * 1e3
