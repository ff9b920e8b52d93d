"""The share of the SH rows clm's cameras needed that retention kept on the
card, in %: 100 x (1 - `ClmContext.fetched_rows` / `needed_rows`), the
context's sums over every batch it ran up to the last traced one (the
check's steps, the warm batches and the traced batches), read after each
traced `train_one_batch`. None from a program without the counters."""

UNIT = "%"
KEY = "clm.rows"


def _record(args, kwargs, result):
    ctx = result[2]
    if not hasattr(ctx, "needed_rows"):
        return None
    return ctx.needed_rows, ctx.fetched_rows


CAPTURES = (("clm_gs_tpu_torch.strategies.clm_offload", "train_one_batch", KEY, _record),)


def read(ctx):
    recs = ctx["records"].get(KEY)
    if not recs or not recs[-1][0]:
        return None
    needed, fetched = recs[-1]
    return 100.0 * (1.0 - fetched / needed)
