"""The host Adam's time a row it stepped, in ns (`utils/native.py` over
`csrc/host/cpu_adam.cpp`, on clm's worker thread): `ClmContext.adam_work_s`
over `ClmContext.adam_rows`, the context's sums over every batch it ran up
to the last traced one (the check's steps, the warm batches and the traced
batches), read after each traced `train_one_batch`. The host library's
rate, comparable across dense and sparse batches. None from a program
without the row counter."""

UNIT = "ns/row"
KEY = "clm.adam_rows"


def _record(args, kwargs, result):
    ctx = result[2]
    if not hasattr(ctx, "adam_rows"):
        return None
    return ctx.adam_work_s, ctx.adam_rows


CAPTURES = (("clm_gs_tpu_torch.strategies.clm_offload", "train_one_batch", KEY, _record),)


def read(ctx):
    recs = ctx["records"].get(KEY)
    if not recs or not recs[-1][1]:
        return None
    seconds, rows = recs[-1]
    return seconds / rows * 1e9
