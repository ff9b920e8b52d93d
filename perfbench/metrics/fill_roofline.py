"""The binning's forward fill's share of its roofline (`ops/tiles.py`,
`ops/fill.py` over `csrc/fill.cu`): each channel slot read and written once,
over the traced launches' kernel time."""

from perfbench import counts, roofline, trace

UNIT = "%"


def _record(args, kwargs, result):
    x = args[0]
    if x.shape[1] == 0:  # no launch
        return None
    return {"channels": x.shape[0], "slots": x.shape[1]}


CAPTURES = (("clm_gs_tpu_torch.ops.tiles", "forward_fill", "fill", _record),)


def read(ctx):
    recs = ctx["records"].get("fill", [])
    bounds = [counts.bound_s(counts.fill_bytes(r["channels"], r["slots"]), 0) for r in recs]
    return roofline.share(trace.kernel_times(ctx["trace"], "fill_tile"), bounds)
