"""The gradient reduction's share of its roofline (`ops/segreduce.py` over
`csrc/segreduce.cu`): bytes of the sorted ids, the (m, 9) rows and the
(n, 9) sums over the traced launches' kernel time."""

from perfbench import counts, roofline, trace

UNIT = "%"


def _record(args, kwargs, result):
    ids_sorted, rows, n = args
    return {"m": rows.shape[0], "n": n}


CAPTURES = (("clm_gs_tpu_torch.ops.rasterize", "segment_reduce_sorted", "segreduce",
             _record),)


def read(ctx):
    recs = ctx["records"].get("segreduce", [])
    bounds = [counts.bound_s(counts.segreduce_bytes(r["m"], r["n"]), 0) for r in recs]
    return roofline.share(trace.kernel_times(ctx["trace"], "segment_sums"), bounds)
