"""What the kernel and device metrics share: the records their captures
keep of each launch, and the shares of a bound they compute from them.

A roofline share is the summed bounds of the traced launches over their
summed kernel times, the i-th record against the i-th launch of the kernel
in the trace. Compositing's pair counts are walked once per launch and
kept in the reader's cache.
"""

from __future__ import annotations

from perfbench import counts, trace

RASTERIZE = "clm_gs_tpu_torch.ops.rasterize"
KERNELS = {"fwd": "rasterize_fwd_kernel", "bwd": "rasterize_bwd_kernel"}


def record_fwd(args, kwargs, result):
    """rasterize_fwd(table, gauss_ids, tile_offsets, background, width,
    height) -> (image, alpha, t_final, last): the inputs and `last`."""
    table, gauss_ids, tile_offsets, _, width, height = args
    if width * height == 0:
        return None
    return {"table": table, "ids": gauss_ids, "offsets": tile_offsets, "last": result[3],
            "width": width, "height": height}


def record_bwd(args, kwargs, result):
    """rasterize_bwd(table, gauss_ids, tile_offsets, image, alpha, last,
    v_image, v_alpha, width, height)."""
    table, gauss_ids, tile_offsets, _, _, last, _, _, width, height = args
    if gauss_ids.shape[0] == 0:
        return None
    return {"table": table, "ids": gauss_ids, "offsets": tile_offsets, "last": last,
            "width": width, "height": height}


FWD_CAPTURE = (RASTERIZE, "rasterize_fwd", "rasterize_fwd", record_fwd)
BWD_CAPTURE = (RASTERIZE, "rasterize_bwd", "rasterize_bwd", record_bwd)


def pairs(ctx, rec) -> dict:
    key = (rec["table"].data_ptr(), rec["ids"].data_ptr(), rec["last"].data_ptr())
    if key not in ctx["cache"]:
        ctx["cache"][key] = counts.pair_counts(rec["table"], rec["ids"], rec["offsets"],
                                               rec["last"], rec["width"], rec["height"])
    return ctx["cache"][key]


def rasterize_bound(ctx, rec, d: str) -> float:
    nbytes = counts.rasterize_bytes(rec["table"].shape[0], rec["ids"].shape[0],
                                    rec["width"], rec["height"], d)
    return counts.bound_s(nbytes, counts.pair_ops(pairs(ctx, rec), d))


def share(times, bounds):
    """100 x summed bounds over summed times of the first len(bounds)
    launches; None when the trace has fewer launches than records."""
    if not bounds or len(times) < len(bounds):
        return None
    return 100.0 * sum(bounds) / sum(times[:len(bounds)])


def rasterize_share(ctx, d: str):
    recs = ctx["records"].get("rasterize_" + d, [])
    times = trace.kernel_times(ctx["trace"], KERNELS[d])
    return share(times, [rasterize_bound(ctx, r, d) for r in recs])
