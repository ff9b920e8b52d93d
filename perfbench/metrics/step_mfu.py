"""The whole step's share of the card's float32 peak: the traced batches'
counted operations over their time x 67 TFLOP/s (the peak outside the
tensor cores; the port computes in float32). Counted: projection and SH per
visible Gaussian and camera, the compositing pairs forward and backward,
the loss per pixel, and the card's Adam per updated row (`counts.py`)."""

from perfbench import counts, roofline

UNIT = "%"


def _visible(args, kwargs, result):
    radii, width, height = args[5], args[6], args[7]
    return {"radii": radii, "pixels": width * height}


CAPTURES = (roofline.FWD_CAPTURE,
            ("clm_gs_tpu_torch.strategies.base", "rasterize", "visible", _visible))


def read(ctx):
    cams = ctx["records"].get("visible", [])
    fwd = ctx["records"].get("rasterize_fwd", [])
    if not cams or len(fwd) != len(cams) or not ctx["trace"]["kernels"]:
        return None
    ops = 0
    for c, r in zip(cams, fwd):
        ops += int((c["radii"] > 0).sum()) * counts.OPS_GAUSSIAN
        ops += 3 * c["pixels"] * counts.OPS_PIXEL_CHANNEL
        p = roofline.pairs(ctx, r)
        ops += counts.pair_ops(p, "fwd") + counts.pair_ops(p, "bwd")
    for b in ctx["batches"]:
        ops += b["updated_rows"] * ctx["card_floats"] * counts.OPS_ADAM_FLOAT
    return 100.0 * ops / (ctx["trace"]["window_s"] * counts.PEAK_F32)
