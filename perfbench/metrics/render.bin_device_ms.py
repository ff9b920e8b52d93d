"""The card's time in the binning, ms a traced batch: the kernels, copies
and memsets launched within the span `render.bin` (`ops/rasterize.py`
`rasterize`: the extents and `ops/tiles.py` `isect_tiles`, the depth sort,
the fill, the tile sort and the offsets), summed over every camera of the
batch (`perfbench/attribution.py`). None from a program without the
span."""

from perfbench import attribution

UNIT = "ms/batch"
CAPTURES = (attribution.CAPTURE,)


def read(ctx):
    return attribution.per_batch_ms(ctx, ("render.bin",))
