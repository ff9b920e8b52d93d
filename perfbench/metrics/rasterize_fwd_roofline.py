"""The compositing forward's share of its roofline (`ops/rasterize.py` over
`csrc/rasterize_fwd.cu`): the traced launches' bounds over their kernel
time, the pairs counted from each launch's inputs."""

from perfbench import roofline

UNIT = "%"
CAPTURES = (roofline.FWD_CAPTURE,)


def read(ctx):
    return roofline.rasterize_share(ctx, "fwd")
