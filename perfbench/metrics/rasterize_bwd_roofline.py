"""The compositing backward's share of its roofline (`ops/rasterize.py`
over `csrc/rasterize_bwd.cu`): the traced launches' bounds over their
kernel time, the pairs counted from each launch's inputs."""

from perfbench import roofline

UNIT = "%"
CAPTURES = (roofline.BWD_CAPTURE,)


def read(ctx):
    return roofline.rasterize_share(ctx, "bwd")
