"""Kernels: the fused FM step (``tile_fm_step.cu`` ``wh_fm_step``) against
its roofline."""

from portbench.metrics._roofline import share


def read(ctx):
    return share(ctx, "tile_fm_step")
