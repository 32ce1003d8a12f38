"""Kernels: the fused FTRL update step (``tile_step.cu`` ``wh_step_update``)
against its roofline."""

from portbench.metrics._roofline import share


def read(ctx):
    return share(ctx, "tile_step_update")
