"""A kernel group's share of its roofline: the least time of the group's
count (``roofline/<group>.py``) over the group's device time a launch,
the launches being the window's steps."""

import importlib

from portbench import devtrace
from portbench.roofline import least_seconds


def share(ctx, group: str):
    names = set(ctx.kernels["groups"][group])
    s = devtrace.kernel_seconds(ctx.trace, names=names)
    if not ctx.steps or s <= 0:
        return None
    mod = importlib.import_module(f"portbench.roofline.{group}")
    t = least_seconds(mod.count(ctx.config, ctx.meta), ctx.peaks)
    return 100.0 * t / (s / ctx.steps)
