"""Device, the whole step: the least time the window's steps need at the
published peaks (the config's ``step_count``), over the window's time."""

import importlib

from portbench.roofline import least_seconds


def read(ctx):
    if not ctx.steps or ctx.window_s <= 0:
        return None
    mod = importlib.import_module(
        f"portbench.roofline.{ctx.config['step_count']}")
    t = least_seconds(mod.count(ctx.config, ctx.meta), ctx.peaks)
    return 100.0 * ctx.steps * t / ctx.window_s
