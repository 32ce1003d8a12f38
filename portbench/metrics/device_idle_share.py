"""Device: the share of the traced window in which no operation ran."""


def read(ctx):
    w = ctx.trace.window_ns
    return 100.0 * (1.0 - ctx.trace.busy_ns / w) if w > 0 else None
