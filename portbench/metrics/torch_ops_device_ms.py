"""Store step: device ms a step of the kernels that are not the port's
hand-written ones (the torch ops: the metric tail, the FM update, spill
adds), from the profiler trace."""

from portbench import devtrace


def read(ctx):
    s = devtrace.kernel_seconds(ctx.trace, exclude=set(ctx.kernels["port"]))
    return 1e3 * s / ctx.steps if ctx.steps and s > 0 else None
