"""Store step: device ms of all kernels a step, from the profiler trace."""

from portbench import devtrace


def read(ctx):
    s = devtrace.kernel_seconds(ctx.trace)
    return 1e3 * s / ctx.steps if ctx.steps and s > 0 else None
