"""App loop: host ms a step waits before it is dispatched and after the
pass (the learner's ``wait`` timer scope: the in-flight gate and the
drains)."""


def read(ctx):
    s, _ = ctx.timer.get("wait", (0.0, 0))
    return 1e3 * s / ctx.steps if ctx.steps else None
