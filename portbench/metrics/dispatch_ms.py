"""App loop: host ms a step spends dispatching it (the learner's
``dispatch`` timer scope in ``_process_crec``)."""


def read(ctx):
    s, n = ctx.timer.get("dispatch", (0.0, 0))
    return 1e3 * s / n if n else None
