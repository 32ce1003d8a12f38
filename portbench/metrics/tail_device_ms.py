"""Store step: device ms a step of the ``step:tail`` stage (the metric row
and its add into the on-device accumulator), from the program's
device-timed stages: the learner's ``device:step:tail`` timer key, which
the program fills only while tracing is on."""


def read(ctx):
    if "device:step:tail" not in ctx.timer or not ctx.steps:
        return None
    return 1e3 * ctx.timer["device:step:tail"][0] / ctx.steps
