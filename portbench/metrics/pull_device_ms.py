"""Store step: device ms a step of FM's ``step:pull`` stage (the pulled
channels [w, v, sum v^2] built over the whole table), from the program's
device-timed stages: the learner's ``device:step:pull`` timer key, which
the program fills only while tracing is on."""


def read(ctx):
    if "device:step:pull" not in ctx.timer or not ctx.steps:
        return None
    return 1e3 * ctx.timer["device:step:pull"][0] / ctx.steps
