"""Store step: device ms a step of FM's ``step:update`` stage (AdaGrad
over the whole table), from the program's device-timed stages: the
learner's ``device:step:update`` timer key, which the program fills only
while tracing is on."""


def read(ctx):
    if "device:step:update" not in ctx.timer or not ctx.steps:
        return None
    return 1e3 * ctx.timer["device:step:update"][0] / ctx.steps
