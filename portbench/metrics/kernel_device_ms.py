"""Store step: device ms a step of the ``step:kernel`` stage (the block's
decode, the fused step or the split chain, and the push), from the
program's device-timed stages: the learner's ``device:step:kernel`` timer
key, which the program fills only while tracing is on."""


def read(ctx):
    if "device:step:kernel" not in ctx.timer or not ctx.steps:
        return None
    return 1e3 * ctx.timer["device:step:kernel"][0] / ctx.steps
