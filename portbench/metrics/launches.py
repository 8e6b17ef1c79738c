"""Kernels launched a unit inside the program's span of the whole unit:
`frame` (`VideoEvaluator.step`), `sample` (`VideoEvaluatorV2.step`) or
`step` (`train_step`), the span named as the cell's unit, over the traced
stretch."""

from portbench import spans

spans.install()


def read(ctx):
    return spans.per_unit(ctx, "launches", ctx.unit)
