"""Device ms a training step inside the program's `clip` and `optimizer`
spans: the global gradient clip, AdamW and the schedule."""

from portbench import spans

spans.install()


def read(ctx):
    return spans.per_unit(ctx, "device_ms", "clip", "optimizer")
