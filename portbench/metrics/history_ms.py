"""Device ms a training step inside the program's `history` span: the
history frames' backbone pass and encoder calls, without gradient."""

from portbench import spans

spans.install()


def read(ctx):
    return spans.per_unit(ctx, "device_ms", "history")
