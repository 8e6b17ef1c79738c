"""Device ms a frame (V2: a sample) inside the program's `decoder` span,
over the traced stretch."""

from portbench import spans

spans.install()


def read(ctx):
    return spans.per_unit(ctx, "device_ms", "decoder")
