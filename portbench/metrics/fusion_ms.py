"""Device ms a V2 sample in ResNetFusion, over the traced stretch."""

from portbench.trace import layer_device_ms

RANGES = {"fusion": ["class:ResNetFusion"]}


def read(ctx):
    ms = layer_device_ms(ctx.trace, "fusion")
    return ms / ctx.trace["units"] if ms else None
