"""Device ms a frame (V2: a sample, its eight frames) in the backbone
(`img_backbone`) and the neck (`img_neck`), over the traced stretch."""

from portbench.trace import layer_device_ms

RANGES = {"backbone": ["path:img_backbone"], "neck": ["path:img_neck"]}


def read(ctx):
    b, n = (layer_device_ms(ctx.trace, r) for r in ("backbone", "neck"))
    if not b or not n:
        return None
    return (b + n) / ctx.trace["units"]
