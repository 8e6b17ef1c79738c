"""Device ms a frame (V2: a sample, its eight encoder calls) inside the
program's `encoder` spans (TSA, SCA, the FFNs), over the traced stretch."""

from portbench import spans

spans.install()


def read(ctx):
    return spans.per_unit(ctx, "device_ms", "encoder")
