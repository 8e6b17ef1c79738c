"""Device ms a training step inside the program's `backward` span
(`total.backward()`, the kernels launched by the autograd engine's
thread included)."""

from portbench import spans

spans.install()


def read(ctx):
    return spans.per_unit(ctx, "device_ms", "backward")
