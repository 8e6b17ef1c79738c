"""Device-idle ms a training step inside the program's `match` span: the
costs' copy to the host, scipy's assignment and the copy back, while the
device waits."""

from portbench import spans

spans.install()


def read(ctx):
    return spans.per_unit(ctx, "idle_ms", "match")
