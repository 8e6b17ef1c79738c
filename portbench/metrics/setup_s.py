"""Set-up: from the process's start to the window's start (loading, the
weights and inputs made on the device, the warm-up, and in a fresh
checkout the kernels' build)."""


def read(ctx):
    return ctx.setup_s
