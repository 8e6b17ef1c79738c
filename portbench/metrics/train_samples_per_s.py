"""Samples stepped in the window, over the window's seconds; each step
ends with its losses on the host."""


def read(ctx):
    return ctx.units * ctx.cfg.optim.samples_per_gpu / ctx.window_s
