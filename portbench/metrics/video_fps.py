"""Frames (V2: samples) whose decoded boxes reached the host in the
window, over the window's seconds."""


def read(ctx):
    return ctx.units / ctx.window_s
