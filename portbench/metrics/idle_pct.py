"""The share of a frame's (V2 sample's, training step's) time in which no
operation ran on the device: the device's busy time a unit over the traced
stretch (the union of kernels, copies and fills) against the window's time
a unit. The traced stretch's own wall time is not used: with the
profiler's CPU activity on, the host runs slower there, and the stretch
reads idler than the window ran (PERF.md)."""


def read(ctx):
    t = ctx.trace
    if not t["busy_s"] or not ctx.units:
        return None
    return 100.0 * (1.0 - (t["busy_s"] / t["units"]) / (ctx.window_s / ctx.units))
