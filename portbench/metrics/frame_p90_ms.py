"""The 90th percentile of every frame's latency in the window: the host
clock from the `step` call to its decoded boxes on the host."""

import numpy as np


def read(ctx):
    return float(np.percentile(np.asarray(ctx.latencies_s) * 1e3, 90))
