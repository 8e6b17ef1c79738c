"""The DCN layers' least time over their device time, in %: every
`ModulatedDeformConv`'s offset convolution and DCN over the traced
stretch, forward (in a step the history's and the trained frame's) and in a
step backward (the kernels launched by the backward functions of the
operations the forward range recorded); the least time from
`yardstick.work` (`roofline`'s costs at the H100 SXM's data-sheet rates,
700 W)."""

from portbench.trace import layer_device_ms
from portbench.yardstick import work

RANGES = {"dcn": ["class:ModulatedDeformConv"]}


def read(ctx):
    ms = layer_device_ms(ctx.trace, "dcn")
    bound = work.unit_work(ctx.cfg, ctx.unit).dcn_bound_ms * ctx.trace["units"]
    return None if not ms or not bound else 100.0 * bound / ms
