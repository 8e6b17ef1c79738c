"""The deformable attention layers' least time over their device time,
in %: TSA, SCA's inner attention and the decoder's cross attention (their
projections and msda) over the traced stretch, forward (in a step the
history's and the trained frame's) and in a step backward (the kernels
launched by the backward functions of the operations the forward range
recorded); the least time from `yardstick.work` (`roofline`'s costs at the
H100 SXM's data-sheet rates, 700 W)."""

from portbench.trace import layer_device_ms
from portbench.yardstick import work

RANGES = {"msda": ["class:TemporalSelfAttention", "class:MSDeformableAttention3D",
                   "class:CustomMSDeformableAttention"]}


def read(ctx):
    ms = layer_device_ms(ctx.trace, "msda")
    bound = work.unit_work(ctx.cfg, ctx.unit).msda_bound_ms * ctx.trace["units"]
    return None if not ms or not bound else 100.0 * bound / ms
