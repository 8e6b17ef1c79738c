"""The window's products over its time, as a share of 165 TFLOP/s (the
H100 SXM's 495 TFLOP/s of TF32 at three TF32 products per fp32-accurate
multiply-add, 700 W): the FLOP of every unit from `yardstick.work`, a
frame's (V2: a sample's) from `frame`, a training step's (history forward,
trained frame forward and backward) from `train_step`."""

from portbench.yardstick import work


def read(ctx):
    if not ctx.on_device:
        return None
    flops = work.unit_work(ctx.cfg, ctx.unit).flops * ctx.units
    return 100.0 * flops / ctx.window_s / work.PEAK_FP32_ACCURATE_FLOPS
