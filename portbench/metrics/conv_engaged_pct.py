"""The share of the backbone's and the neck's dense convs that ran on the
program's conv kernel: calls of the span `conv` over calls of `conv` and
`conv_fallback` (those left on cuDNN), in percent, over the traced
stretch; 100 where `conv_fallback` never ran, None where `conv` never ran
(a program without the kernel)."""

from portbench import spans

spans.install()


def read(ctx):
    found = ctx.trace.get("spans", {}) if ctx.trace else {}
    engaged = found.get("conv", {}).get("calls", 0)
    if not engaged:
        return None
    return 100.0 * engaged / (engaged + found.get("conv_fallback", {}).get("calls", 0))
