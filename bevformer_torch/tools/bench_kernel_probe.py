"""The cost split of K7 at bevformer_base's SCA shape: the port's counterpart
of the JAX package's `tools/bench_kernel_probe.py`.

    python -m bevformer_torch.tools.bench_kernel_probe [full gather weights noop] [--q N] [--tsa] [--reps N]

The TPU probe split the windowed kernel into its matmul and its row
combine. The port's K7 (csrc/msda_fwd_ho.cu) gathers instead, so it splits
into the modes of csrc/msda_fwd.cuh, each a function with a plain version
(`msda_probe_plain`): `full` (the msda), `gather` (the corner reads with
unit weights), `weights` (the weight arithmetic, no value reads) and
`noop` (reads loc and attw, writes out). Each case prints ms, the plain
version's ms, the max abs error against it and its scale, the mode's bound
and the share of it.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from bevformer_torch.kernels import msda
from bevformer_torch.tools import common, roofline

TOOL = "bench_kernel_probe"
KERNEL = "ho"


def run_modes(tool: str, kernel: str, argv: Optional[Sequence[str]]) -> List[dict]:
    """Each probe mode of `kernel` ("ho": K7, "hi": K1; K1's `full` is the
    model's `ms_deform_attn`)."""
    args = common.parser(f"cost split of msda kernel {kernel}", msda.PROBE_MODES).parse_args(argv)
    device = common.require_cuda()
    shape = common.shape_of(args)
    value, loc, attw = common.to_device(common.coherent_inputs(shape), device)
    levels = shape.levels
    records = []
    for mode in args.cases:
        if (kernel, mode) == ("hi", "full"):
            def fn():
                return msda.ms_deform_attn(value, levels, loc, attw)
        else:
            def fn():
                return msda.msda_probe(kernel, mode, value, levels, loc, attw)

        def plain():
            return msda.msda_probe_plain(mode, value, levels, loc, attw)

        cost = roofline.msda_fwd(shape.b, shape.q, shape.h, shape.d, levels, shape.p, mode)
        records.append(common.measure(tool, mode, fn, plain(), cost, args.reps, plain=plain,
                                      shape=shape.describe(), mode=mode))
    return records


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    return run_modes(TOOL, KERNEL, argv)


if __name__ == "__main__":
    main()
