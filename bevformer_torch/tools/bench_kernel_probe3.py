"""K7's tile and accumulator sweep at bevformer_base's SCA shape: the port's
counterpart of the JAX package's `tools/bench_kernel_probe3.py`.

    python -m bevformer_torch.tools.bench_kernel_probe3 [t8a1 ... t64a2] [--q N] [--tsa] [--reps N]

The TPU probe swept the windowed kernel's geometry (row stride, halo, item
tile) and its independent accumulators (acc2, acc4) for the row combine.
The port's K7 (csrc/msda_fwd_ho.cu) has no windows; its geometry is the
number of queries a block takes (the tile whose payload it builds in shared
memory: 8, 16, 32 or 64) and its independent accumulator sets per 8-lane
group (1 or 2). Case `t{tile}a{acc}` runs that instantiation in `full` mode on the
y-coherent inputs and prints ms, the max abs error against the plain
version, the bound and the share of it.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from bevformer_torch.kernels import msda
from bevformer_torch.tools import common, roofline

TOOL = "bench_kernel_probe3"
CASES = tuple(f"t{t}a{a}" for t in msda.HO_TILES for a in msda.HO_ACCS)


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    args = common.parser("K7 tile and accumulator sweep", CASES).parse_args(argv)
    device = common.require_cuda()
    shape = common.shape_of(args)
    value, loc, attw = common.to_device(common.coherent_inputs(shape), device)
    levels = shape.levels
    cost = roofline.msda_fwd(shape.b, shape.q, shape.h, shape.d, levels, shape.p)
    ref = msda.ms_deform_attn_plain(value, levels, loc, attw)
    records = []
    for case in args.cases:
        tile, acc = (int(s) for s in case[1:].split("a"))
        records.append(common.measure(
            TOOL, case,
            lambda: msda.msda_probe("ho", "full", value, levels, loc, attw, tile=tile, acc=acc),
            ref, cost, args.reps, shape=shape.describe(), tile=tile, acc=acc))
    return records


if __name__ == "__main__":
    main()
