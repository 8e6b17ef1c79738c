"""The msda forward kernels against the plain version at bevformer_base's SCA
shape: the port's counterpart of the JAX package's `tools/bench_msda_kernel.py`.

    python -m bevformer_torch.tools.bench_msda_kernel [k7 k1 k1_bf16 k34_bf16 plain check]
        [--q N] [--tsa] [--reps N]

Cases, on the y-coherent inputs of `common.coherent_inputs`:
  k7       K7, the heads-outer kernel (`ms_deform_attn_ho`, csrc/msda_fwd_ho.cu);
  k1       K1, the heads-inner kernel of the model's path (`ms_deform_attn`);
  k1_bf16  bf16 K1 (`ms_deform_attn` on the value rounded to bf16: the
           `msda_fwd_bf16` entry), the counterpart of the JAX tool's bf16
           rows, against the plain version on the same bf16 value;
  k34_bf16 bf16 K3/K4 (`ms_deform_attn_backward` on that value and a seeded
           bf16 grad_out: `msda_bwd_bf16`), its dValue against autograd
           through the plain version;
  plain    the plain PyTorch version (`ms_deform_attn_plain`);
  check    K7 and K1 on y-incoherent inputs (uniform locations, 10% of the
           coordinates outside [0, 1]). The TPU kernel would drop mass there
           (samples outside its row window); the port's kernels gather every
           corner wherever it lies, so they must still match the plain version.
Each case prints one JSON line: ms per call, the max abs error against the
plain version, the bound and the share of it (`tools/roofline.py`, at the
bf16 cases' 2-byte value, output, grad_out and dValue). The JAX tool's
other variants (patch gather, windowed kernel at several stride/halo/tile
settings) are TPU formulations the port does not have.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from bevformer_torch.kernels import msda
from bevformer_torch.tools import common, roofline

TOOL = "bench_msda_kernel"
CASES = ("k7", "k1", "k1_bf16", "k34_bf16", "plain", "check")


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    args = common.parser("msda forward kernels against the plain version", CASES).parse_args(argv)
    device = common.require_cuda()
    shape = common.shape_of(args)
    value, loc, attw = common.to_device(common.coherent_inputs(shape), device)
    levels = shape.levels
    cost = roofline.msda_fwd(shape.b, shape.q, shape.h, shape.d, levels, shape.p)
    ref = msda.ms_deform_attn_plain(value, levels, loc, attw)
    fns = dict(k7=msda.ms_deform_attn_ho, k1=msda.ms_deform_attn,
               plain=msda.ms_deform_attn_plain)
    records = []
    for case in args.cases:
        if case == "check":
            continue
        if case.endswith("_bf16"):
            records.append(bf16_case(case, shape, value, loc, attw, args.reps))
            continue
        fn = fns[case]
        reps = common.PLAIN_REPS if case == "plain" else args.reps
        records.append(common.measure(TOOL, case, lambda: fn(value, levels, loc, attw), ref,
                                      cost, reps, shape=shape.describe(), inputs="y-coherent"))
    if "check" in args.cases:
        loc_i, = common.to_device([common.incoherent_locations(shape)], device)
        outside = float(((loc_i < 0) | (loc_i > 1)).float().mean())
        ref_i = msda.ms_deform_attn_plain(value, levels, loc_i, attw)
        for name in ("k7", "k1"):
            fn = fns[name]
            records.append(common.measure(
                TOOL, f"check_{name}", lambda: fn(value, levels, loc_i, attw), ref_i, cost,
                args.reps, shape=shape.describe(),
                inputs=f"y-incoherent, {outside:.1%} of coordinates outside [0, 1]"))
    return records


def bf16_case(case, shape, value, loc, attw, reps) -> dict:
    """bf16 K1 or K3/K4 on the value rounded to bf16 (and, backward, a
    grad_out N(0, 1) from seed 0 in bf16)."""
    levels, value = shape.levels, value.bfloat16()
    dims = (shape.b, shape.q, shape.h, shape.d, levels, shape.p)
    tile = msda.k1_bf16_tile_for(value, loc) if value.is_cuda else None
    if case == "k1_bf16":
        ref = msda.ms_deform_attn_plain(value, levels, loc, attw)
        return common.measure(TOOL, case, lambda: msda.ms_deform_attn(value, levels, loc, attw),
                              ref, roofline.msda_fwd(*dims, itemsize=2), reps,
                              shape=shape.describe(), inputs="y-coherent", tile=tile)
    rng = np.random.RandomState(common.SEED)
    g = torch.from_numpy(rng.randn(shape.b, shape.q, shape.h * shape.d).astype(np.float32))
    g = g.to(value.device).bfloat16()
    ref = msda.ms_deform_attn_backward_plain(value, levels, loc, attw, g)[0]
    return common.measure(
        TOOL, case, lambda: msda.ms_deform_attn_backward(value, levels, loc, attw, g)[0], ref,
        roofline.msda_bwd(*dims, itemsize=2), reps, shape=shape.describe(),
        inputs="y-coherent", compared="dValue", tile=tile)


if __name__ == "__main__":
    main()
