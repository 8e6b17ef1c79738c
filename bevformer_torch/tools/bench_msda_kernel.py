"""The msda forward kernels against the plain version at bevformer_base's SCA
shape: the port's counterpart of the JAX package's `tools/bench_msda_kernel.py`.

    python -m bevformer_torch.tools.bench_msda_kernel [k7 k1 plain check] [--q N] [--tsa] [--reps N]

Cases, on the y-coherent inputs of `common.coherent_inputs`:
  k7     K7, the heads-outer kernel (`ms_deform_attn_ho`, csrc/msda_fwd_ho.cu);
  k1     K1, the heads-inner kernel of the model's path (`ms_deform_attn`);
  plain  the plain PyTorch version (`ms_deform_attn_plain`);
  check  K7 and K1 on y-incoherent inputs (uniform locations, 10% of the
         coordinates outside [0, 1]). The TPU kernel would drop mass there
         (samples outside its row window); the port's kernels gather every
         corner wherever it lies, so they must still match the plain version.
Each case prints one JSON line: ms per call, the max abs error against the
plain version, the bound and the share of it (`tools/roofline.py`). The
JAX tool's other variants (patch gather, windowed kernel at several
stride/halo/tile settings, bf16) are TPU formulations the port does not have.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from bevformer_torch.kernels import msda
from bevformer_torch.tools import common, roofline

TOOL = "bench_msda_kernel"
CASES = ("k7", "k1", "plain", "check")


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


if __name__ == "__main__":
    main()
