"""The msda kernels alone at level 0 of bevformer_base's SCA: the port's
counterpart of the JAX package's `tools/bench_msda_decompose.py`.

    python -m bevformer_torch.tools.bench_msda_decompose [k7 k1 k7_random k1_random] [--q N] [--reps N]

One level, (116, 200), with B = 6, H = 8, D = 32, Q = 16000 and P = 8: K7
(`ms_deform_attn_ho`) and K1 (`ms_deform_attn`) on y-coherent locations
(`k7`, `k1`) and on locations uniform on [0, 1) with no order, as the JAX
probe draws them (`k7_random`, `k1_random`). Each case prints ms, the plain
version's ms, the max abs error against it, the bound and the share of it.

The JAX probe also timed its routing, payload build, slot scatter and
scatter-add back (its :54-99 and :126-136): the TPU's band routing around
its kernel, which the port does not have, since its kernels read the value
map wherever the samples fall. Its kernel body is K7's `_kernel`, so K7
stands in for it here. (That probe no longer runs against the JAX package:
it calls `_capacity`, `_route_level`, `prepare_band_values` and a
three-argument `_kernel`, none of which `msda_pallas.py` has any more.)
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from bevformer_torch.kernels import msda
from bevformer_torch.tools import common, roofline

TOOL = "bench_msda_decompose"
CASES = ("k7", "k1", "k7_random", "k1_random")
LEVEL0 = (common.SCA_LEVELS[0],)


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    ap = common.parser("msda kernels alone at level 0 of SCA", CASES)
    args = ap.parse_args(argv)
    if args.tsa:
        ap.error("--tsa: this probe is SCA's level 0 only")
    device = common.require_cuda()
    shape = common.sca_shape(16000 if args.q is None else args.q, LEVEL0)
    value, loc, attw = common.to_device(common.coherent_inputs(shape), device)
    rng = np.random.RandomState(common.SEED + 1)
    loc_r, = common.to_device([rng.rand(*loc.shape).astype(np.float32)], device)
    levels = shape.levels
    cost = roofline.msda_fwd(shape.b, shape.q, shape.h, shape.d, levels, shape.p)
    refs = {}
    records = []
    for case in args.cases:
        name, _, random = case.partition("_")
        where = loc_r if random else loc
        if random not in refs:
            refs[random] = msda.ms_deform_attn_plain(value, levels, where, attw)
        fn = msda.ms_deform_attn_ho if name == "k7" else msda.ms_deform_attn
        records.append(common.measure(
            TOOL, case, lambda: fn(value, levels, where, attw), refs[random], cost, args.reps,
            plain=lambda: msda.ms_deform_attn_plain(value, levels, where, attw),
            shape=shape.describe(), inputs="uniform on [0, 1)" if random else "y-coherent"))
    return records


if __name__ == "__main__":
    main()
