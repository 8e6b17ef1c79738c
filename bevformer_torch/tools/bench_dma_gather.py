"""The row gather kernel against `torch.take_along_dim`: the port's
counterpart of the JAX package's `tools/bench_dma_gather.py`.

    python -m bevformer_torch.tools.bench_dma_gather [bf16 fp32] [--reps N]

out[b, r, :] = src[b, idx[b, r], :] for src [6, 40960, 256] N(0, 1) and a
random permutation of the rows per batch, made with numpy from seed 0 as
the JAX tool makes them. Case `bf16` gathers the bf16 rows (the JAX tool's),
`fp32` the same values in fp32. Each prints the kernel's ms
(`row_gather`, csrc/row_gather.cu), its rate over the bytes it must move
(`GB_per_s`), the bound, and `library_ms`, the time of `torch.take_along_dim` on
the same inputs, which is also the plain version: the two must agree
bitwise. The JAX tool's `nop` case timed its scan harness, which CUDA
events do not need.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence

import numpy as np
import torch

from bevformer_torch.kernels import gather
from bevformer_torch.tools import common, roofline

TOOL = "bench_dma_gather"
CASES = ("bf16", "fp32")
DTYPES = dict(bf16=torch.bfloat16, fp32=torch.float32)
SHAPE = (6, 40960, 256)  # src [batch, rows, width], the JAX tool's


@functools.lru_cache(maxsize=1)
def inputs(shape):
    """src [batch, rows, width] fp32 N(0, 1) and idx [batch, rows] int32, a
    permutation per batch, numpy."""
    batch, rows, width = shape
    rng = np.random.RandomState(common.SEED)
    src = rng.randn(batch, rows, width).astype(np.float32)
    idx = np.stack([rng.permutation(rows) for _ in range(batch)]).astype(np.int32)
    return src, idx


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    args = common.CaseParser("row gather kernel against take_along_dim", CASES,
                             reps=50).parse_args(argv)
    device = common.require_cuda()
    batch, rows, width = SHAPE
    src32, idx = common.to_device(inputs(SHAPE), device)
    records = []
    for case in args.cases:
        src = src32.to(DTYPES[case])
        cost = roofline.row_gather(batch, rows, rows, width, src.element_size())
        library_ms, ref = common.time_ms(lambda: gather.row_gather_plain(src, idx), args.reps)
        records.append(common.measure(
            TOOL, case, lambda: gather.row_gather(src, idx), ref, cost, args.reps, exact=True,
            shape=f"src {list(src.shape)} {case}, idx {list(idx.shape)}",
            library_ms=library_ms, plain_ms=library_ms))
    return records


if __name__ == "__main__":
    main()
