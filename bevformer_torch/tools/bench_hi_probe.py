"""The cost split of K1, the heads-inner msda kernel of the model's path, at
bevformer_base's SCA shape (`--tsa`: TSA's): the port's counterpart of the
JAX package's `tools/bench_hi_probe.py`.

    python -m bevformer_torch.tools.bench_hi_probe [full gather weights noop] [--q N] [--tsa] [--reps N]

The modes are K7's (`bench_kernel_probe`), run by K1's kernel body
(csrc/msda_fwd.cuh): `full` is the model's `ms_deform_attn`, the others go
through `msda_probe("hi", ...)`. The TPU probe's `wprep` and `payprep`
modes timed the preparation of the row windows and of the bilinear payload
in XLA before the kernel; the port prepares nothing outside its kernels, so
they have no counterpart (nor do its channel-major `xpose`/`prepcm`/
`fullcm` variants of that preparation).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from bevformer_torch.tools.bench_kernel_probe import run_modes

TOOL = "bench_hi_probe"
KERNEL = "hi"


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    return run_modes(TOOL, KERNEL, argv)


if __name__ == "__main__":
    main()
