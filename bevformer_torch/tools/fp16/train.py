"""Mixed-precision training CLI: the JAX package's `tools/fp16/train.py`
(the reference's `tools/fp16/train.py`).

    python3 -m bevformer_torch.tools.fp16.train <config> --data-root DATA [...]

takes `bevformer_torch.tools.train`'s arguments and runs it with
`dtype=bfloat16` added to `--cfg-options`: the model computes under bf16
autocast around its fp32 islands, on fp32 parameters (`device.precision`).
bf16 has fp32's exponent range, so the reference's fp16 loss scaling and
its frozen eval copy of the model are not needed.
"""

from __future__ import annotations

import sys
from typing import List, Optional, Sequence

from bevformer_torch.tools import train


def force_bf16_argv(argv: Sequence[str]) -> List[str]:
    """`argv` with `dtype=bfloat16` in `--cfg-options`: right after the
    flag where it is there (argparse's nargs="*" then takes it with the
    other overrides, and a later `dtype=` of the caller's wins), else
    appended with the flag."""
    argv = list(argv)
    if "--cfg-options" in argv:
        argv.insert(argv.index("--cfg-options") + 1, "dtype=bfloat16")
    else:
        argv.extend(["--cfg-options", "dtype=bfloat16"])
    return argv


def main(argv: Optional[Sequence[str]] = None) -> dict:
    return train.main(force_bf16_argv(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    main()
