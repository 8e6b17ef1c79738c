"""Parameter count: the JAX package's `tools/analysis_tools/get_params.py`
on the port.

    python3 -m bevformer_torch.tools.analysis_tools.get_params <config>
    python3 -m bevformer_torch.tools.analysis_tools.get_params --pth CKPT

Counts every tensor of the model's reference-layout state dict (the
FrozenBN and BatchNorm statistics included, as the JAX tool counts its
variables; not the BatchNorms' `num_batches_tracked` counters), of a
config's model (built on the meta device: no memory, no card) or of a
checkpoint's `state_dict`. Prints "<n>M parameters".
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from bevformer_torch.configs import get_config
from bevformer_torch.runtime import load_reference_pth
from bevformer_torch.runtime.checkpoint import _detector


def count(state_dict) -> int:
    return sum(v.numel() for k, v in state_dict.items() if not k.endswith("num_batches_tracked"))


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description="count a model's parameters")
    p.add_argument("config", nargs="?", default=None)
    p.add_argument("--pth", default=None)
    args = p.parse_args(argv)
    if args.pth:
        total = count(load_reference_pth(args.pth))
    else:
        if args.config is None:
            p.error("give a config or --pth")
        with torch.device("meta"):
            total = count(_detector(get_config(args.config)).state_dict())
    print(f"{total / 1e6:.2f}M parameters", flush=True)
    return total


if __name__ == "__main__":
    main()
