"""Strip a checkpoint to its weights for publishing: the JAX package's
`tools/model_converters/publish_model.py` on the port's checkpoints.

    python3 -m bevformer_torch.tools.model_converters.publish_model CKPT OUT [--pth CONFIG]

OUT gets `{"meta", "state_dict"}` of CKPT (a `tools.train` checkpoint):
the optimizer, the lr schedule, the step and the random generators' states
go. The port's state dict is already in the reference `.pth` layout, so
OUT is a model-zoo-layout `.pth`; with `--pth CONFIG` its keys and shapes
are first checked against CONFIG's model (every key, as
`runtime.build_model` loads it) and `meta` names CONFIG. It runs on the
host.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import torch

from bevformer_torch.configs import get_config
from bevformer_torch.runtime import build_model


def main(argv: Optional[Sequence[str]] = None) -> str:
    p = argparse.ArgumentParser(description="strip a checkpoint to its weights")
    p.add_argument("in_ckpt")
    p.add_argument("out")
    p.add_argument("--pth", default=None, help="config name: check the keys against it")
    args = p.parse_args(argv)
    ckpt = torch.load(args.in_ckpt, map_location="cpu", weights_only=True)
    meta, sd = dict(ckpt.get("meta", {})), ckpt["state_dict"]
    print(f"loaded {args.in_ckpt} (step {ckpt.get('step', meta.get('iter'))}); dropped "
          f"{sorted(k for k in ckpt if k not in ('meta', 'state_dict'))}", flush=True)
    if args.pth:
        build_model(get_config(args.pth), sd, "cpu")  # strict: raises on any other key
        meta["config"] = args.pth
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    torch.save({"meta": meta, "state_dict": sd}, args.out)
    print(f"wrote reference-format {args.out} ({len(sd)} tensors)", flush=True)
    return args.out


if __name__ == "__main__":
    main()
