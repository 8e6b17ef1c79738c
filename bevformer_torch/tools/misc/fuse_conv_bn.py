"""Fold the conv + BN pairs of a checkpoint: the JAX package's
`tools/misc/fuse_conv_bn.py` (reference `tools/misc/fuse_conv_bn.py`) on the
port's checkpoints.

    python3 -m bevformer_torch.tools.misc.fuse_conv_bn CKPT OUT
        [--cfg-options key=val ...] [--device cuda]

CKPT is a checkpoint of `bevformer_torch.tools.train`; the model is the
one of its `meta` config (with `--cfg-options`, as the run that wrote it
took them). OUT gets
`{"meta", "state_dict"}` with every BN that follows a conv folded into it
(`runtime.fuse.folded_state_dict`: the conv's weight times the BN's scale,
the BN an identity plus the folded bias), in the reference layout: it loads
into the same model (`tools.test --checkpoint OUT`) and gives the unfolded
weights' outputs up to fp32 rounding. The optimizer state is dropped. The
model is built on the card unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import torch

from bevformer_torch.configs import apply_overrides, get_config
from bevformer_torch.runtime import build_model, load_reference_pth
from bevformer_torch.runtime.fuse import folded_state_dict


def main(argv: Optional[Sequence[str]] = None) -> str:
    p = argparse.ArgumentParser(description="fold the conv + BN pairs of a checkpoint")
    p.add_argument("checkpoint")
    p.add_argument("out")
    p.add_argument("--cfg-options", nargs="*", default=[])
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    meta = torch.load(args.checkpoint, map_location="cpu", weights_only=True)["meta"]
    cfg = get_config(meta["config"])
    if args.cfg_options:
        cfg = apply_overrides(cfg, dict(kv.split("=", 1) for kv in args.cfg_options))
    model = build_model(cfg, load_reference_pth(args.checkpoint), args.device)
    sd = folded_state_dict(model)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    torch.save({"meta": dict(meta, config=cfg.name, fused_conv_bn=True), "state_dict": sd},
               args.out)
    print(f"fused checkpoint written to {args.out} (step {meta.get('iter')})", flush=True)
    return args.out


if __name__ == "__main__":
    main()
