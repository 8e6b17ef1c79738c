"""The DCN's cost in bevformer_base's backbone on one card: the JAX
package's `tools/bench_dcn.py`.

    python3 -m bevformer_torch.tools.bench_dcn [dcn] [plain] [--reps 4]
        [--dtype float32|bfloat16] [--cfg-options key=val ...]

The R101 backbone (caffe style, FrozenBN, outputs of stages 2-4) of
bevformer_base with its seeded weights, in eval mode without gradient, on
the example frame's six 928 x 1600 images (`common.example_inputs`, in the
channels-last NCHW view `BEVFormer.extract_feat` hands the backbone):
`dcn` with `dcn_stages=(2, 3)` (conv2 of the 26 blocks of stages 3-4 is a
DCNv2 on K2, `dcn_conv_fwd` or at bf16 `dcn_conv_fwd_bf16`) and `plain`
with none (plain 3 x 3 convolutions in cuDNN). `--dtype` defaults to the
config's (fp32, TF32 off). One call warms up; then each of `--reps` is
timed between CUDA events with the card idle before it. Prints one JSON
line: each case's median, spread and kernel launches per call (`cases`),
dcn minus plain, the peak device memory, the dtype, TF32 flags and the
card. Without a card it raises.

Not ported, being the TPU path's workarounds: the JAX tool's `fused`
(the bf16 fused Pallas DCN), `clip3` and `clip4` (its `dcn_clip_y` clip of
the vertical offsets), `ct1024` and `stride8` (its tiling); the port's K2
samples every offset exactly.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from bevformer_torch.device import precision
from bevformer_torch.tools import common

CASES = {"dcn": (2, 3), "plain": ()}  # backbone_dcn_stages


def parse_args(argv):
    ap = argparse.ArgumentParser(description="The DCN's cost in the port's R101 backbone")
    ap.add_argument("cases", nargs="*", choices=sorted(CASES), metavar="case",
                    help="dcn, plain (default both)")
    ap.add_argument("--reps", type=int, default=4, help="timed calls of each case")
    ap.add_argument("--config", default="bevformer_base")
    ap.add_argument("--dtype", default=None, choices=("float32", "bfloat16"),
                    help="default: the config's own")
    ap.add_argument("--cfg-options", nargs="*", default=[])
    args = ap.parse_args(argv)
    args.cases = args.cases or list(CASES)
    return args


def run(args, device) -> dict:
    cases, cfg = {}, None
    common.reset_peak(device)
    for name in args.cases:
        cfg = common.tool_config(args.config, args.cfg_options, args.dtype,
                                 backbone_dcn_stages=CASES[name])
        backbone = common.seeded_model(cfg, device).img_backbone
        images = common.example_inputs(cfg, 1, device)[0]
        x = images.flatten(0, 1).permute(0, 3, 1, 2)  # NCHW view of NHWC memory
        with torch.no_grad(), precision(cfg.dtype, device.type):
            cases[name] = common.time_calls(lambda: backbone(x), args.reps, device)
        del backbone
    extra = {}
    if len(cases) == 2:
        extra["dcn_minus_plain_ms"] = cases["dcn"].median - cases["plain"].median
    head = args.cases[0]
    return common.json_line(
        f"{args.config} {cfg.dtype} R{cfg.backbone_depth} backbone on "
        f"{cfg.data.num_cams} x {cfg.data.img_size[0]} x {cfg.data.img_size[1]}, DCN stages "
        f"(2, 3) against none (value: {head}; {common.where(device)})", cases[head].median,
        "ms", None, device=device, dtype=cfg.dtype, timing=cases[head], tool="bench_dcn",
        config=args.config, reps=args.reps, cases={k: t.fields() for k, t in cases.items()},
        **extra)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    return run(args, common.require_cuda())


if __name__ == "__main__":
    main()
