"""Time BEVFormerV2 inference on one card: the JAX package's
`tools/bench_v2.py`.

    python3 -m bevformer_torch.tools.bench_v2 [config] [--samples 4]
        [--dtype float32|bfloat16] [--cfg-options key=val ...]

`VideoEvaluatorV2.step` of a V2 config (default bevformerv2-r50-t1) with
seeded weights, on the JAX package's seeded example frame
(`common.example_inputs`) at every offset of `cfg.frames` (t8 encodes its
seven history frames through `bev_only`, then the current one). One sample
warms up; then each of `--samples` is timed between CUDA events with the
card idle before it. Prints one JSON line: the median ms a sample, the
spread, the peak device memory, K1's launches per sample, the dtype, TF32
flags and the card. Without a card it raises.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from bevformer_torch.device import precision
from bevformer_torch.runtime.eval import VideoEvaluatorV2
from bevformer_torch.tools import common


def parse_args(argv):
    ap = common.bench_parser("Time the port's BEVFormerV2 inference", "bevformerv2-r50-t1")
    ap.add_argument("--samples", type=int, default=4, help="timed samples")
    return ap.parse_args(argv)


def sample_inputs(cfg, device):
    """images [1, T, cams, H, W, 3] (the example frame at each of the T
    offsets), lidar2img [1, T, cams, 4, 4], flip [1] false and the identity
    bda [1, 2, 2]."""
    images, _, l2i, _, _ = common.example_inputs(cfg, 1, device)
    t = len(cfg.frames)
    return (images[:, None].expand(-1, t, -1, -1, -1, -1).contiguous(),
            l2i[:, None].expand(-1, t, -1, -1, -1).contiguous(),
            torch.zeros((1,), dtype=torch.bool, device=device),
            torch.eye(2, device=device)[None])


def run(args, device) -> dict:
    cfg = common.tool_config(args.config, args.cfg_options, args.dtype)
    evaluator = VideoEvaluatorV2(common.seeded_model(cfg, device))
    inputs = sample_inputs(cfg, device)
    common.reset_peak(device)
    with precision(cfg.dtype, device.type):
        timing = common.time_calls(lambda: evaluator.step(*inputs), args.samples, device)
    return common.json_line(
        f"{args.config} {cfg.dtype} sample inference ({len(cfg.frames)} frames a sample; "
        f"{common.where(device)})", timing.median, "ms/sample", None, device=device,
        dtype=cfg.dtype, timing=timing, tool="bench_v2", config=args.config, samples=args.samples,
        frames=list(cfg.frames))


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    return run(args, common.require_cuda())


if __name__ == "__main__":
    main()
