"""Frames per second of video inference on one card: the JAX package's
`tools/benchmark.py`.

    python3 -m bevformer_torch.tools.benchmark <config> [--samples 20]
        [--dtype float32|bfloat16] [--streams N] [--cfg-options key=val ...]

builds the config with seeded weights (`init_state_dict`, seed 0) and steps
`VideoEvaluator.step` (model forward and top-k decode, in the config's dtype:
for v1 fp32 with TF32 off) frame after frame on the JAX package's seeded
example frame (`common.example_inputs`), the BEV of each frame carried into
the next as `prev_bev`, `has_prev` true after the first. Two frames warm up;
then each of `--samples` frames is timed between CUDA events with the card
idle before it. Prints one JSON line in `bench.py`'s shape: `metric`,
`value` (frames/s from the median frame), `unit`, `vs_baseline` = value /
3.0, the estimated A100 figure that the metric names (the reference
publishes none), and the median, spread and every frame's ms, the peak
device memory, the kernel launches per frame, the dtype and TF32 flags,
the SCA capacity count (`attention.capacity_count`, over the warm-up
frames, so that the timed frames run the model path alone; every frame has
the same cameras) and the card.

`--streams N` steps batch N: N videos side by side, each with its own
`prev_bev` carry; the value is then the aggregate frames/s of the N
streams, and the metric says so. Without a card it raises.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence

import torch

from bevformer_torch.device import precision
from bevformer_torch.models.attention import capacity_count
from bevformer_torch.runtime.eval import VideoEvaluator
from bevformer_torch.tools import common

A100_BASELINE_FPS = 3.0  # estimated; the reference publishes no FPS (`bench.py`)
WARMUP = 2  # frames: the first without history, one with


def parse_args(argv):
    ap = common.bench_parser("Frames per second of the port's video inference", None)
    ap.add_argument("--samples", type=int, default=20, help="timed frames")
    ap.add_argument("--streams", type=int, default=1,
                    help="videos batched per step (batch N, N prev_bev carries); the value is "
                    "then the AGGREGATE frames/s, not the batch-1 frame latency")
    return ap.parse_args(argv)


def frames(evaluator: VideoEvaluator, inputs) -> Iterator:
    """(bev_embed, decoded batch) of frame after frame of `inputs`
    (`common.example_inputs`): each frame's BEV is the next one's
    `prev_bev`, `has_prev` is true from the second frame on."""
    images, can_bus, lidar2img, prev_bev, has_prev = inputs
    while True:
        bev, dec = evaluator.step(images, can_bus, lidar2img, prev_bev, has_prev)
        yield bev, dec
        prev_bev, has_prev = bev.float(), torch.ones_like(has_prev)


def metric_name(config: str, dtype: str, streams: int, device) -> str:
    on = common.where(device)
    what = (f"{config} {dtype} 6-cam video inference, AGGREGATE frames/sec of {streams} "
            f"batched streams ({on})" if streams > 1 else
            f"{config} {dtype} 6-cam video inference throughput ({on})")
    return (f"{what}; vs_baseline = ours / {A100_BASELINE_FPS} FPS (ESTIMATED A100 figure - the "
            "reference publishes no FPS)")


def run(args, device) -> dict:
    cfg = common.tool_config(args.config, args.cfg_options, args.dtype)
    evaluator = VideoEvaluator(common.seeded_model(cfg, device))
    chain = frames(evaluator, common.example_inputs(cfg, args.streams, device))
    common.reset_peak(device)
    with precision(cfg.dtype, device.type):
        with capacity_count() as dropped:  # over the warm-up: the timed frames count nothing
            for _ in range(WARMUP):
                next(chain)
        timing = common.time_calls(lambda: next(chain), args.samples, device, warmup=0)
    fps = args.streams * 1e3 / timing.median
    return common.json_line(
        metric_name(args.config, cfg.dtype, args.streams, device), fps, "frames/sec",
        fps / A100_BASELINE_FPS, device=device, dtype=cfg.dtype, timing=timing,
        tool="benchmark", config=args.config, streams=args.streams, samples=args.samples,
        frame_ms_median=timing.median, **dropped.read())


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    return run(args, common.require_cuda())


if __name__ == "__main__":
    main()
