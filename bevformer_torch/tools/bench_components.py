"""Component times of a v1 frame on one card: the JAX package's
`tools/bench_components.py`.

    python3 -m bevformer_torch.tools.bench_components [config] [--reps 4]
        [--encoder-layers N] [--skip-full] [--dtype ...] [--cfg-options ...]

The config (default bevformer_base) with seeded weights, in eval mode
without gradient, on the JAX package's seeded example frame
(`common.example_inputs`, `has_prev` true with a zero `prev_bev`, as the
JAX tool runs it): backbone + neck (`BEVFormer.extract_feat`), BEV only
(`forward(..., only_bev=True)`: backbone, neck and encoder) and the full
forward (decoder and head too). One call of each warms up; then each of
`--reps` is timed between CUDA events with the card idle before it. The
encoder is BEV-only minus backbone + neck, decoder + head full minus
BEV-only (medians). `--encoder-layers N` sets the encoder's depth (JAX's
`BENCH_LAYERS`), `--skip-full` leaves the full forward out. Prints one JSON
line: each component's median, spread and kernel launches per call
(`cases`), the two differences, the peak device memory, the dtype, TF32
flags and the card. Without a card it raises.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from bevformer_torch.device import precision
from bevformer_torch.tools import common


def parse_args(argv):
    ap = common.bench_parser("Component times of the port's v1 frame", "bevformer_base")
    ap.add_argument("--reps", type=int, default=4, help="timed calls of each component")
    ap.add_argument("--encoder-layers", type=int, default=None,
                    help="the encoder's depth (default the config's)")
    ap.add_argument("--skip-full", action="store_true", help="leave the full forward out")
    return ap.parse_args(argv)


def components(model, inputs):
    """{name: call} of the three nested parts of a frame, on `inputs`
    (`common.example_inputs`, `has_prev` set true)."""
    images, can_bus, lidar2img, prev_bev, has_prev = inputs
    has_prev = torch.ones_like(has_prev)
    return dict(
        backbone_neck=lambda: model.extract_feat(images),
        bev_only=lambda: model(images, can_bus, lidar2img, prev_bev, has_prev, only_bev=True),
        full=lambda: model(images, can_bus, lidar2img, prev_bev, has_prev),
    )


def run(args, device) -> dict:
    fields = {} if args.encoder_layers is None else dict(encoder_layers=args.encoder_layers)
    cfg = common.tool_config(args.config, args.cfg_options, args.dtype, **fields)
    model = common.seeded_model(cfg, device)
    calls = components(model, common.example_inputs(cfg, 1, device))
    if args.skip_full:
        del calls["full"]
    common.reset_peak(device)
    cases = {}
    with torch.no_grad(), precision(cfg.dtype, device.type):
        for name, call in calls.items():
            cases[name] = common.time_calls(call, args.reps, device)
    med = {k: t.median for k, t in cases.items()}
    split = dict(encoder_ms=med["bev_only"] - med["backbone_neck"])
    if "full" in med:
        split["decoder_head_ms"] = med["full"] - med["bev_only"]
    head = "full" if "full" in cases else "bev_only"
    return common.json_line(
        f"{args.config} {cfg.dtype} frame components ({cfg.encoder_layers} encoder layers; "
        f"value: the {head.replace('_', '-')} forward; {common.where(device)})", med[head], "ms",
        None, device=device, dtype=cfg.dtype, timing=cases[head], tool="bench_components",
        config=args.config, encoder_layers=cfg.encoder_layers, reps=args.reps,
        cases={k: t.fields() for k, t in cases.items()}, **split)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    return run(args, common.require_cuda())


if __name__ == "__main__":
    main()
