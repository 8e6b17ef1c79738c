"""The BEV encoder alone on one card, at several depths: the JAX package's
`tools/bench_enc_only.py`.

    python3 -m bevformer_torch.tools.bench_enc_only [config] [--layers 1 2 6]
        [--glue] [--reps 16] [--dtype ...] [--cfg-options key=val ...]

`models/encoder.py::BEVFormerEncoder` of the config (default
bevformer_base) with its seeded weights (the first L layers of the
detector's), without the backbone, in eval mode without gradient, on fixed
seeded inputs drawn as the JAX tool draws them (numpy seed 0, N(0, 1) x 0.1):
the camera value [1, cams, K, e] over the FPN levels of `img_size`, the BEV
queries, their positions and a prev BEV [1, q, e], `has_prev` true, no
shift, and the example frame's lidar2img (`common.example_inputs`). One
call warms up; then each of `--reps` is timed between CUDA events with the
card idle before it. `--glue` times instead the per-frame work outside the
layers (`BEVFormerEncoder.frame_geometry`: the reference points,
`point_sampling`, TSA's hybrid references and `sca_capacity_routing`). The
JAX tool's value staging for its fused kernels has no counterpart: the
port's K1 reads the value as it is. Prints one JSON line: each depth's (or
the glue's) median, spread and kernel launches per call (`cases`), the
peak device memory, the dtype, TF32 flags and the card. Without a card it
raises.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from bevformer_torch.device import precision
from bevformer_torch.models.encoder import BEVFormerEncoder
from bevformer_torch.tools import common

PREFIX = "pts_bbox_head.transformer.encoder."


def parse_args(argv):
    ap = common.bench_parser("The port's BEV encoder alone", "bevformer_base")
    ap.add_argument("--layers", type=int, nargs="+", default=[1, 2, 6],
                    help="encoder depths to time")
    ap.add_argument("--glue", action="store_true",
                    help="time the per-frame work outside the layers instead")
    ap.add_argument("--reps", type=int, default=16, help="timed calls of each case")
    return ap.parse_args(argv)


def level_shapes(cfg):
    """The FPN levels' (h, w) at `img_size`: stride 8, then halved (rounding
    up) at each further level."""
    hh, ww = (x // 8 for x in cfg.data.img_size)
    shapes = []
    for _ in range(cfg.num_feature_levels):
        shapes.append((hh, ww))
        hh, ww = -(-hh // 2), -(-ww // 2)
    return tuple(shapes)


def encoder_inputs(cfg, device):
    """(bev_query, value, bev_pos, prev_bev, has_prev, shift, lidar2img,
    img_shape, spatial_shapes, bev_h, bev_w): the encoder's arguments, the
    tensors float32 (has_prev bool) on `device`."""
    rng = np.random.RandomState(common.SEED)
    e, q = cfg.embed_dims, cfg.bev_h * cfg.bev_w
    shapes = level_shapes(cfg)
    k = sum(a * b for a, b in shapes)

    def draw(*shape):
        return torch.from_numpy((rng.randn(*shape) * 0.1).astype(np.float32)).to(device)

    value = draw(1, cfg.data.num_cams, k, e)
    bev_query, bev_pos, prev_bev = draw(1, q, e), draw(1, q, e), draw(1, q, e)
    lidar2img = common.example_lidar2img(cfg, 1, device)
    return (bev_query, value, bev_pos, prev_bev, torch.ones((1,), dtype=torch.bool, device=device),
            torch.zeros((1, 2), device=device), lidar2img, tuple(cfg.data.img_size), shapes,
            cfg.bev_h, cfg.bev_w)


def build_encoder(cfg, num_layers: int, state_dict, device) -> BEVFormerEncoder:
    """The config's encoder at `num_layers` layers (its first layers of
    `state_dict`, keyed as the encoder's own; numpy or torch values), in
    eval mode."""
    enc = BEVFormerEncoder(
        num_layers, cfg.embed_dims, cfg.num_heads, cfg.feedforward_channels, cfg.data.num_cams,
        cfg.num_feature_levels, cfg.num_points_in_pillar, cfg.pc_range,
        cfg.sca_num_points, cfg.tsa_num_points, cfg.sca_capacity_ratio, cfg.ffn_dropout,
        cfg.use_remat,
    )
    own = enc.state_dict()
    enc.load_state_dict({k: v if torch.is_tensor(v) else torch.from_numpy(np.array(v))
                         for k, v in state_dict.items() if k in own}, strict=True)
    return enc.to(device).eval()


def run(args, device) -> dict:
    depth = max(args.layers)
    cfg = common.tool_config(args.config, args.cfg_options, args.dtype, encoder_layers=depth)
    full = common.seeded_model(cfg, device)
    weights = {k[len(PREFIX):]: v for k, v in full.state_dict().items() if k.startswith(PREFIX)}
    del full
    inputs = encoder_inputs(cfg, device)
    common.reset_peak(device)
    cases = {}
    with torch.no_grad(), precision(cfg.dtype, device.type):
        if args.glue:
            enc = build_encoder(cfg, 1, weights, device)
            _, _, _, _, has_prev, shift, l2i, img_shape, _, bev_h, bev_w = inputs
            cases["glue"] = common.time_calls(
                lambda: enc.frame_geometry(has_prev, shift, l2i, img_shape, bev_h, bev_w),
                args.reps, device)
        else:
            for n in args.layers:
                enc = build_encoder(cfg, n, weights, device)
                cases[f"L{n}"] = common.time_calls(lambda: enc(*inputs), args.reps, device)
    head = "glue" if args.glue else f"L{depth}"
    what = ("the per-frame glue outside the layers" if args.glue else
            f"{', '.join(map(str, args.layers))} layers; value: {depth}")
    return common.json_line(
        f"{args.config} {cfg.dtype} encoder alone ({what}; {common.where(device)})",
        cases[head].median, "ms", None, device=device, dtype=cfg.dtype, timing=cases[head],
        tool="bench_enc_only", config=args.config, reps=args.reps,
        cases={k: t.fields() for k, t in cases.items()})


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    return run(args, common.require_cuda())


if __name__ == "__main__":
    main()
