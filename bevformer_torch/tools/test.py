"""Evaluation CLI: the v1 path of the JAX package's `tools/test.py`.

    python3 -m bevformer_torch.tools.test <config> --data-root DATA
        [--checkpoint CKPT] [--out results.json] [--eval bbox|none]
        [--format-only] [--overlap-test] [--max-samples N] [--fuse-conv-bn]
        [--cfg-options key=val ...] [--device cuda]

runs video inference (`VideoEvaluator`, the prev-BEV carry reset at each
scene) over the val split of DATA (`nuscenes_infos_temporal_val.pkl`), then
scores it with the nuScenes detection metrics (`core.evaluation`). It
prints one JSON line {"NDS", "mAP", "mATE", "mASE", "mAOE", "mAVE",
"mAAE"} and writes the whole metrics dict to `metrics_summary.json` beside
`--out` (or in the working directory). `--out` also writes the raw results
and, like `--format-only`, the nuScenes submission (`<out>_nusc.json`, or
`results_nusc.json`).

`--checkpoint` is a checkpoint of `bevformer_torch.tools.train` or a
model-zoo `.pth` (the same `state_dict` layout); without one the weights
are `init_state_dict`'s, seed 0. `--fuse-conv-bn` folds the backbone's
frozen BatchNorms into the convs before them (`runtime.fuse.fuse_conv_bn`;
the same outputs up to fp32 rounding). `--overlap-test` scores only the
boxes seen by more than one camera (NuScenesEval_custom's overlap_test). A
line
{"frames", "frame_ms", "load_ms", ...} reports each frame's time (its
images' loading and preprocessing, then the model and decode), the peak
device memory and the kernels' launches.

The run is on the card unless `--device cpu`; with no card it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from bevformer_torch.configs import apply_overrides, get_config
from bevformer_torch.core.evaluation import (
    ERR_NAME_MAPPING,
    apply_overlap_filter,
    evaluate_detections,
    format_submission,
)
from bevformer_torch.data import NuScenesTemporalDataset
from bevformer_torch.device import resolve as resolve_device
from bevformer_torch.kernels import launch_counts
from bevformer_torch.runtime import (
    VideoEvaluator,
    build_model,
    fuse_conv_bn,
    init_state_dict,
    load_reference_pth,
)


def parse_args(argv):
    p = argparse.ArgumentParser(description="Evaluate the PyTorch port of BEVFormer")
    p.add_argument("config")
    p.add_argument("--data-root", required=True)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--out", default=None, help="write the raw results json")
    p.add_argument("--eval", default="bbox", choices=("bbox", "none"))
    p.add_argument("--max-samples", type=int, default=None)
    p.add_argument("--format-only", action="store_true",
                   help="only write the nuScenes submission json")
    p.add_argument("--overlap-test", action="store_true",
                   help="score only boxes in camera-overlap regions")
    p.add_argument("--fuse-conv-bn", action="store_true",
                   help="fold the backbone's BatchNorms into the convs before them")
    p.add_argument("--cfg-options", nargs="*", default=[])
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return p.parse_args(argv)


def median(xs):
    return float(np.median(xs)) if len(xs) else None


def main(argv: Optional[Sequence[str]] = None) -> Optional[dict]:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.config)
    if args.cfg_options:
        cfg = apply_overrides(cfg, dict(kv.split("=", 1) for kv in args.cfg_options))

    ds = NuScenesTemporalDataset(
        os.path.join(args.data_root, "nuscenes_infos_temporal_val.pkl"), cfg,
        data_root=args.data_root, device=device,
    )
    print(f"val dataset: {len(ds)} samples; device {device}", flush=True)
    if args.checkpoint:
        state_dict = load_reference_pth(args.checkpoint)
        print(f"weights from {args.checkpoint}", flush=True)
    else:
        print("WARNING: seeded random weights (no --checkpoint)", flush=True)
        state_dict = init_state_dict(cfg, seed=0)
    model = build_model(cfg, state_dict, device)
    del state_dict
    if args.fuse_conv_bn:
        fuse_conv_bn(model)
        print("folded conv + BN", flush=True)
    evaluator = VideoEvaluator(model)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    n = len(ds) if args.max_samples is None else min(len(ds), args.max_samples)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    results, load_ms, frame_ms = [], [], []
    for i in range(n):
        sync()
        t0 = time.perf_counter()
        sample = ds.get_test_sample(i)
        sync()
        t1 = time.perf_counter()
        results.append(evaluator.infer_frame(sample))  # waits for the decode
        t2 = time.perf_counter()
        load_ms.append((t1 - t0) * 1e3)
        frame_ms.append((t2 - t0) * 1e3)
    # frame 0 carries the first calls' set-up
    timing = dict(frames=n, frame_ms=frame_ms, load_ms=load_ms,
                  frame_ms_median=median(frame_ms[1:]), load_ms_median=median(load_ms[1:]),
                  peak_gib=(torch.cuda.max_memory_allocated(device) / 2**30
                            if device.type == "cuda" else None),
                  launches=launch_counts())
    print(json.dumps(timing), flush=True)

    if args.out:
        serial = [{"token": r["token"], "boxes_3d": r["boxes_3d"].tolist(),
                   "scores_3d": r["scores_3d"].tolist(), "labels_3d": r["labels_3d"].tolist()}
                  for r in results]
        with open(args.out, "w") as f:
            json.dump(serial, f)
        print(f"wrote {args.out}", flush=True)
    if args.format_only or args.out:
        # the standard nuScenes submission: global-frame boxes with the
        # class/velocity default attribute_name
        info_by_token = {ds.infos[i]["token"]: ds.infos[i] for i in range(n)}
        sub_path = (os.path.splitext(args.out)[0] + "_nusc.json" if args.out
                    else "results_nusc.json")
        with open(sub_path, "w") as f:
            json.dump(format_submission(results, info_by_token), f)
        print(f"wrote nuScenes submission {sub_path}", flush=True)
        if args.format_only:
            return None
    if args.eval != "bbox":
        return None

    gt_by_token = ds.gt_by_token(range(n))
    if args.overlap_test:
        l2i_by_token = {ds.infos[i]["token"]: ds.frame_record(i)["lidar2img"] for i in range(n)}
        results, gt_by_token = apply_overlap_filter(results, gt_by_token, l2i_by_token,
                                                    cfg.data.raw_size)
    metrics = evaluate_detections(results, gt_by_token, verbose=True)
    summary = {"NDS": metrics["nd_score"], "mAP": metrics["mean_ap"],
               **{ERR_NAME_MAPPING[k]: v for k, v in metrics["tp_errors"].items()}}
    print(json.dumps(summary), flush=True)
    out_dir = os.path.dirname(args.out) if args.out else "."
    with open(os.path.join(out_dir, "metrics_summary.json"), "w") as f:
        json.dump(metrics, f, default=float)
    return dict(summary, timing=timing)


if __name__ == "__main__":
    main()
