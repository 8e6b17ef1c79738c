"""Evaluation CLI: the JAX package's `tools/test.py`, v1 and V2.

    python3 -m bevformer_torch.tools.test <config> --data-root DATA
        [--checkpoint CKPT] [--out results.json] [--eval bbox|none]
        [--format-only] [--overlap-test] [--max-samples N] [--fuse-conv-bn]
        [--cfg-options key=val ...] [--device cuda] [--dist-backend nccl|gloo]

runs inference over the val split of DATA (`nuscenes_infos_temporal_val.pkl`):
for a v1 config video inference (`VideoEvaluator`, the prev-BEV carry reset
at each scene), for a V2 config (`bevformerv2-r50-*`) sample by sample
(`NuScenesTemporalDatasetV2`'s samples of every offset in `frames`,
`VideoEvaluatorV2`); then it scores the boxes with the nuScenes detection
metrics (`core.evaluation`). It
prints one JSON line {"NDS", "mAP", "mATE", "mASE", "mAOE", "mAVE",
"mAAE"} and writes the whole metrics dict to `metrics_summary.json` beside
`--out` (or in the working directory). `--out` also writes the raw results
and, like `--format-only`, the nuScenes submission (`<out>_nusc.json`, or
`results_nusc.json`).

`--checkpoint` is a checkpoint of `bevformer_torch.tools.train` or a
model-zoo `.pth` (the same `state_dict` layout, a V2 `.pth`'s DD3D head
included); without one the weights are `init_state_dict`'s, seed 0.
`--fuse-conv-bn` folds the BatchNorms into the convs before them
(`runtime.fuse.fuse_conv_bn`: the frozen BNs of v1, the backbone's and
ResNetFusion's running statistics of V2, whose DD3D head, unused in
inference, leaves the model; the same outputs up to fp32 rounding). `--overlap-test` scores only the
boxes seen by more than one camera (NuScenesEval_custom's overlap_test). A
line
{"frames", "frame_ms", "load_ms", ...} reports each frame's (V2: each
sample's) time (its images' loading and preprocessing, then the model and
decode), the peak device memory and the kernels' launches over the frames.

Over ranks (`torchrun --nproc-per-node N`, `bevformer_torch/tools/
dist_test.sh`; JAX `tools/test.py:116-117`, :201-233), each rank runs a
contiguous segment of the samples (`ContiguousVideoSampler`; a v1 segment
starts without history, so N ranks give the one-process boxes where the
segments start at scene starts); the results are gathered in order
(`runtime.eval.gather_results`) and rank 0 writes and scores them and
prints the JSON lines (its own timing), while the other ranks return None.

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
from bevformer_torch.data import (
    ContiguousVideoSampler,
    NuScenesTemporalDataset,
    NuScenesTemporalDatasetV2,
)
from bevformer_torch.kernels import launch_counts, zero_counts
from bevformer_torch.runtime import distributed
from bevformer_torch.runtime.eval import gather_results
from bevformer_torch.runtime import (
    VideoEvaluator,
    VideoEvaluatorV2,
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
                   help="fold the BatchNorms into the convs before them")
    p.add_argument("--cfg-options", nargs="*", default=[])
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    p.add_argument("--dist-backend", default=None, choices=("nccl", "gloo"),
                   help="the process group's backend (default: nccl on the card, gloo on "
                   "the CPU; gloo for several ranks on one card)")
    return p.parse_args(argv)


def median(xs):
    return float(np.median(xs)) if len(xs) else None


def main(argv: Optional[Sequence[str]] = None) -> Optional[dict]:
    args = parse_args(argv)
    device = distributed.maybe_initialize(args.device, args.dist_backend)
    try:
        return evaluate(args, device)
    finally:
        distributed.shutdown()


def evaluate(args, device: torch.device) -> Optional[dict]:
    lead = distributed.rank() == 0

    def say(msg: str) -> None:
        if lead:
            print(msg, flush=True)

    cfg = get_config(args.config)
    if args.cfg_options:
        cfg = apply_overrides(cfg, dict(kv.split("=", 1) for kv in args.cfg_options))

    v2 = cfg.version == "v2"
    ds = (NuScenesTemporalDatasetV2 if v2 else NuScenesTemporalDataset)(
        os.path.join(args.data_root, "nuscenes_infos_temporal_val.pkl"), cfg,
        data_root=args.data_root, device=device,
    )
    say(f"val dataset: {len(ds)} samples ({cfg.version}, frames {cfg.frames}); "
        f"device {device}; {distributed.world_size()} rank(s)")
    if args.checkpoint:
        state_dict = load_reference_pth(args.checkpoint)
        say(f"weights from {args.checkpoint}")
    else:
        say("WARNING: seeded random weights (no --checkpoint)")
        state_dict = init_state_dict(cfg, seed=0)
    model = build_model(cfg, state_dict, device)
    del state_dict
    if args.fuse_conv_bn:
        fuse_conv_bn(model)
        say("folded conv + BN")
    if v2:
        evaluator = VideoEvaluatorV2(model)
        get_sample, infer = ds.get_test_sample_v2, evaluator.infer_sample
    else:
        evaluator = VideoEvaluator(model)
        get_sample, infer = ds.get_test_sample, evaluator.infer_frame

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    n = len(ds) if args.max_samples is None else min(len(ds), args.max_samples)
    segment = ContiguousVideoSampler(n, distributed.world_size(), distributed.rank())
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    zero_counts()  # the launches of this run's frames, also where a process runs several
    results, load_ms, frame_ms = [], [], []
    for i in segment:
        sync()
        t0 = time.perf_counter()
        sample = get_sample(i)
        sync()
        t1 = time.perf_counter()
        results.append(infer(sample))  # waits for the decode
        t2 = time.perf_counter()
        load_ms.append((t1 - t0) * 1e3)
        frame_ms.append((t2 - t0) * 1e3)
    # frame 0 carries the first calls' set-up; rank 0's own frames
    timing = dict(frames=len(frame_ms), frame_ms=frame_ms, load_ms=load_ms,
                  frame_ms_median=median(frame_ms[1:]), load_ms_median=median(load_ms[1:]),
                  peak_gib=(torch.cuda.max_memory_allocated(device) / 2**30
                            if device.type == "cuda" else None),
                  launches=launch_counts(), ranks=distributed.world_size())
    results = gather_results(results, [ds.infos[i]["token"] for i in range(n)])
    if not lead:
        return None
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
