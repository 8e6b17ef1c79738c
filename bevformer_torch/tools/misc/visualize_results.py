"""Top-down BEV renderings of detection results: the JAX package's
`tools/misc/visualize_results.py` (reference `tools/misc/visualize_results.py`,
`dataset.show()` on a results file) on the port.

    python3 -m bevformer_torch.tools.misc.visualize_results --result results.json
        [--data-root DIR] [--config bevformer_base] [--show-dir vis]
        [--score-thr 0.3] [--max-samples 50] [--canvas 800]

Reads the results json `tools.test --out` writes and, with `--data-root`,
the val split's ground truth (the port's dataset, no images); draws each
sample's predicted footprints (and the ground truth's) on a BEV canvas with
cv2 and writes `<token>_bev.png` per sample. It runs on the host.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

import numpy as np

PC_RANGE = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)


def parse_args(argv):
    p = argparse.ArgumentParser(description="visualize BEVFormer results")
    p.add_argument("--result", required=True, help="results json from tools.test --out")
    p.add_argument("--data-root", default=None, help="nuScenes-format root (adds the GT)")
    p.add_argument("--config", default="bevformer_base", help="config of the GT dataset")
    p.add_argument("--show-dir", default="vis", help="output directory")
    p.add_argument("--score-thr", type=float, default=0.3)
    p.add_argument("--max-samples", type=int, default=50)
    p.add_argument("--canvas", type=int, default=800)
    return p.parse_args(argv)


def draw_box_bev(canvas, box, color, scale, center, thickness=1):
    """box [x, y, z, w, l, h, yaw, ...] (lidar frame): its rotated footprint
    and a heading tick on the canvas (+y up)."""
    import cv2

    x, y, w, l, yaw = box[0], box[1], box[3], box[4], box[6]
    c, s = np.cos(yaw), np.sin(yaw)
    corners = np.array([[-w / 2, -l / 2], [-w / 2, l / 2], [w / 2, l / 2], [w / 2, -l / 2]])
    rot = np.array([[c, -s], [s, c]])
    pts = corners @ rot.T + np.array([x, y])
    pix = ((pts - center[None]) * scale + canvas.shape[0] / 2).astype(np.int32)
    pix[:, 1] = canvas.shape[0] - 1 - pix[:, 1]
    cv2.polylines(canvas, [pix.reshape(-1, 1, 2)], True, color, thickness)
    head = np.array([[0, l / 2], [0, l / 2 + 1.0]]) @ rot.T + np.array([x, y])
    hp = ((head - center[None]) * scale + canvas.shape[0] / 2).astype(np.int32)
    hp[:, 1] = canvas.shape[0] - 1 - hp[:, 1]
    cv2.line(canvas, tuple(hp[0]), tuple(hp[1]), color, thickness)


def main(argv: Optional[Sequence[str]] = None) -> int:
    import cv2

    args = parse_args(argv)
    with open(args.result) as f:
        results = json.load(f)
    os.makedirs(args.show_dir, exist_ok=True)

    gt_by_token = {}
    if args.data_root:
        from bevformer_torch.configs import get_config
        from bevformer_torch.data import NuScenesTemporalDataset

        ds = NuScenesTemporalDataset(
            os.path.join(args.data_root, "nuscenes_infos_temporal_val.pkl"),
            get_config(args.config), load_images=False, data_root=args.data_root,
            device="cpu")
        for i in range(len(ds)):
            rec = ds.frame_record(i)
            if "gt_boxes" in rec:
                gt_by_token[rec["token"]] = rec

    scale = args.canvas / (PC_RANGE[3] - PC_RANGE[0])
    center = np.zeros(2)
    written = 0
    for r in results[: args.max_samples]:
        canvas = np.full((args.canvas, args.canvas, 3), 30, np.uint8)
        mid = (args.canvas // 2, args.canvas // 2)
        for radius in range(10, int(PC_RANGE[3]) + 1, 10):  # range rings every 10 m
            cv2.circle(canvas, mid, int(radius * scale), (60, 60, 60), 1)
        cv2.circle(canvas, mid, 3, (255, 255, 255), -1)
        gt = gt_by_token.get(r["token"])
        if gt is not None:
            for b in np.asarray(gt["gt_boxes"], np.float32):
                draw_box_bev(canvas, b, (80, 200, 80), scale, center, 2)
        boxes = np.asarray(r["boxes_3d"], np.float32)
        scores = np.asarray(r["scores_3d"], np.float32)
        for b, s in zip(boxes, scores):
            if s < args.score_thr:
                continue
            shade = int(120 + 135 * min(float(s), 1.0))
            draw_box_bev(canvas, b, (60, 60, shade), scale, center, 1)
        path = os.path.join(args.show_dir, f"{r['token']}_bev.png")
        if not cv2.imwrite(path, canvas):
            raise RuntimeError(f"{path}: cv2 could not write it")
        written += 1
    print(f"wrote {written} BEV renderings to {args.show_dir}/", flush=True)
    return written


if __name__ == "__main__":
    main()
