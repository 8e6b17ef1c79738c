"""Prediction renderings: the JAX package's `tools/analysis_tools/visual.py`
on the port.

    python3 -m bevformer_torch.tools.analysis_tools.visual results.json --data-root DATA
        [--out-dir viz] [--config bevformer_tiny] [--score-thr 0.3]
        [--max-samples 5] [--gt]

For each result of `tools.test --out` whose token is in DATA's val split: a
top-down matplotlib plot of the predicted footprints coloured by class
(with `--gt`, the ground truth dashed), written as `<token>_bev.png`. It
runs on the host.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional, Sequence

import numpy as np


def corners_bev(box):
    cx, cy, w, l, yaw = box[0], box[1], box[3], box[4], box[6]
    c, s = np.cos(yaw), np.sin(yaw)
    pts = np.array([[w / 2, l / 2], [w / 2, -l / 2], [-w / 2, -l / 2], [-w / 2, l / 2]])
    rot = np.array([[c, -s], [s, c]])
    return pts @ rot.T + [cx, cy]


def main(argv: Optional[Sequence[str]] = None) -> List[str]:
    p = argparse.ArgumentParser(description="render predictions top-down")
    p.add_argument("results")
    p.add_argument("--data-root", required=True)
    p.add_argument("--config", default="bevformer_tiny")
    p.add_argument("--out-dir", default="viz")
    p.add_argument("--score-thr", type=float, default=0.3)
    p.add_argument("--max-samples", type=int, default=5)
    p.add_argument("--gt", action="store_true")
    args = p.parse_args(argv)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from bevformer_torch.configs import get_config
    from bevformer_torch.data import NuScenesTemporalDataset

    ds = NuScenesTemporalDataset(
        os.path.join(args.data_root, "nuscenes_infos_temporal_val.pkl"), get_config(args.config),
        load_images=False, data_root=args.data_root, device="cpu")
    token_to_idx = {info["token"]: i for i, info in enumerate(ds.infos)}
    with open(args.results) as f:
        results = json.load(f)

    os.makedirs(args.out_dir, exist_ok=True)
    cmap = plt.get_cmap("tab10")
    written = []
    for r in results[: args.max_samples]:
        idx = token_to_idx.get(r["token"])
        if idx is None:
            continue
        fig, ax = plt.subplots(figsize=(8, 8))
        boxes = np.asarray(r["boxes_3d"], np.float64).reshape(-1, 9)
        scores = np.asarray(r["scores_3d"])
        labels = np.asarray(r["labels_3d"], int)
        keep = scores >= args.score_thr
        for b, lab in zip(boxes[keep], labels[keep]):
            ax.add_patch(plt.Polygon(corners_bev(b), fill=False, color=cmap(lab % 10), lw=1.5))
        if args.gt:
            ann = ds._annotations(ds.infos[idx])
            for b in ann["gt_boxes"]:
                ax.add_patch(plt.Polygon(corners_bev(b), fill=False, color="k", lw=1.0,
                                         linestyle="--"))
        ax.plot(0, 0, "r^", markersize=10)
        ax.set_xlim(-55, 55)
        ax.set_ylim(-55, 55)
        ax.set_aspect("equal")
        ax.grid(alpha=0.3)
        ax.set_title(r["token"])
        out = os.path.join(args.out_dir, f"{r['token']}_bev.png")
        fig.savefig(out, dpi=110, bbox_inches="tight")
        plt.close(fig)
        print(out, flush=True)
        written.append(out)
    return written


if __name__ == "__main__":
    main()
