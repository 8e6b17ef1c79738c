"""Browse dataset samples: the JAX package's `tools/misc/browse_dataset.py`
(reference `tools/misc/browse_dataset.py`) on the port.

    python3 -m bevformer_torch.tools.misc.browse_dataset <config> --data-root DATA
        [--split train|val] [--out-dir browse] [--max-samples 3]
        [--cfg-options key=val ...] [--device cuda]

For each of the first samples: the 6 camera images as the test pipeline
hands them to the model (de-normalised), each ground-truth box centre
projected through the sample's `lidar2img`, and a BEV plot of the ground
truth, written as `sample_<i>.png`: a visual check of the data pipeline
and its geometry. The pipeline runs on the card unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional, Sequence

import numpy as np


def main(argv: Optional[Sequence[str]] = None) -> List[str]:
    p = argparse.ArgumentParser(description="render dataset samples")
    p.add_argument("config")
    p.add_argument("--data-root", required=True)
    p.add_argument("--split", default="train", choices=["train", "val"])
    p.add_argument("--out-dir", default="browse")
    p.add_argument("--max-samples", type=int, default=3)
    p.add_argument("--cfg-options", nargs="*", default=[])
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from bevformer_torch.configs import apply_overrides, get_config
    from bevformer_torch.data import CAM_ORDER, NuScenesTemporalDataset

    cfg = get_config(args.config)
    if args.cfg_options:
        cfg = apply_overrides(cfg, dict(kv.split("=", 1) for kv in args.cfg_options))
    ds = NuScenesTemporalDataset(
        os.path.join(args.data_root, f"nuscenes_infos_temporal_{args.split}.pkl"), cfg,
        data_root=args.data_root, device=args.device)
    os.makedirs(args.out_dir, exist_ok=True)

    mean, std = np.asarray(cfg.data.mean), np.asarray(cfg.data.std)
    written = []
    for i in range(min(args.max_samples, len(ds))):
        s = ds.get_test_sample(i)
        images = s["images"].cpu().numpy()
        ann = ds._annotations(ds.infos[i]) if "gt_boxes" in ds.infos[i] else None
        fig, axes = plt.subplots(2, 4, figsize=(22, 9))
        for ci in range(min(6, images.shape[0])):
            ax = axes[ci // 3][ci % 3]
            img = images[ci] * std + mean
            if cfg.data.to_rgb:
                ax.imshow(np.clip(img, 0, 255).astype(np.uint8))
            else:
                ax.imshow(np.clip(img[..., ::-1], 0, 255).astype(np.uint8))
            ax.set_title(CAM_ORDER[ci] if ci < len(CAM_ORDER) else f"cam{ci}")
            ax.axis("off")
            if ann is not None:
                for b in ann["gt_boxes"]:
                    pt = s["lidar2img"][ci] @ np.array([b[0], b[1], b[2], 1.0])
                    if pt[2] > 0.5:
                        u, v = pt[0] / pt[2], pt[1] / pt[2]
                        hgt, wdt = cfg.data.img_size
                        if 0 <= u < wdt and 0 <= v < hgt:
                            ax.plot(u, v, "r+", markersize=12)
        axb = axes[0][3]
        if ann is not None:
            axb.scatter(ann["gt_boxes"][:, 0], ann["gt_boxes"][:, 1], s=12)
        axb.plot(0, 0, "r^")
        axb.set_xlim(-55, 55)
        axb.set_ylim(-55, 55)
        axb.set_title("BEV GT")
        axb.grid(alpha=0.3)
        axes[1][3].axis("off")
        out = os.path.join(args.out_dir, f"sample_{i:04d}.png")
        fig.savefig(out, dpi=90, bbox_inches="tight")
        plt.close(fig)
        print(out, flush=True)
        written.append(out)
    return written


if __name__ == "__main__":
    main()
