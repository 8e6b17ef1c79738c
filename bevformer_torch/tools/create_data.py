"""Data preparation CLI: the `synth` mode of the JAX package's
`tools/create_data.py`.

    python3 -m bevformer_torch.tools.create_data synth --out-dir D \
        [--scenes 2] [--frames 8] [--objects 12] [--img-w 1600] [--img-h 900] [--seed 0]

writes a synthetic nuScenes-format root: `nuscenes_infos_temporal_{train,
val}.pkl` and JPEG camera images (cv2) under `D/samples/` (`data.synth.generate`;
the first half of the scenes train, the rest validate). It runs on the host
only. The `nuscenes` mode, the converter of a raw nuScenes download, is not
ported: it needs nuscenes-devkit and the dataset.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from bevformer_torch.data.synth import generate


def main(argv: Optional[Sequence[str]] = None) -> str:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="mode", required=True)
    ps = sub.add_parser("synth", help="a synthetic nuScenes-format root")
    ps.add_argument("--out-dir", required=True)
    ps.add_argument("--scenes", type=int, default=2)
    ps.add_argument("--frames", type=int, default=8)
    ps.add_argument("--objects", type=int, default=12)
    ps.add_argument("--img-w", type=int, default=1600)
    ps.add_argument("--img-h", type=int, default=900)
    ps.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    out = generate(args.out_dir, num_scenes=args.scenes, frames_per_scene=args.frames,
                   num_objects=args.objects, img_w=args.img_w, img_h=args.img_h,
                   seed=args.seed)
    print(f"synthetic dataset written to {out}", flush=True)
    return out


if __name__ == "__main__":
    main()
