"""SCA's static capacity against the cameras' projective geometry: the JAX
package's `tools/audit_sca_capacity.py`, through the port's own
`core/geometry.py::point_sampling` and `data/synth.py::camera_rigs`.

    python3 -m bevformer_torch.tools.audit_sca_capacity

For bevformer_base's BEV (200 x 200, 928 x 1600 input) on the synthetic
rig (six cameras of 64 degrees, f = 0.8 x width) and on the real nuScenes
focal lengths (five cameras at f ~ 1266 px, 70 degrees; CAM_BACK at f ~ 809
px, 110 degrees; copied as constants, as JAX's `real_rigs` does), and for
bevformer_tiny's (50 x 50, 480 x 800) on the synthetic rig, with pillars
of `num_z` = 4 anchors at the audit's own heights:
  the visible-query fraction of each camera (any anchor of the pillar
  projects inside the image): what `sca_capacity_ratio` must exceed, for
  SCA drops the visible queries past its capacity and the reference never
  drops (`spatial_cross_attention.py:136-172`);
  the visible-pair fraction ((query, anchor) pairs): what a kernel routed
  per anchor would pay;
  the pair visibility of the routed queries;
  and the visible queries the config's own routing drops
  (`sca_capacity_routing` inside `attention.capacity_count`).
Geometry, not a timing: it runs on the card as the model's
`point_sampling` does. Prints one JSON line (`cases`; the value is the
largest visible-query fraction). Without a card it raises.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from bevformer_torch.configs import get_config
from bevformer_torch.core.geometry import point_sampling, reference_points_3d
from bevformer_torch.data.synth import camera_rigs, rig_lidar2img
from bevformer_torch.kernels import zero_counts
from bevformer_torch.models.attention import capacity_count, sca_capacity_routing
from bevformer_torch.tools import common

NUM_Z = 4
# the real nuScenes focal lengths at 1600 px wide (JAX `real_rigs`)
REAL_FOCALS = (("CAM_FRONT", 1266.0), ("CAM_FRONT_RIGHT", 1260.0), ("CAM_FRONT_LEFT", 1272.0),
               ("CAM_BACK", 809.2), ("CAM_BACK_LEFT", 1256.7), ("CAM_BACK_RIGHT", 1259.5))


def real_rigs(img_w: int = 1600, img_h: int = 900) -> Dict[str, dict]:
    """`camera_rigs` with the real nuScenes focal lengths, scaled to
    `img_w`."""
    rigs = camera_rigs(img_w, img_h)
    s = img_w / 1600.0
    for cam, f in REAL_FOCALS:
        intr = rigs[cam]["intrinsic"].copy()  # the rigs share one array
        intr[0, 0] = intr[1, 1] = f * s
        rigs[cam]["intrinsic"] = intr
    return rigs


def audit(bev_h, bev_w, pc_range, img_hw, num_z=NUM_Z, rigs=None, device="cpu",
          capacity_ratio: float = 0.0) -> dict:
    """The fractions of one geometry (per camera, in CAM_ORDER) and the
    visible queries a routing at `capacity_ratio` drops. The pillars'
    anchors lie at heights (i + 0.5) / num_z of the range, as the JAX
    tool's do."""
    h_img, w_img = img_hw
    l2i = torch.from_numpy(rig_lidar2img(w_img, h_img, rigs)[None]).float().to(device)
    ref = reference_points_3d(bev_h, bev_w, num_z, num_z, device=device)
    _, mask = point_sampling(ref, pc_range, l2i, img_hw)
    with capacity_count() as dropped:
        sca_capacity_routing(mask, capacity_ratio)
    m = mask[0].cpu().numpy()  # [cams, q, nz]
    anyq = m.any(-1)
    per_query = anyq.mean(1)
    per_pair = m.mean((1, 2))
    pairs_of_visible = m.sum((1, 2)) / np.maximum(anyq.sum(1) * m.shape[-1], 1)
    return dict(bev=[bev_h, bev_w], img=list(img_hw), visible_query_fraction=per_query.tolist(),
                visible_pair_fraction=per_pair.tolist(),
                pair_visibility_of_visible=pairs_of_visible.tolist(),
                max_query_fraction=float(per_query.max()), max_pair_fraction=float(per_pair.max()),
                capacity_ratio=capacity_ratio, **dropped.read())


def cases(device) -> Dict[str, dict]:
    base, tiny = get_config("bevformer_base"), get_config("bevformer_tiny")
    base_hw, tiny_hw = (928, 1600), (480, 800)
    args = dict(device=device)
    return {
        "base_synthetic": audit(base.bev_h, base.bev_w, base.pc_range, base_hw,
                                capacity_ratio=base.sca_capacity_ratio, **args),
        "base_real": audit(base.bev_h, base.bev_w, base.pc_range, base_hw,
                           rigs=real_rigs(1600, 928), capacity_ratio=base.sca_capacity_ratio,
                           **args),
        "tiny_synthetic": audit(tiny.bev_h, tiny.bev_w, tiny.pc_range, tiny_hw,
                                capacity_ratio=tiny.sca_capacity_ratio, **args),
    }


def run(device) -> dict:
    common.reset_peak(device)
    zero_counts()
    out = cases(device)
    worst = max(c["max_query_fraction"] for c in out.values())
    return common.json_line(
        "SCA visible-query fraction per camera, the largest over bevformer_base (synthetic and "
        "real nuScenes rigs) and bevformer_tiny (geometry, not a timing)", worst, "fraction",
        None, device=device, dtype="float32", tool="audit_sca_capacity", cases=out)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    argparse.ArgumentParser(description="SCA's capacity against the cameras' geometry"
                            ).parse_args(argv)
    return run(common.require_cuda())


if __name__ == "__main__":
    main()
