"""3D box codec: the 10-dim network code to the metric box.

network code: (cx, cy, log w, log l, cz, log h, sin yaw, cos yaw, vx, vy)
metric box  : (cx, cy, cz, w, l, h, yaw, vx, vy), z at the gravity centre

Ports of `bevformer_tpu/core/boxes.py::normalize_bbox` and
`denormalize_bbox` (reference `core/bbox/util.py:4-53`).
"""

from __future__ import annotations

import torch

# nuScenes 10-class detection names, in the order of the reference configs
CLASS_NAMES = (
    "car",
    "truck",
    "construction_vehicle",
    "bus",
    "trailer",
    "barrier",
    "motorcycle",
    "bicycle",
    "pedestrian",
    "traffic_cone",
)


def normalize_bbox(bboxes: torch.Tensor) -> torch.Tensor:
    """Metric 9-dim (or 7-dim) box -> 10-dim (or 8-dim) network code:
    log sizes and yaw as (sin, cos)."""
    rot = bboxes[..., 6:7]
    parts = [
        bboxes[..., 0:1],
        bboxes[..., 1:2],
        bboxes[..., 3:4].log(),
        bboxes[..., 4:5].log(),
        bboxes[..., 2:3],
        bboxes[..., 5:6].log(),
        rot.sin(),
        rot.cos(),
    ]
    if bboxes.shape[-1] > 7:
        parts += [bboxes[..., 7:8], bboxes[..., 8:9]]
    return torch.cat(parts, dim=-1)


def denormalize_bbox(normalized: torch.Tensor) -> torch.Tensor:
    """10-dim (or 8-dim) network code -> metric 9-dim (or 7-dim) box."""
    rot = torch.atan2(normalized[..., 6:7], normalized[..., 7:8])
    parts = [
        normalized[..., 0:1],
        normalized[..., 1:2],
        normalized[..., 4:5],
        normalized[..., 2:3].exp(),
        normalized[..., 3:4].exp(),
        normalized[..., 5:6].exp(),
        rot,
    ]
    if normalized.shape[-1] > 8:
        parts += [normalized[..., 8:9], normalized[..., 9:10]]
    return torch.cat(parts, dim=-1)
