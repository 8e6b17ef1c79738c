"""BEV geometry in fp32: reference points, camera projection, the ego-motion
BEV shift and the prev-BEV rotation; and, in numpy float64 on the host, the
quaternion helpers of the data and evaluation paths.

Ports of `bevformer_tpu/core/geometry.py`, which follows the reference's
`encoder.py:46-149` and `transformer.py:122-156`.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

from bevformer_torch.device import fp32


def quat_to_rot(q) -> np.ndarray:
    """Unit quaternion (w, x, y, z) -> 3x3 rotation matrix (float64)."""
    w, x, y, z = [float(v) for v in q]
    n = math.sqrt(w * w + x * x + y * y + z * z)
    if n > 0:
        w, x, y, z = w / n, x / n, y / n, z / n
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ],
        dtype=np.float64,
    )


def quat_yaw(q) -> float:
    """Yaw (rotation about +z) of quaternion (w, x, y, z): the angle of the
    rotated x axis in the xy plane, pyquaternion's `yaw_pitch_roll[0]` as
    the reference data converter reads it."""
    rot = quat_to_rot(q)
    return float(math.atan2(rot[1, 0], rot[0, 0]))


def reference_points_3d(
    bev_h: int, bev_w: int, z_size: float, num_points_in_pillar: int,
    bs: int = 1, device=None,
) -> torch.Tensor:
    """Pillar reference points [bs, D, bev_h*bev_w, 3], (x, y, z) in [0, 1]."""
    d = num_points_in_pillar
    f32 = torch.float32
    zs = torch.linspace(0.5, z_size - 0.5, d, dtype=f32, device=device) / z_size
    xs = (torch.arange(bev_w, dtype=f32, device=device) + 0.5) / bev_w
    ys = (torch.arange(bev_h, dtype=f32, device=device) + 0.5) / bev_h
    zz = zs[:, None, None].expand(d, bev_h, bev_w)
    xx = xs[None, None, :].expand(d, bev_h, bev_w)
    yy = ys[None, :, None].expand(d, bev_h, bev_w)
    ref = torch.stack([xx, yy, zz], dim=-1).reshape(d, bev_h * bev_w, 3)
    return ref[None].expand(bs, d, bev_h * bev_w, 3)


def reference_points_2d(
    bev_h: int, bev_w: int, bs: int = 1, device=None
) -> torch.Tensor:
    """BEV-plane reference points [bs, bev_h*bev_w, 1, 2], (x, y) in [0, 1]."""
    f32 = torch.float32
    ys = (torch.arange(bev_h, dtype=f32, device=device) + 0.5) / bev_h
    xs = (torch.arange(bev_w, dtype=f32, device=device) + 0.5) / bev_w
    ref = torch.stack(
        [xs.repeat(bev_h), ys.repeat_interleave(bev_w)], dim=-1
    )  # [H*W, 2]
    return ref[None, :, None, :].expand(bs, bev_h * bev_w, 1, 2)


def point_sampling(
    ref_3d: torch.Tensor,
    pc_range: Sequence[float],
    lidar2img: torch.Tensor,
    img_shape: Tuple[int, int],
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Project normalised pillar points into every camera.

    ref_3d [bs, D, Q, 3]; lidar2img [bs, cams, 4, 4]; img_shape (H, W) of
    the padded network input. Returns reference_points_cam
    [bs, cams, Q, D, 2] in [0, 1] image coordinates and bev_mask
    [bs, cams, Q, D]. Computed in fp32, autocast off (the caller keeps TF32
    off).
    """
    with fp32(ref_3d.device):
        return _point_sampling(ref_3d.float(), pc_range, lidar2img.float(), img_shape, eps)


def _point_sampling(ref, pc_range, lidar2img, img_shape, eps):
    x0, y0, z0, x1, y1, z1 = [float(v) for v in pc_range]
    scale = ref.new_tensor([x1 - x0, y1 - y0, z1 - z0])
    offset = ref.new_tensor([x0, y0, z0])
    pts = ref * scale + offset
    pts_h = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)
    cam_pts = torch.einsum("bnij,bdqj->bndqi", lidar2img, pts_h)
    z = cam_pts[..., 2:3]
    in_front = z > eps
    xy = cam_pts[..., 0:2] / torch.clamp(z, min=eps)
    h_img, w_img = img_shape
    xy = xy / xy.new_tensor([float(w_img), float(h_img)])
    mask = (
        in_front[..., 0]
        & (xy[..., 1] > 0.0)
        & (xy[..., 1] < 1.0)
        & (xy[..., 0] > 0.0)
        & (xy[..., 0] < 1.0)
    )
    # [bs, cams, D, Q, ...] -> [bs, cams, Q, D, ...]
    return xy.transpose(2, 3), mask.transpose(2, 3)


def bev_shift(
    delta_x: torch.Tensor,
    delta_y: torch.Tensor,
    ego_angle_rad: torch.Tensor,
    grid_length: Tuple[float, float],
    bev_h: int,
    bev_w: int,
) -> torch.Tensor:
    """Normalised (shift_x, shift_y) [bs, 2] of the BEV grid between frames."""
    grid_length_y, grid_length_x = grid_length
    translation_length = torch.sqrt(delta_x**2 + delta_y**2)
    translation_angle = torch.atan2(delta_y, delta_x)
    bev_angle = ego_angle_rad - translation_angle
    shift_y = translation_length * torch.cos(bev_angle) / grid_length_y / bev_h
    shift_x = translation_length * torch.sin(bev_angle) / grid_length_x / bev_w
    return torch.stack([shift_x, shift_y], dim=-1)


def rotate_image_nearest(
    img_hwc: torch.Tensor, angle_deg: torch.Tensor, center_xy: Tuple[float, float]
) -> torch.Tensor:
    """Rotate [H, W, C] by `angle_deg` counter-clockwise about `center_xy`
    (x, y pixels): torchvision `rotate` on tensors, nearest, zero fill."""
    h, w = img_hwc.shape[0], img_hwc.shape[1]
    cx, cy = center_xy
    rot = angle_deg.float() * (math.pi / 180.0)
    cos_r, sin_r = torch.cos(rot), torch.sin(rot)
    dev = img_hwc.device
    ys = torch.arange(h, dtype=torch.float32, device=dev) + 0.5 - cy
    xs = torch.arange(w, dtype=torch.float32, device=dev) + 0.5 - cx
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    src_x = cos_r * xx - sin_r * yy + (cx - 0.5)
    src_y = sin_r * xx + cos_r * yy + (cy - 0.5)
    ix = torch.round(src_x).long()
    iy = torch.round(src_y).long()
    valid = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    out = img_hwc[iy.clamp(0, h - 1), ix.clamp(0, w - 1)]
    return torch.where(valid[..., None], out, torch.zeros_like(out))


def rotate_prev_bev(
    prev_bev: torch.Tensor,
    angle_deg: torch.Tensor,
    bev_h: int,
    bev_w: int,
    center_xy: Tuple[float, float] = (100.0, 100.0),
) -> torch.Tensor:
    """Rotate per-sample prev BEV maps [bs, bev_h*bev_w, C] by angle_deg [bs]."""
    return torch.stack([
        rotate_image_nearest(
            bev.reshape(bev_h, bev_w, -1), ang, center_xy
        ).reshape(bev_h * bev_w, -1)
        for bev, ang in zip(prev_bev, angle_deg)
    ])
