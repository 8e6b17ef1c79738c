"""Plain PyTorch operations of the reference: multi-scale deformable
attention and the modulated deformable 3x3 convolution as gathers, the BEV
geometry, the box codec and the NMS-free decode.

Frozen copies of the plain versions in `bevformer_torch` at commit 05c7fb4
(`kernels/msda.py::ms_deform_attn_plain`, `kernels/dcn.py::dcn_conv_plain`,
`core/geometry.py`, `core/boxes.py`, `core/coder.py`,
`models/transformer_v2.py::bev_grid_sample`), fp32 only. Nothing here
imports the program.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch

Shapes = Sequence[Tuple[int, int]]


def _corners(loc_l: torch.Tensor, hh: int, ww: int):
    """The four bilinear corners of locations [..., 2] in [0, 1] on an
    hh x ww map (pixel = loc * size - 0.5): for each, the clamped flat
    index, the bilinear weight and whether the corner lies on the map."""
    x = loc_l[..., 0] * ww - 0.5
    y = loc_l[..., 1] * hh - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    tx, ty = x - x0, y - y0
    x0i, y0i = x0.long(), y0.long()
    for dy, dx, wgt in ((0, 0, (1 - tx) * (1 - ty)), (0, 1, tx * (1 - ty)),
                        (1, 0, (1 - tx) * ty), (1, 1, tx * ty)):
        cx, cy = x0i + dx, y0i + dy
        valid = (cx >= 0) & (cx < ww) & (cy >= 0) & (cy < hh)
        yield cy.clamp(0, hh - 1) * ww + cx.clamp(0, ww - 1), wgt, valid


def msda(value: torch.Tensor, spatial_shapes: Shapes, loc: torch.Tensor,
         attw: torch.Tensor) -> torch.Tensor:
    """value [B, K, H, D], loc [B, Q, H, L, P, 2], attw [B, Q, H, L, P] ->
    [B, Q, H*D]: per level and point the bilinear sample of the value map
    (zeros outside) times the weight, summed."""
    b, k, h, d = value.shape
    _, q, _, _, p, _ = loc.shape
    val = value.transpose(1, 2).reshape(b * h, k, d)
    out = value.new_zeros((b * h, q, d))
    start = 0
    for lvl, (hh, ww) in enumerate(spatial_shapes):
        val_l = val[:, start:start + hh * ww]
        start += hh * ww
        w_l = attw[:, :, :, lvl, :]
        for idx, wgt, valid in _corners(loc[:, :, :, lvl], hh, ww):
            cw = (wgt * w_l * valid.float()).transpose(1, 2).reshape(b * h, q, p)
            g = torch.gather(val_l, 1, idx.transpose(1, 2).reshape(b * h, q * p)[:, :, None]
                             .expand(-1, -1, d)).view(b * h, q, p, d)
            out = out + torch.einsum("nqp,nqpd->nqd", cw, g)
    return out.view(b, h, q, d).transpose(1, 2).reshape(b, q, h * d)


def bilinear_gather(img: torch.Tensor, py: torch.Tensor, px: torch.Tensor) -> torch.Tensor:
    """img [b, h, w, c]; pixel coordinates py, px [b, oh, ow, t] ->
    [b, oh, ow, t, c], zeros outside the image."""
    b, h, w, c = img.shape
    flat = img.reshape(b, h * w, c)
    y0, x0 = torch.floor(py), torch.floor(px)
    ty, tx = py - y0, px - x0
    y0, x0 = y0.long(), x0.long()
    bidx = torch.arange(b, device=img.device)[:, None]
    out = 0.0
    for dy, dx, wgt in ((0, 0, (1 - ty) * (1 - tx)), (0, 1, (1 - ty) * tx),
                        (1, 0, ty * (1 - tx)), (1, 1, ty * tx)):
        yy, xx = y0 + dy, x0 + dx
        valid = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        idx = yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)
        g = flat[bidx, idx.reshape(b, -1)].reshape(*idx.shape, c)
        out = out + g * (wgt * valid.float())[..., None]
    return out


def dcn(x: torch.Tensor, off_y: torch.Tensor, off_x: torch.Tensor, mask: torch.Tensor,
        weight: torch.Tensor, stride: int) -> torch.Tensor:
    """DCNv2 3x3: x [B, H, W, C], offsets and mask [B, OH, OW, 9] (tap
    (ky, kx) row-major), weight [9C, Cout] (rows tap-major) -> [B, OH, OW,
    Cout]. Tap (ky, kx) of pixel (oy, ox) samples x at (oy*s - 1 + ky +
    dy, ox*s - 1 + kx + dx)."""
    b, _, _, c = x.shape
    oh, ow = off_y.shape[1], off_y.shape[2]
    dev = x.device
    ys = torch.arange(oh, dtype=torch.float32, device=dev) * stride - 1.0
    xs = torch.arange(ow, dtype=torch.float32, device=dev) * stride - 1.0
    k = torch.arange(3, dtype=torch.float32, device=dev)
    ky, kx = torch.meshgrid(k, k, indexing="ij")
    py = ys[None, :, None, None] + ky.reshape(-1) + off_y
    px = xs[None, None, :, None] + kx.reshape(-1) + off_x
    cols = (bilinear_gather(x, py, px) * mask[..., None]).reshape(b, oh, ow, 9 * c)
    return torch.einsum("bhwi,io->bhwo", cols, weight)


# ---------------------------------------------------------------- geometry

def reference_points_3d(bev_h, bev_w, z_size, num_points, bs, device) -> torch.Tensor:
    """Pillar points [bs, D, bev_h*bev_w, 3], (x, y, z) in [0, 1]."""
    f32 = torch.float32
    zs = torch.linspace(0.5, z_size - 0.5, num_points, dtype=f32, device=device) / z_size
    xs = (torch.arange(bev_w, dtype=f32, device=device) + 0.5) / bev_w
    ys = (torch.arange(bev_h, dtype=f32, device=device) + 0.5) / bev_h
    d = num_points
    ref = torch.stack([xs[None, None, :].expand(d, bev_h, bev_w),
                       ys[None, :, None].expand(d, bev_h, bev_w),
                       zs[:, None, None].expand(d, bev_h, bev_w)], -1)
    return ref.reshape(d, bev_h * bev_w, 3)[None].expand(bs, d, bev_h * bev_w, 3)


def reference_points_2d(bev_h, bev_w, bs, device) -> torch.Tensor:
    """BEV-plane points [bs, bev_h*bev_w, 1, 2], (x, y) in [0, 1]."""
    f32 = torch.float32
    ys = (torch.arange(bev_h, dtype=f32, device=device) + 0.5) / bev_h
    xs = (torch.arange(bev_w, dtype=f32, device=device) + 0.5) / bev_w
    ref = torch.stack([xs.repeat(bev_h), ys.repeat_interleave(bev_w)], -1)
    return ref[None, :, None, :].expand(bs, bev_h * bev_w, 1, 2)


def point_sampling(ref_3d, pc_range, lidar2img, img_shape, eps=1e-5):
    """Pillar points through every camera: ([bs, cams, Q, D, 2] image
    coordinates in [0, 1], [bs, cams, Q, D] visible)."""
    x0, y0, z0, x1, y1, z1 = [float(v) for v in pc_range]
    pts = ref_3d * ref_3d.new_tensor([x1 - x0, y1 - y0, z1 - z0]) + ref_3d.new_tensor([x0, y0, z0])
    pts_h = torch.cat([pts, torch.ones_like(pts[..., :1])], -1)
    cam = torch.einsum("bnij,bdqj->bndqi", lidar2img, pts_h)
    z = cam[..., 2:3]
    xy = cam[..., 0:2] / torch.clamp(z, min=eps)
    h_img, w_img = img_shape
    xy = xy / xy.new_tensor([float(w_img), float(h_img)])
    mask = ((z[..., 0] > eps) & (xy[..., 1] > 0.0) & (xy[..., 1] < 1.0)
            & (xy[..., 0] > 0.0) & (xy[..., 0] < 1.0))
    return xy.transpose(2, 3), mask.transpose(2, 3)


def bev_shift(dx, dy, ego_angle_rad, grid_length, bev_h, bev_w) -> torch.Tensor:
    """The BEV grid's normalised (x, y) shift [bs, 2] between frames."""
    gl_y, gl_x = grid_length
    length = torch.sqrt(dx ** 2 + dy ** 2)
    angle = ego_angle_rad - torch.atan2(dy, dx)
    return torch.stack([length * torch.sin(angle) / gl_x / bev_w,
                        length * torch.cos(angle) / gl_y / bev_h], -1)


def rotate_prev_bev(prev_bev, angle_deg, bev_h, bev_w, center_xy) -> torch.Tensor:
    """Each [bev_h*bev_w, C] map rotated counter-clockwise by its angle
    about `center_xy`, nearest, zeros outside."""
    out = []
    cx, cy = center_xy
    for bev, ang in zip(prev_bev, angle_deg):
        img = bev.reshape(bev_h, bev_w, -1)
        rot = ang.float() * (math.pi / 180.0)
        c, s = torch.cos(rot), torch.sin(rot)
        dev = img.device
        ys = torch.arange(bev_h, dtype=torch.float32, device=dev) + 0.5 - cy
        xs = torch.arange(bev_w, dtype=torch.float32, device=dev) + 0.5 - cx
        yy, xx = torch.meshgrid(ys, xs, indexing="ij")
        ix = torch.round(c * xx - s * yy + (cx - 0.5)).long()
        iy = torch.round(s * xx + c * yy + (cy - 0.5)).long()
        valid = (ix >= 0) & (ix < bev_w) & (iy >= 0) & (iy < bev_h)
        rotated = img[iy.clamp(0, bev_h - 1), ix.clamp(0, bev_w - 1)]
        out.append(torch.where(valid[..., None], rotated, torch.zeros_like(rotated))
                   .reshape(bev_h * bev_w, -1))
    return torch.stack(out)


def bev_grid_sample(bev: torch.Tensor, grid_xy: torch.Tensor) -> torch.Tensor:
    """bev [H, W, C] sampled bilinearly at grid_xy [H, W, 2] in [-1, 1]
    (align_corners False, zeros outside)."""
    h, w, c = bev.shape
    gx = (grid_xy[..., 0] + 1.0) * w / 2.0 - 0.5
    gy = (grid_xy[..., 1] + 1.0) * h / 2.0 - 0.5
    x0, y0 = torch.floor(gx), torch.floor(gy)
    tx, ty = gx - x0, gy - y0
    x0, y0 = x0.long(), y0.long()
    flat = bev.reshape(h * w, c)
    out = torch.zeros_like(bev)
    for dy, dx, wt in ((0, 0, (1 - tx) * (1 - ty)), (0, 1, tx * (1 - ty)),
                       (1, 0, (1 - tx) * ty), (1, 1, tx * ty)):
        xx, yy = x0 + dx, y0 + dy
        valid = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        idx = yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)
        out = out + flat[idx.reshape(-1)].view(h, w, c) * (wt * valid.float())[..., None]
    return out


# ---------------------------------------------------------------- boxes

def normalize_bbox(b: torch.Tensor) -> torch.Tensor:
    """Metric box (cx, cy, cz, w, l, h, yaw, vx, vy) -> the 10-dim code
    (cx, cy, log w, log l, cz, log h, sin, cos, vx, vy)."""
    rot = b[..., 6:7]
    return torch.cat([b[..., 0:2], b[..., 3:4].log(), b[..., 4:5].log(), b[..., 2:3],
                      b[..., 5:6].log(), rot.sin(), rot.cos(), b[..., 7:9]], -1)


def denormalize_bbox(n: torch.Tensor) -> torch.Tensor:
    rot = torch.atan2(n[..., 6:7], n[..., 7:8])
    return torch.cat([n[..., 0:2], n[..., 4:5], n[..., 2:3].exp(), n[..., 3:4].exp(),
                      n[..., 5:6].exp(), rot, n[..., 8:10]], -1)


def decode(cls_scores: torch.Tensor, bbox_preds: torch.Tensor, max_num: int,
           num_classes: int, post_center_range) -> Dict[str, torch.Tensor]:
    """NMS-free decode of one sample's last decoder layer: top-k of the
    flat sigmoid scores over (query, class), their boxes, labels and
    whether the centre lies in `post_center_range`."""
    scores_all = cls_scores.sigmoid().reshape(-1)
    scores, idx = torch.topk(scores_all, min(max_num, scores_all.shape[0]))
    boxes = denormalize_bbox(bbox_preds[idx // num_classes])
    pcr = boxes.new_tensor(post_center_range)
    valid = (boxes[:, :3] >= pcr[:3]).all(1) & (boxes[:, :3] <= pcr[3:]).all(1)
    return dict(bboxes=boxes, scores=scores, labels=idx % num_classes, valid=valid)
