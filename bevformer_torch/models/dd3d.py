"""The DD3D perspective head of BEVFormerV2, training only: FCOS2D, FCOS3D
and the nuScenes attribute and speed predictors over the neck's levels of
each camera, and their losses against per-camera targets.

Port of `bevformer_tpu/models/dd3d.py` (reference `dd3d/modeling/
nuscenes_dd3d.py:314-451`, `fcos2d.py`, `fcos3d.py`, `prepare_targets.py`,
`disentangled_box3d_loss.py`), computed outside any kernel: cuDNN
convolutions and plain PyTorch. The GT of a camera is padded to a static
count; the FCOS assignment runs vectorised over (image, location, gt) on
the targets' device, and positives are masks. Like the reference, there is
no inference. Submodules carry the reference `.pth` keys
(`fcos2d_head.cls_tower.{i}.weight` / `.norm.{level}`,
`fcos3d_head.box3d_quat.0`, `scales_*.{level}.scale`,
`offsets_depth.{level}.bias`, ...); `box3d_depth` has no bias (`use_scale`,
`fcos3d.py:128`).

Two quirks of the reference, kept as the JAX package keeps them:
  * `DisentangledBox3DLoss` clamps without assigning the result
    (`disentangled_box3d_loss.py:34`): no clamp;
  * the attribute loss multiplies a scalar mean cross-entropy by the
    centerness weights and divides by their sum (`nuscenes_dd3d.py:241-242`):
    the unweighted mean.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from bevformer_torch.core.losses import smooth_l1

INF = 1e8
MAX_NUM_ATTRIBUTES = 3

# nuScenes canonical box sizes (wlh per class), `bevformerv2-r50-t1-24ep.py`
CANON_BOX_SIZES = (
    (2.3524184, 0.5062202, 1.0413622),
    (0.61416006, 1.7016163, 1.3054738),
    (2.9139307, 10.725025, 3.2832346),
    (1.9751819, 4.641267, 1.74352),
    (2.772134, 6.565072, 3.2474296),
    (0.7800532, 2.138673, 1.4437162),
    (0.6667362, 0.7181772, 1.7616143),
    (0.40246472, 0.4027083, 1.0084083),
    (3.0059454, 12.8197, 4.1213827),
    (2.4986045, 6.9310856, 2.8382742),
)
STRIDES = (8, 16, 32, 64, 128)
SIZES_OF_INTEREST = ((-1, 64), (64, 128), (128, 256), (256, 512), (512, INF))
MEAN_DEPTH_PER_LEVEL = (44.921, 20.252, 11.712, 7.166, 8.548)
STD_DEPTH_PER_LEVEL = (24.331, 9.833, 6.223, 4.611, 8.275)

# corner sign pattern (x, y, z rows), `structures/boxes3d.py:10-14`
_CORNERS = (
    (1, 1, 1, 1, -1, -1, -1, -1),
    (1, -1, -1, 1, 1, -1, -1, 1),
    (1, 1, -1, -1, 1, 1, -1, -1),
)

# the head's hyper-parameters (`bevformerv2-r50-t1-24ep.py`'s DD3D block)
NUM_CONVS = 4
FOCAL_ALPHA, FOCAL_GAMMA = 0.25, 2.0
MIN_DEPTH, MAX_DEPTH = 0.1, 80.0
BOX3D_LOSS_WEIGHT, CONF3D_LOSS_WEIGHT = 2.0, 1.0
SMOOTH_L1_BETA = 0.05
DEPTH_SCALE_INIT, PROJ_CTR_SCALE_INIT, BOX2D_SCALE_INIT = 0.3, 1.0, 1.0
SCALE_DEPTH_FACTOR = 500.0
POS_RADIUS = 1.5
ATTR_LOSS_WEIGHT, SPEED_LOSS_WEIGHT = 0.2, 0.2


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz -> (..., 3, 3) (`boxes3d.py:17-45`)."""
    r, i, j, k = q.unbind(-1)
    two_s = 2.0 / (q * q).sum(-1).clamp(min=1e-12)
    o = torch.stack([
        1 - two_s * (j * j + k * k), two_s * (i * j - k * r), two_s * (i * k + j * r),
        two_s * (i * j + k * r), 1 - two_s * (i * i + k * k), two_s * (j * k - i * r),
        two_s * (i * k - j * r), two_s * (j * k + i * r), 1 - two_s * (i * i + j * j),
    ], -1)
    return o.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 4) wxyz, normalised: every branch computed, the
    trace's where it is positive, else the largest diagonal's."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return x.clamp(min=1e-12).sqrt()

    qw0 = safe_sqrt(1.0 + tr) / 2
    q0 = torch.stack([qw0, (m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0),
                      (m10 - m01) / (4 * qw0)], -1)
    s1 = safe_sqrt(1.0 + m00 - m11 - m22) * 2
    q1 = torch.stack([(m21 - m12) / s1, s1 / 4, (m01 + m10) / s1, (m02 + m20) / s1], -1)
    s2 = safe_sqrt(1.0 + m11 - m00 - m22) * 2
    q2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, s2 / 4, (m12 + m21) / s2], -1)
    s3 = safe_sqrt(1.0 + m22 - m00 - m11) * 2
    q3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3, s3 / 4], -1)
    cond0 = (tr > 0)[..., None]
    cond1 = ((m00 > m11) & (m00 > m22))[..., None]
    cond2 = (m11 > m22)[..., None]
    q = torch.where(cond0, q0, torch.where(cond1, q1, torch.where(cond2, q2, q3)))
    return q / q.norm(dim=-1, keepdim=True).clamp(min=1e-12)


def unproject_points2d(points2d: torch.Tensor, inv_k: torch.Tensor) -> torch.Tensor:
    """[N, 2] pixel coordinates and [N, 3, 3] inverse intrinsics -> [N, 3] rays."""
    homo = torch.cat([points2d, torch.ones_like(points2d[..., :1])], -1)
    return torch.einsum("nij,nj->ni", inv_k, homo)


def allocentric_to_egocentric(quat, proj_ctr, inv_k) -> torch.Tensor:
    """`utils/geometry.py:107-137`: the object's rotation seen along the ray
    through its projected centre."""
    r_obj = quat_to_matrix(quat)
    ray = unproject_points2d(proj_ctr, inv_k)
    z = ray / ray.norm(dim=1, keepdim=True).clamp(min=1e-12)
    y = z.new_tensor([[0.0, 1.0, 0.0]]) - z[:, 1:2] * z
    y = y / y.norm(dim=1, keepdim=True).clamp(min=1e-12)
    x = torch.linalg.cross(y, z, dim=-1)
    r_l2g = torch.stack([x, y, z], dim=-1)
    return matrix_to_quat(r_l2g @ r_obj)


def boxes3d_corners(quat, proj_ctr, depth, size_wlh, inv_k) -> torch.Tensor:
    """[N, 8, 3] camera-frame corners (`boxes3d.py:76-97, 205-209`)."""
    tvec = unproject_points2d(proj_ctr, inv_k) * depth[:, None]
    r = quat_to_matrix(quat / quat.norm(dim=1, keepdim=True).clamp(min=1e-12))
    lwh = size_wlh[:, [1, 0, 2]]
    corners = quat.new_tensor(_CORNERS).t()  # [8, 3]
    corners_obj = 0.5 * lwh[:, None, :] * corners[None]
    return torch.einsum("nij,nkj->nki", r, corners_obj) + tvec[:, None, :]


def bce_with_logits(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Elementwise, in the JAX package's stable form."""
    return logits.clamp(min=0) - logits * target + torch.log1p(torch.exp(-logits.abs()))


def compute_locations(shapes: Sequence[Tuple[int, int]], device) -> List[torch.Tensor]:
    """FCOS feature locations per level, [h*w, 2] (x, y) = stride / 2 +
    index * stride."""
    locs = []
    for (h, w), s in zip(shapes, STRIDES):
        xs = torch.arange(w, dtype=torch.float32, device=device) * s + s // 2
        ys = torch.arange(h, dtype=torch.float32, device=device) * s + s // 2
        yy, xx = torch.meshgrid(ys, xs, indexing="ij")
        locs.append(torch.stack([xx.reshape(-1), yy.reshape(-1)], -1))
    return locs


class LevelNormConv(nn.Conv2d):
    """detectron2's Conv2d with a norm: a 3x3 conv without bias shared by
    the levels, then one BatchNorm per level (`ModuleListDial`,
    `fcos2d.py:77-98`), then ReLU."""

    def __init__(self, channels: int, num_levels: int):
        super().__init__(channels, channels, 3, padding=1, bias=False)
        self.norm = nn.ModuleList(nn.BatchNorm2d(channels) for _ in range(num_levels))

    def forward_levels(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        return [F.relu(self.norm[li](self._conv_forward(x, self.weight, None)))
                for li, x in enumerate(feats)]


def _tower(channels: int, num_levels: int) -> nn.ModuleList:
    return nn.ModuleList(LevelNormConv(channels, num_levels) for _ in range(NUM_CONVS))


def _run_tower(tower: nn.ModuleList, feats):
    for conv in tower:
        feats = conv.forward_levels(feats)
    return feats


def _conv3x3(cin: int, cout: int, bias: bool = True) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1, bias=bias)


class Scale(nn.Module):
    def __init__(self, value: float = 1.0):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor([float(value)]))


class Offset(nn.Module):
    def __init__(self, value: float = 0.0):
        super().__init__()
        self.bias = nn.Parameter(torch.tensor([float(value)]))


class FCOS2DHead(nn.Module):
    def __init__(self, channels: int, num_classes: int, num_levels: int):
        super().__init__()
        self.cls_tower = _tower(channels, num_levels)
        self.box2d_tower = _tower(channels, num_levels)
        self.cls_logits = _conv3x3(channels, num_classes)
        self.box2d_reg = _conv3x3(channels, 4)
        self.centerness = _conv3x3(channels, 1)
        self.scales_box2d_reg = nn.ModuleList(
            Scale(s * BOX2D_SCALE_INIT) for s in STRIDES[:num_levels])


class FCOS3DHead(nn.Module):
    def __init__(self, channels: int, num_classes: int, num_levels: int):
        super().__init__()
        nc = num_classes
        self.box3d_tower = _tower(channels, num_levels)
        self.box3d_quat = nn.Sequential(_conv3x3(channels, 4 * nc))
        self.box3d_ctr = nn.Sequential(_conv3x3(channels, 2 * nc))
        self.box3d_depth = nn.Sequential(_conv3x3(channels, nc, bias=False))
        self.box3d_size = nn.Sequential(_conv3x3(channels, 3 * nc))
        self.box3d_conf = nn.Sequential(_conv3x3(channels, nc))
        self.scales_proj_ctr = nn.ModuleList(
            Scale(s * PROJ_CTR_SCALE_INIT) for s in STRIDES[:num_levels])
        self.scales_size = nn.ModuleList(Scale() for _ in range(num_levels))
        self.scales_conf = nn.ModuleList(Scale() for _ in range(num_levels))
        self.scales_depth = nn.ModuleList(
            Scale(s * DEPTH_SCALE_INIT) for s in STD_DEPTH_PER_LEVEL[:num_levels])
        self.offsets_depth = nn.ModuleList(Offset(m) for m in MEAN_DEPTH_PER_LEVEL[:num_levels])
        self.register_buffer("mean_depth_per_level",
                             torch.tensor(MEAN_DEPTH_PER_LEVEL[:num_levels]))
        self.register_buffer("std_depth_per_level",
                             torch.tensor(STD_DEPTH_PER_LEVEL[:num_levels]))


def _flat(xs: Sequence[torch.Tensor], d: int) -> torch.Tensor:
    """Per level [N, d, h, w] -> [N, sum(h*w), d], level first."""
    n = xs[0].shape[0]
    return torch.cat([x.permute(0, 2, 3, 1).reshape(n, -1, d) for x in xs], 1).float()


def giou_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """FCOS (l, t, r, b) GIoU loss per location (`layers/iou_loss.py`)."""
    pl, pt, pr, pb = pred.unbind(-1)
    tl, tt, tr, tb = target.unbind(-1)
    target_area = (tl + tr) * (tt + tb)
    pred_area = (pl + pr) * (pt + pb)
    w_int = torch.minimum(pl, tl) + torch.minimum(pr, tr)
    h_int = torch.minimum(pb, tb) + torch.minimum(pt, tt)
    g_w = torch.maximum(pl, tl) + torch.maximum(pr, tr)
    g_h = torch.maximum(pb, tb) + torch.maximum(pt, tt)
    ac = g_w * g_h
    inter = w_int * h_int
    union = target_area + pred_area - inter
    ious = (inter + 1.0) / (union + 1.0)
    gious = ious - (ac - union) / ac.clamp(min=1e-7)
    return 1.0 - gious


@torch.no_grad()
def assign_targets(locations, level_of_loc, size_range, targets: Dict[str, torch.Tensor],
                   num_classes: int, radius: float = POS_RADIUS) -> Dict[str, torch.Tensor]:
    """The vectorised FCOS assignment (`prepare_targets.py:101-219`): each
    location takes the smallest-area GT that holds it within `radius`
    strides of the GT's centre and whose largest regression target falls in
    the location's level range.

    targets (padded to G per image): boxes2d [N, G, 4] xyxy, classes [N, G],
    num_gt [N], img_valid [N], box3d_quat [N, G, 4], box3d_ctr [N, G, 2]
    (projected centre, absolute), box3d_depth [N, G], box3d_size [N, G, 3]
    (wlh), attributes [N, G], speeds [N, G]."""
    n, g = targets["classes"].shape
    p = locations.shape[0]
    xs, ys = locations[:, 0], locations[:, 1]
    boxes = targets["boxes2d"].float()
    x0, y0, x1, y1 = (boxes[:, None, :, i] for i in range(4))  # [N, 1, G]
    xl, yl = xs[None, :, None], ys[None, :, None]  # [1, P, 1]
    reg = torch.stack([xl - x0, yl - y0, x1 - xl, y1 - yl], -1)  # [N, P, G, 4]

    cx = (boxes[..., 0] + boxes[..., 2]) * 0.5
    cy = (boxes[..., 1] + boxes[..., 3]) * 0.5
    strides = locations.new_tensor(STRIDES)[level_of_loc][None, :, None] * radius  # [1, P, 1]
    xmin = torch.maximum(cx[:, None] - strides, x0)
    ymin = torch.maximum(cy[:, None] - strides, y0)
    xmax = torch.minimum(cx[:, None] + strides, x1)
    ymax = torch.minimum(cy[:, None] + strides, y1)
    inside = (xl > xmin) & (xl < xmax) & (yl > ymin) & (yl < ymax)

    max_reg = reg.max(-1).values  # [N, P, G]
    cared = (max_reg >= size_range[None, :, 0:1]) & (max_reg <= size_range[None, :, 1:2])
    area = (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])
    gt_valid = ((torch.arange(g, device=boxes.device)[None, :] < targets["num_gt"][:, None])
                & targets["img_valid"][:, None].bool())
    loc_area = torch.where(inside & cared & gt_valid[:, None, :], area[:, None, :],
                           torch.full_like(max_reg, INF))
    min_area, gt_idx = loc_area.min(-1)  # the first of equal areas
    pos = min_area < INF
    rows = torch.arange(n, device=boxes.device)[:, None]

    def take(field):
        x = targets[field]
        return (x.float() if x.is_floating_point() else x)[rows, gt_idx]

    labels = torch.where(pos, take("classes").long(), torch.full_like(gt_idx, num_classes))
    return {
        "labels": labels,
        "pos": pos,
        "box2d_reg_targets": reg.gather(2, gt_idx[..., None, None].expand(n, p, 1, 4))[:, :, 0],
        "box3d_quat": take("box3d_quat"),
        "box3d_ctr": take("box3d_ctr"),
        "box3d_depth": take("box3d_depth"),
        "box3d_size": take("box3d_size"),
        "attributes": torch.where(pos, take("attributes").long(),
                                  torch.full_like(gt_idx, MAX_NUM_ATTRIBUTES)),
        "speeds": take("speeds"),
    }


class NuscenesDD3D(nn.Module):
    """FCOS2D + FCOS3D + the attribute and speed heads; `forward` returns
    the losses (there is no inference)."""

    def __init__(self, embed_dims: int, num_classes: int, num_levels: int):
        super().__init__()
        self.num_classes = num_classes
        self.num_levels = num_levels
        self.fcos2d_head = FCOS2DHead(embed_dims, num_classes, num_levels)
        self.fcos3d_head = FCOS3DHead(embed_dims, num_classes, num_levels)
        self.attr_logits = _conv3x3(embed_dims, MAX_NUM_ATTRIBUTES)
        self.speed = _conv3x3(embed_dims, 1)

    def forward(self, features: Sequence[torch.Tensor], inv_intrinsics: torch.Tensor,
                targets: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """features: per level [N, C, h, w] (N images); inv_intrinsics [N,
        3, 3]; targets as `assign_targets` takes them. BatchNorm follows the
        module's mode (train: batch statistics)."""
        h2, h3 = self.fcos2d_head, self.fcos3d_head
        nc = self.num_classes
        n = features[0].shape[0]
        dev = features[0].device
        cls_tower = _run_tower(h2.cls_tower, features)
        box_tower = _run_tower(h2.box2d_tower, features)
        box3d_tower = _run_tower(h3.box3d_tower, features)

        logits = [h2.cls_logits(x) for x in cls_tower]
        centerness = [h2.centerness(x) for x in box_tower]
        box2d = [F.relu(h2.box2d_reg(x) * s.scale) for x, s in zip(box_tower, h2.scales_box2d_reg)]
        quat_p = [h3.box3d_quat(x) for x in box3d_tower]
        ctr_p = [h3.box3d_ctr(x) * s.scale for x, s in zip(box3d_tower, h3.scales_proj_ctr)]
        depth_p = [h3.box3d_depth(x) * s.scale + o.bias
                   for x, s, o in zip(box3d_tower, h3.scales_depth, h3.offsets_depth)]
        size_p = [h3.box3d_size(x) * s.scale for x, s in zip(box3d_tower, h3.scales_size)]
        conf_p = [h3.box3d_conf(x) * s.scale for x, s in zip(box3d_tower, h3.scales_conf)]
        attr_p = [self.attr_logits(x) for x in cls_tower]
        speed_p = [F.relu(self.speed(x)) for x in cls_tower]

        shapes = [tuple(f.shape[-2:]) for f in features]
        locs = compute_locations(shapes, dev)
        locations = torch.cat(locs, 0)  # [P, 2]
        level_of_loc = torch.cat([torch.full((len(l),), li, dtype=torch.long, device=dev)
                                  for li, l in enumerate(locs)])
        size_range = locations.new_tensor(SIZES_OF_INTEREST)[level_of_loc]

        logits_f = _flat(logits, nc)
        box2d_f = _flat(box2d, 4)
        ctrness_f = _flat(centerness, 1)[..., 0]
        quat_f = _flat(quat_p, 4 * nc).reshape(n, -1, 4, nc)
        ctr_f = _flat(ctr_p, 2 * nc).reshape(n, -1, 2, nc)
        depth_f = _flat(depth_p, nc)
        size_f = _flat(size_p, 3 * nc).reshape(n, -1, 3, nc)
        conf_f = _flat(conf_p, nc)
        attr_f = _flat(attr_p, MAX_NUM_ATTRIBUTES)
        speed_f = _flat(speed_p, 1)[..., 0]

        t = assign_targets(locations, level_of_loc, size_range, targets, nc)
        pos = t["pos"]
        posf = pos.float()
        num_pos = posf.sum().clamp(min=1.0)

        # classification focal loss (`fcos2d.py:197-215`)
        onehot = F.one_hot(t["labels"], nc + 1)[..., :nc].float()
        p_sig = logits_f.sigmoid()
        pt = (1 - p_sig) * onehot + p_sig * (1 - onehot)
        focal_w = (FOCAL_ALPHA * onehot + (1 - FOCAL_ALPHA) * (1 - onehot)) * pt.pow(FOCAL_GAMMA)
        img_valid = targets["img_valid"].float()[:, None, None]
        loss_cls = (bce_with_logits(logits_f, onehot) * focal_w * img_valid).sum() / num_pos

        # centerness targets from the 2D regression targets (`fcos2d.py:21-28`)
        reg_t = t["box2d_reg_targets"]
        lr, tb = reg_t[..., [0, 2]], reg_t[..., [1, 3]]
        ctr_t = ((lr.min(-1).values / lr.max(-1).values.clamp(min=1e-12))
                 * (tb.min(-1).values / tb.max(-1).values.clamp(min=1e-12))).clamp(min=0.0).sqrt()
        ctr_t = ctr_t * posf
        loss_denom = ctr_t.sum().clamp(min=1e-6)
        loss_box2d = (giou_loss(box2d_f, reg_t) * ctr_t).sum() / loss_denom
        loss_centerness = (bce_with_logits(ctrness_f, ctr_t) * posf).sum() / num_pos

        # FCOS3D's disentangled corner loss (`fcos3d.py:236-327`)
        labels_safe = t["labels"].clamp(max=nc - 1)
        sel = F.one_hot(labels_safe, nc).float()
        quat_sel = torch.einsum("npqc,npc->npq", quat_f, sel)
        ctr_sel = torch.einsum("npqc,npc->npq", ctr_f, sel)
        size_sel = torch.einsum("npqc,npc->npq", size_f, sel)
        depth_sel = torch.einsum("npc,npc->np", depth_f, sel)
        conf_sel = torch.einsum("npc,npc->np", conf_f, sel)

        p_total = locations.shape[0]
        locs_nb = locations[None].expand(n, p_total, 2).reshape(-1, 2)
        inv_k_nb = inv_intrinsics.float()[:, None].expand(n, p_total, 3, 3).reshape(-1, 3, 3)

        def fl(x):
            return x.reshape((n * p_total,) + x.shape[2:])

        quat_pred = fl(quat_sel)
        quat_pred = quat_pred / quat_pred.norm(dim=1, keepdim=True).clamp(min=1e-7)
        pixel_size = torch.stack([inv_k_nb[:, 0, 0], inv_k_nb[:, 1, 1]], -1).norm(dim=-1)
        depth_pred = (fl(depth_sel) / (pixel_size * SCALE_DEPTH_FACTOR)).clamp(MIN_DEPTH,
                                                                               MAX_DEPTH)
        ctr_pred = fl(ctr_sel) + locs_nb
        quat_pred = allocentric_to_egocentric(quat_pred, ctr_pred, inv_k_nb)
        canon = locations.new_tensor(CANON_BOX_SIZES)[fl(labels_safe)]
        size_pred = (fl(size_sel).tanh() + 1.0) * canon

        gt_quat, gt_ctr = fl(t["box3d_quat"]), fl(t["box3d_ctr"])
        gt_depth, gt_size = fl(t["box3d_depth"]), fl(t["box3d_size"])
        target_corners = boxes3d_corners(gt_quat, gt_ctr, gt_depth, gt_size, inv_k_nb)
        ctr_flat = ctr_t.reshape(-1)

        losses = {}
        for key, (pq, pc, pd, ps) in {
            "quat": (quat_pred, gt_ctr, gt_depth, gt_size),
            "proj_ctr": (gt_quat, ctr_pred, gt_depth, gt_size),
            "depth": (gt_quat, gt_ctr, depth_pred, gt_size),
            "size": (gt_quat, gt_ctr, gt_depth, size_pred),
        }.items():
            corners = boxes3d_corners(pq, pc, pd, ps, inv_k_nb)
            per_loc = smooth_l1(corners - target_corners, SMOOTH_L1_BETA).reshape(-1, 24).mean(-1)
            losses[f"loss_box3d_{key}"] = BOX3D_LOSS_WEIGHT * (per_loc * ctr_flat).sum() / loss_denom

        ent_pred = boxes3d_corners(quat_pred, ctr_pred, depth_pred, size_pred, inv_k_nb)
        l1_err = (ent_pred - target_corners).abs().reshape(-1, 24).mean(-1)
        conf_flat = conf_sel.reshape(-1)
        loss_conf3d = (CONF3D_LOSS_WEIGHT
                       * (bce_with_logits(conf_flat, torch.exp(-l1_err)) * ctr_flat).sum()
                       / loss_denom)

        # attribute and speed losses (`nuscenes_dd3d.py:204-279`)
        flat_pos = posf.reshape(-1)
        attr_t = t["attributes"].reshape(-1)
        attr_valid = flat_pos * (attr_t != MAX_NUM_ATTRIBUTES).float()
        attr_ce = -F.log_softmax(attr_f.reshape(-1, MAX_NUM_ATTRIBUTES), -1).gather(
            1, attr_t.clamp(max=MAX_NUM_ATTRIBUTES - 1)[:, None])[:, 0]
        loss_attr = ATTR_LOSS_WEIGHT * (attr_ce * attr_valid).sum() / attr_valid.sum().clamp(
            min=1e-6)
        speed_t = t["speeds"].reshape(-1)
        speed_w = ctr_flat * flat_pos * torch.isfinite(speed_t).float()
        sp_l1 = smooth_l1(speed_f.reshape(-1) - torch.nan_to_num(speed_t), 0.05)
        loss_speed = SPEED_LOSS_WEIGHT * (sp_l1 * speed_w).sum() / speed_w.sum().clamp(min=1e-6)

        return {
            "loss_cls": loss_cls,
            "loss_box2d_reg": loss_box2d,
            "loss_centerness": loss_centerness,
            "loss_conf3d": loss_conf3d,
            "loss_attr": loss_attr,
            "loss_speed": loss_speed,
            **losses,
        }
