"""BEVHead with the FreeAnchor loss: the anchor-based alternative detection
head over an encoder-only BEV map.

Port of `bevformer_tpu/models/bev_head.py` (reference
`bevformer/dense_heads/bev_head.py:28-131`, mmdet3d `FreeAnchor3DHead`):
  * anchors: one (w, l, h) size per class x 2 rotations (0, pi/2) at every
    BEV cell, z fixed at -0.9;
  * predictions: 1x1 convs for the class logits [A*C], the box deltas
    [A*9] (DeltaXYZWLHRBBoxCoder with velocity) and the direction [A*2];
  * the positive loss: per ground-truth box, a bag of the `pre_anchor_topk`
    anchors of highest nearest-BEV IoU, its likelihood the softmax-weighted
    sum of class times localisation probabilities;
  * the negative loss: focal-weighted background likelihood, masked by each
    anchor's object probability P(A|B).

Both top-k selections (the bags, and `get_bboxes`' over every anchor and
class) take JAX's `lax.top_k` order: descending, and among equal values
the lowest index first. A bag of a small box holds fewer overlapping
anchors than `pre_anchor_topk` and is filled with IoU-0 anchors, which
enter the loss: `torch.topk` promises no order among ties on either device,
so `top_k` here sorts stably. Parameter names are the JAX module's
(`conv_cls`, `conv_reg`, `conv_dir_cls`).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

# nuScenes anchor sizes per class (w, l, h), in CLASS_NAMES order
ANCHOR_SIZES = (
    (1.95017717, 4.60718145, 1.72270761),  # car
    (2.4560939, 6.73778078, 2.73004906),  # truck
    (2.87427237, 6.38281911, 3.19125332),  # construction_vehicle
    (2.94046906, 10.5, 3.47030982),  # bus
    (2.87427237, 12.01320693, 3.8070603),  # trailer
    (2.53279, 0.60058911, 0.98297065),  # barrier
    (0.76279481, 2.09973778, 1.44403034),  # motorcycle
    (0.66344886, 0.7256437, 1.75748069),  # bicycle
    (0.66344886, 0.7256437, 1.75748069),  # pedestrian
    (0.39694519, 0.40359262, 1.06232151),  # traffic_cone
)
ROTATIONS = (0.0, 1.5707963)
NUM_ANCHORS = len(ANCHOR_SIZES) * len(ROTATIONS)  # per BEV cell


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """`jax.lax.top_k` over the last axis: the k largest values, descending,
    equal values in ascending index order (a stable descending sort)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def generate_anchors(bev_h: int, bev_w: int, pc_range, device=None) -> torch.Tensor:
    """[bev_h * bev_w * A, 9] anchors (x, y, z, w, l, h, yaw, vx, vy), cell
    major, then class, then rotation. Made on the host and moved to
    `device`: the card divides by a scalar as a multiply by its reciprocal,
    which would move cell centres by an ulp against the host's (and JAX's)
    anchors, and with them the order of near-equal IoUs in the bags."""
    x0, y0, _, x1, y1, _ = pc_range
    xs = x0 + (torch.arange(bev_w) + 0.5) * (x1 - x0) / bev_w
    ys = y0 + (torch.arange(bev_h) + 0.5) * (y1 - y0) / bev_h
    yy, xx = torch.meshgrid(ys.float(), xs.float(), indexing="ij")
    hw = bev_h * bev_w
    sizes = torch.tensor(ANCHOR_SIZES, dtype=torch.float32)
    rots = torch.tensor(ROTATIONS, dtype=torch.float32)
    c, r = sizes.shape[0], rots.shape[0]
    anc = torch.zeros((hw, c, r, 9), dtype=torch.float32)
    anc[..., 0] = xx.reshape(-1)[:, None, None]
    anc[..., 1] = yy.reshape(-1)[:, None, None]
    anc[..., 2] = -0.9  # nuScenes anchor z
    anc[..., 3:6] = sizes[None, :, None, :]
    anc[..., 6] = rots[None, None, :]
    return anc.reshape(hw * c * r, 9).to(device)


def decode_deltas(anchors: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """DeltaXYZWLHRBBoxCoder.decode (mmdet3d): diagonal-normalised deltas,
    bottom-z boxes."""
    xa, ya, za = anchors[..., 0], anchors[..., 1], anchors[..., 2]
    wa, la, ha = anchors[..., 3], anchors[..., 4], anchors[..., 5]
    ra = anchors[..., 6]
    diag = torch.sqrt(wa ** 2 + la ** 2)
    x = deltas[..., 0] * diag + xa
    y = deltas[..., 1] * diag + ya
    z = deltas[..., 2] * ha + za + ha / 2.0
    w = torch.exp(deltas[..., 3]) * wa
    l = torch.exp(deltas[..., 4]) * la
    h = torch.exp(deltas[..., 5]) * ha
    r = deltas[..., 6] + ra
    z = z - h / 2.0
    out = [x, y, z, w, l, h, r]
    if deltas.shape[-1] > 7:
        out += [deltas[..., 7] + anchors[..., 7], deltas[..., 8] + anchors[..., 8]]
    return torch.stack(out, -1)


def encode_deltas(anchors: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """DeltaXYZWLHRBBoxCoder.encode (bottom-z boxes)."""
    xa, ya, za = anchors[..., 0], anchors[..., 1], anchors[..., 2]
    wa, la, ha = anchors[..., 3], anchors[..., 4], anchors[..., 5]
    ra = anchors[..., 6]
    xg, yg, zg = boxes[..., 0], boxes[..., 1], boxes[..., 2]
    wg, lg, hg = (boxes[..., 3].clamp(min=1e-3), boxes[..., 4].clamp(min=1e-3),
                  boxes[..., 5].clamp(min=1e-3))
    rg = boxes[..., 6]
    diag = torch.sqrt(wa ** 2 + la ** 2)
    out = [(xg - xa) / diag, (yg - ya) / diag, ((zg + hg / 2.0) - (za + ha / 2.0)) / ha,
           torch.log(wg / wa), torch.log(lg / la), torch.log(hg / ha), rg - ra]
    if boxes.shape[-1] > 7:
        out += [boxes[..., 7] - anchors[..., 7], boxes[..., 8] - anchors[..., 8]]
    return torch.stack(out, -1)


def _to_bev(b: torch.Tensor) -> torch.Tensor:
    """Axis-aligned BEV box (x0, y0, x1, y1), (w, l) swapped where the yaw
    is nearer pi/2 than 0."""
    yaw = b[..., 6]
    swap = torch.sin(yaw).abs() > torch.cos(yaw).abs()
    w = torch.where(swap, b[..., 4], b[..., 3])
    l = torch.where(swap, b[..., 3], b[..., 4])
    return torch.stack([b[..., 0] - w / 2, b[..., 1] - l / 2, b[..., 0] + w / 2,
                        b[..., 1] + l / 2], -1)


def bev_iou_aligned_free(anchors: torch.Tensor, gts: torch.Tensor) -> torch.Tensor:
    """Nearest-BEV IoU (mmdet3d `bbox_overlaps_nearest_3d`), [A, G]."""
    a = _to_bev(anchors)[:, None]
    g = _to_bev(gts)[None]
    ix = (torch.minimum(a[..., 2], g[..., 2]) - torch.maximum(a[..., 0], g[..., 0])).clamp(min=0)
    iy = (torch.minimum(a[..., 3], g[..., 3]) - torch.maximum(a[..., 1], g[..., 1])).clamp(min=0)
    inter = ix * iy
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_g = (g[..., 2] - g[..., 0]) * (g[..., 3] - g[..., 1])
    return inter / (area_a + area_g - inter).clamp(min=1e-6)


def positive_bags(anchors: torch.Tensor, boxes: torch.Tensor, num_gt: int, k: int):
    """Each ground-truth box's bag: the k anchors of highest IoU in
    `top_k`'s order. Returns the IoU [A, G] (-1 for padded boxes), the bag
    IoUs [G, k] and the bag's anchor indices [G, k]."""
    gvalid = torch.arange(boxes.shape[0], device=boxes.device) < num_gt
    iou_ag = torch.where(gvalid[None, :], bev_iou_aligned_free(anchors, boxes), -1.0)
    topv, topi = top_k(iou_ag.T, k)
    return iou_ag, topv, topi


class BEVHead(nn.Module):
    """Anchor head over the BEV map [bs, bev_h * bev_w, E] (reference
    `bev_head.py:28-108`)."""

    def __init__(self, cfg, pre_anchor_topk: int = 25, bbox_thr: float = 0.6,
                 gamma: float = 2.0, alpha: float = 0.5, code_size: int = 9):
        super().__init__()
        self.cfg = cfg
        self.pre_anchor_topk, self.bbox_thr = pre_anchor_topk, bbox_thr
        self.gamma, self.alpha, self.code_size = gamma, alpha, code_size
        e = cfg.embed_dims
        self.conv_cls = nn.Conv2d(e, NUM_ANCHORS * cfg.num_classes, 1)
        self.conv_reg = nn.Conv2d(e, NUM_ANCHORS * code_size, 1)
        self.conv_dir_cls = nn.Conv2d(e, NUM_ANCHORS * 2, 1)
        # made once on the host (see `generate_anchors`); `.to(device)` moves them
        self.register_buffer("anchors", generate_anchors(cfg.bev_h, cfg.bev_w, cfg.pc_range),
                             persistent=False)

    def forward(self, bev: torch.Tensor) -> Dict[str, torch.Tensor]:
        c = self.cfg
        bs = bev.shape[0]
        x = bev.reshape(bs, c.bev_h, c.bev_w, c.embed_dims).permute(0, 3, 1, 2)
        a_total = c.bev_h * c.bev_w * NUM_ANCHORS

        def nhwc(conv, n):  # channel a * n + j of cell (h, w) -> row (h * W + w) * A + a
            return conv(x).permute(0, 2, 3, 1).reshape(bs, a_total, n)

        return {"cls": nhwc(self.conv_cls, c.num_classes),
                "reg": nhwc(self.conv_reg, self.code_size),
                "dir": nhwc(self.conv_dir_cls, 2)}

    def loss(self, preds: Dict[str, torch.Tensor], gt_boxes: torch.Tensor,
             gt_labels: torch.Tensor, num_gt: torch.Tensor) -> Dict[str, torch.Tensor]:
        """FreeAnchor learning-to-match loss. gt_boxes [B, G, 9] bottom-z,
        gt_labels [B, G], num_gt [B] (the rest padding)."""
        c = self.cfg
        k = self.pre_anchor_topk
        anchors = self.anchors.to(preds["cls"].device)
        pos, neg = [], []
        for cls_s, reg_s, boxes, labels, ng in zip(preds["cls"], preds["reg"], gt_boxes,
                                                   gt_labels, num_gt):
            gvalid = (torch.arange(boxes.shape[0], device=boxes.device) < ng).float()
            n_valid = gvalid.sum().clamp(min=1.0)
            cls_prob = cls_s.float().sigmoid()
            iou_ag, topv, topi = positive_bags(anchors, boxes.float(), ng, k)

            # the positive bag of each box
            bag_cls = cls_prob[topi, labels.long()[:, None]]  # [G, k]
            tgt_deltas = encode_deltas(anchors[topi], boxes.float()[:, None, :])
            l1 = (reg_s[topi].float() - tgt_deltas).abs()
            beta = 1.0 / 9.0
            sl1 = torch.where(l1 < beta, 0.5 * l1 * l1 / beta, l1 - 0.5 * beta)
            bag_loc = torch.exp(-sl1.sum(-1))
            match_prob = F.softmax(torch.where(topv > -0.5, topv, -1e9) * 100.0, dim=-1)
            bag_prob = (match_prob * bag_cls * bag_loc).sum(-1)
            pos_loss = -torch.log(bag_prob.clamp(1e-12, 1.0))
            pos.append((pos_loss * gvalid).sum() / n_valid * self.alpha)

            # the negative: P(A|B), each anchor's object probability per class
            obj_prob_g = ((iou_ag - self.bbox_thr) / (1.0 - self.bbox_thr)).clamp(0.0, 1.0)
            onehot = (labels.long()[:, None] == torch.arange(c.num_classes,
                                                             device=labels.device)).float()
            pa_b = (obj_prob_g @ (onehot * gvalid[:, None])).clamp(0.0, 1.0)
            neg_prob = cls_prob * (1.0 - pa_b)
            neg_loss = (neg_prob ** self.gamma
                        * -torch.log((1.0 - neg_prob).clamp(1e-12, 1.0))).sum()
            neg.append(neg_loss / (k * n_valid).clamp(min=1.0) * (1.0 - self.alpha))
        pos_t, neg_t = torch.stack(pos), torch.stack(neg)
        return {"loss_positive_bag": pos_t.mean(), "loss_negative_bag": neg_t.mean(),
                "total": (pos_t + neg_t).mean()}

    @torch.no_grad()
    def get_bboxes(self, preds: Dict[str, torch.Tensor], max_num: int = 300
                   ) -> Dict[str, torch.Tensor]:
        """Top-k decode over every (anchor, class) score (the NMS-free test
        path): bboxes [B, max_num, 9], scores, labels."""
        c = self.cfg
        anchors = self.anchors.to(preds["cls"].device)
        out = {"bboxes": [], "scores": [], "labels": []}
        for cls_s, reg_s in zip(preds["cls"], preds["reg"]):
            sc, idx = top_k(cls_s.float().sigmoid().reshape(-1), max_num)
            a_idx = idx // c.num_classes
            out["bboxes"].append(decode_deltas(anchors[a_idx], reg_s[a_idx].float()))
            out["scores"].append(sc)
            out["labels"].append(idx % c.num_classes)
        return {key: torch.stack(v) for key, v in out.items()}
