"""Detection losses: sigmoid focal classification + weighted L1 (or
smooth-L1) regression.

Port of `bevformer_tpu/core/losses.py` (reference
`dense_heads/bevformer_head.py:325-480` and GroupDETR's `:659-683`): per
decoder layer and query group a Hungarian match, the focal loss normalised
by the positive count, and L1 (V2: smooth-L1) on the 10-dim code with
`code_weights`, NaN-guarded; with GroupDETR each layer's terms are the
mean over its groups. The costs of all the matches go to the host in one
transfer (`assigner.assign_costs`).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from bevformer_torch.core.assigner import assign_costs, match_cost
from bevformer_torch.core.boxes import normalize_bbox


def sigmoid_focal_loss(
    logits: torch.Tensor,  # [N, C]
    labels: torch.Tensor,  # [N] int in [0, C] (C = background)
    alpha: float = 0.25,
    gamma: float = 2.0,
) -> torch.Tensor:
    """Elementwise focal loss, summed over classes per sample ([N])."""
    num_classes = logits.shape[-1]
    # label C (background) is an all-zero row
    target = F.one_hot(labels.long(), num_classes + 1)[:, :num_classes].float()
    logits = logits.float()
    p = logits.sigmoid()
    pt = (1.0 - p) * target + p * (1.0 - target)
    focal_weight = (alpha * target + (1.0 - alpha) * (1.0 - target)) * pt.pow(gamma)
    # stable BCE with logits
    bce = logits.clamp(min=0) - logits * target + torch.log1p(torch.exp(-logits.abs()))
    return (bce * focal_weight).sum(-1)


def smooth_l1(diff: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """mmdet SmoothL1Loss elementwise (V2's box loss, beta 1.0)."""
    ad = diff.abs()
    return torch.where(ad < beta, 0.5 * ad * ad / beta, ad - 0.5 * beta)


def single_layer_loss(
    cls_scores: torch.Tensor,  # [B, Q, C]
    bbox_preds: torch.Tensor,  # [B, Q, 10]
    gt_boxes: torch.Tensor,  # [B, G, 9] gravity-centre z, padded
    gt_labels: torch.Tensor,  # [B, G]
    assigned: torch.Tensor,  # [B, Q] the matched gt per query, -1 = background
    code_weights: torch.Tensor,  # [10]
    *,
    num_classes: int = 10,
    cls_loss_weight: float = 2.0,
    bbox_loss_weight: float = 0.25,
    focal_alpha: float = 0.25,
    focal_gamma: float = 2.0,
    bbox_loss: str = "l1",
    smooth_l1_beta: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    b, q, c = cls_scores.shape
    pos = assigned >= 0
    safe_idx = assigned.clamp(min=0)
    labels = torch.where(
        pos, torch.gather(gt_labels.long(), 1, safe_idx),
        torch.full_like(safe_idx, num_classes),
    )
    # classification: avg_factor = positive count (`bevformer_head.py:362-373`,
    # bg_cls_weight = 0 for focal)
    num_pos = pos.sum().float().clamp(min=1.0)
    loss_cls = (
        sigmoid_focal_loss(
            cls_scores.reshape(-1, c), labels.reshape(-1),
            alpha=focal_alpha, gamma=focal_gamma,
        ).sum() / num_pos * cls_loss_weight
    )

    # regression on normalised targets (`bevformer_head.py:380-389`)
    tgt_boxes = torch.gather(
        gt_boxes, 1, safe_idx[..., None].expand(-1, -1, gt_boxes.shape[-1])
    )
    tgt_norm = normalize_bbox(tgt_boxes)  # [B, Q, 10]
    isnotnan = torch.isfinite(tgt_norm).all(-1)
    w = (pos & isnotnan)[..., None].float() * code_weights[None, None, :]
    tgt_norm = torch.nan_to_num(tgt_norm, nan=0.0, posinf=0.0, neginf=0.0)
    diff = bbox_preds.float() - tgt_norm
    l1 = (smooth_l1(diff, smooth_l1_beta) if bbox_loss == "smooth_l1" else diff.abs()) * w
    loss_bbox = l1.sum() / num_pos * bbox_loss_weight
    return torch.nan_to_num(loss_cls), torch.nan_to_num(loss_bbox)


def bevformer_loss(
    preds: Dict[str, torch.Tensor],
    gt_boxes: torch.Tensor,
    gt_labels: torch.Tensor,
    num_gt: torch.Tensor,
    code_weights: Sequence[float],
    *,
    num_classes: int = 10,
    cls_loss_weight: float = 2.0,
    bbox_loss_weight: float = 0.25,
    focal_alpha: float = 0.25,
    focal_gamma: float = 2.0,
    group_detr: int = 1,
    bbox_loss: str = "l1",
    smooth_l1_beta: float = 1.0,
) -> Dict[str, torch.Tensor]:
    """Loss over all decoder layers: `d{i}.loss_cls` / `d{i}.loss_bbox` for
    the inner layers, `loss_cls` / `loss_bbox` for the last, and `total`.
    With `group_detr` > 1 the queries are that many equal groups, each
    matched on its own, and a layer's terms are the mean over them."""
    all_cls = preds["all_cls_scores"]  # [L, B, groups x Q, C]
    all_box = preds["all_bbox_preds"]
    num_layers = all_cls.shape[0]
    q = all_cls.shape[2] // group_detr
    cw = torch.as_tensor(code_weights, dtype=torch.float32, device=all_cls.device)
    weights = dict(cls_weight=cls_loss_weight, bbox_weight=bbox_loss_weight,
                   focal_alpha=focal_alpha, focal_gamma=focal_gamma)
    slices = [(lid, slice(gi * q, (gi + 1) * q))
              for lid in range(num_layers) for gi in range(group_detr)]
    costs = torch.stack([match_cost(all_cls[lid][:, sl].detach(), all_box[lid][:, sl].detach(),
                                    gt_boxes, gt_labels, num_gt, **weights)
                         for lid, sl in slices])
    assigned = assign_costs(costs, num_gt)  # [layers x groups, B, Q]
    losses: Dict[str, torch.Tensor] = {}
    total = 0.0
    for lid in range(num_layers):
        lc_acc, lb_acc = 0.0, 0.0
        for gi in range(group_detr):
            sl = slices[lid * group_detr + gi][1]
            lc, lb = single_layer_loss(
                all_cls[lid][:, sl], all_box[lid][:, sl], gt_boxes, gt_labels,
                assigned[lid * group_detr + gi], cw, num_classes=num_classes,
                cls_loss_weight=cls_loss_weight, bbox_loss_weight=bbox_loss_weight,
                focal_alpha=focal_alpha, focal_gamma=focal_gamma, bbox_loss=bbox_loss,
                smooth_l1_beta=smooth_l1_beta,
            )
            lc_acc = lc_acc + lc / group_detr
            lb_acc = lb_acc + lb / group_detr
        key = "loss" if lid == num_layers - 1 else f"d{lid}.loss"
        losses[f"{key}_cls"] = lc_acc
        losses[f"{key}_bbox"] = lb_acc
        total = total + lc_acc + lb_acc
    losses["total"] = total
    return losses
