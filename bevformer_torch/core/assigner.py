"""Hungarian (one-to-one) assignment for DETR-style training.

Port of `bevformer_tpu/core/assigner.py` (reference
`hungarian_assigner_3d.py:17-136` and `match_cost.py:7-28`): cost =
FocalLossCost (w=2.0) on the class logits + L1 cost (w=0.25) on the first
8 dims of the normalised box code, solved by scipy's
`linear_sum_assignment` on the host, as the reference does. GT boxes come
padded to a static `max_gt`; padded columns cost 1e8.

A training step builds the costs of all its matches (every decoder layer,
and with GroupDETR every group: 66 for bevformerv2-r50-t1) on the
predictions' device and copies them to the host in one transfer
(`assign_costs`, which counts its transfers in `.transfers`).
"""

from __future__ import annotations

import numpy as np
import torch

from bevformer_torch.core.boxes import normalize_bbox


def focal_cls_cost(
    cls_pred: torch.Tensor,  # [Q, C] logits
    gt_labels: torch.Tensor,  # [G] int
    alpha: float = 0.25,
    gamma: float = 2.0,
    weight: float = 2.0,
    eps: float = 1e-12,
) -> torch.Tensor:
    p = cls_pred.float().sigmoid()
    neg = -(1.0 - p + eps).log() * (1.0 - alpha) * p.pow(gamma)
    pos = -(p + eps).log() * alpha * (1.0 - p).pow(gamma)
    return (pos[:, gt_labels] - neg[:, gt_labels]) * weight  # [Q, G]


def bbox3d_l1_cost(
    bbox_pred: torch.Tensor,  # [Q, 10] network code
    gt_normalized: torch.Tensor,  # [G, 10] normalised gt code
    weight: float = 0.25,
) -> torch.Tensor:
    # first 8 dims only (`hungarian_assigner_3d.py:113`)
    diff = (bbox_pred[:, None, :8].float() - gt_normalized[None, :, :8].float()).abs()
    return diff.sum(-1) * weight


def lsa_host(cost: np.ndarray, num_gt: np.ndarray) -> np.ndarray:
    """cost [B, Q, G], num_gt [B] -> assigned gt index per query [B, Q]
    (-1 = background)."""
    from scipy.optimize import linear_sum_assignment

    cost = np.nan_to_num(
        np.asarray(cost, np.float64), nan=1e8, posinf=1e8, neginf=-1e8
    )
    b, q, _ = cost.shape
    out = np.full((b, q), -1, np.int64)
    for i in range(b):
        g = int(num_gt[i])
        if g <= 0:
            continue
        rows, cols = linear_sum_assignment(cost[i, :, :g])
        out[i, rows] = cols
    return out


@torch.no_grad()
def match_cost(
    cls_pred: torch.Tensor,  # [B, Q, C] logits
    bbox_pred: torch.Tensor,  # [B, Q, 10]
    gt_boxes: torch.Tensor,  # [B, G, 9] metric (gravity-centre z), padded
    gt_labels: torch.Tensor,  # [B, G] int, padded
    num_gt: torch.Tensor,  # [B] int
    *,
    cls_weight: float = 2.0,
    bbox_weight: float = 0.25,
    focal_alpha: float = 0.25,
    focal_gamma: float = 2.0,
) -> torch.Tensor:
    """The matching cost [B, Q, G] on the predictions' device, 1e8 in the
    padded columns and in those past Q (a one-to-one match of more GTs
    than queries is infeasible: only the first Q take part). No gradient
    flows through it."""
    b, q, _ = cls_pred.shape
    g = gt_boxes.shape[1]
    gt_norm = normalize_bbox(gt_boxes)
    cost = torch.stack([
        focal_cls_cost(cls_pred[i], gt_labels[i].long(), alpha=focal_alpha,
                       gamma=focal_gamma, weight=cls_weight)
        + bbox3d_l1_cost(bbox_pred[i], gt_norm[i], weight=bbox_weight)
        for i in range(b)
    ])
    col_valid = torch.arange(g, device=cost.device)[None, :] < num_gt.long().clamp(max=q)[:, None]
    return torch.where(col_valid[:, None, :], cost, torch.full_like(cost, 1e8))


def assign_costs(costs: torch.Tensor, num_gt: torch.Tensor) -> torch.Tensor:
    """costs [M, B, Q, G] (M matches) -> the assigned gt index per query
    [M, B, Q] (-1 = background) on the costs' device: one copy of all M
    costs to the host, then scipy per match."""
    assign_costs.transfers += 1
    m, b, q, _ = costs.shape
    host = costs.cpu().numpy()
    ngt = num_gt.long().clamp(max=q).cpu().numpy()
    out = np.stack([lsa_host(c, ngt) for c in host]) if m else np.zeros((0, b, q), np.int64)
    return torch.from_numpy(out).to(costs.device)


assign_costs.transfers = 0


def hungarian_match(
    cls_pred: torch.Tensor,  # [B, Q, C] logits
    bbox_pred: torch.Tensor,  # [B, Q, 10]
    gt_boxes: torch.Tensor,  # [B, G, 9] metric (gravity-centre z), padded
    gt_labels: torch.Tensor,  # [B, G] int, padded
    num_gt: torch.Tensor,  # [B] int
    **weights,
) -> torch.Tensor:
    """Assigned gt index per query [B, Q] (-1 = background) of one match,
    on the predictions' device (`match_cost`'s keywords)."""
    cost = match_cost(cls_pred, bbox_pred, gt_boxes, gt_labels, num_gt, **weights)
    return assign_costs(cost[None], num_gt)[0]
