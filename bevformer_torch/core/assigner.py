"""Hungarian (one-to-one) assignment for DETR-style training.

Port of `bevformer_tpu/core/assigner.py` (reference
`hungarian_assigner_3d.py:17-136` and `match_cost.py:7-28`): cost =
FocalLossCost (w=2.0) on the class logits + L1 cost (w=0.25) on the first
8 dims of the normalised box code, solved by scipy's
`linear_sum_assignment` on the host, as the reference does. GT boxes come
padded to a static `max_gt`; padded columns cost 1e8.
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
def hungarian_match(
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
    """Assigned gt index per query [B, Q] (-1 = background), on the
    predictions' device. Matching is discrete: no gradient flows through
    the cost."""
    b, q, _ = cls_pred.shape
    g = gt_boxes.shape[1]
    gt_norm = normalize_bbox(gt_boxes)
    cost = torch.stack([
        focal_cls_cost(cls_pred[i], gt_labels[i].long(), alpha=focal_alpha,
                       gamma=focal_gamma, weight=cls_weight)
        + bbox3d_l1_cost(bbox_pred[i], gt_norm[i], weight=bbox_weight)
        for i in range(b)
    ])  # [B, Q, G]
    # more GTs than queries is infeasible for a one-to-one match: only the
    # first Q GTs take part
    num_gt = num_gt.long().clamp(max=q)
    col_valid = torch.arange(g, device=cost.device)[None, :] < num_gt[:, None]
    cost = torch.where(col_valid[:, None, :], cost, torch.full_like(cost, 1e8))
    assigned = lsa_host(cost.cpu().numpy(), num_gt.cpu().numpy())
    return torch.from_numpy(assigned).to(cls_pred.device)
