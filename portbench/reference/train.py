"""The training step of bevformer_base in plain PyTorch: the history
frames' BEV without gradient, the trained frame, the Hungarian-matched
focal and L1 losses over every decoder layer, the global gradient clip and
AdamW with the backbone's lower rate and the warm-up schedule.

A frozen copy of the semantics of `bevformer_torch/runtime/train.py`,
`runtime/optim.py`, `core/losses.py` and `core/assigner.py` at commit
05c7fb4, with the AdamW update written out. Nothing here imports the
program.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import ops
from portbench.reference.model import Detector, Draws


def history_bev(model: Detector, batch: Dict[str, torch.Tensor]):
    """The BEV of frames 0..T-2 in eval mode without gradient, and the
    trained frame's history flag."""
    images = batch["images"]
    bs, t, cams, h, w, _ = images.shape
    c = model.c
    model.eval()
    try:
        with torch.no_grad():
            feats = model.extract_feat(images[:, : t - 1].reshape(bs * (t - 1), cams, h, w, 3))
            feats = [f.view(bs, t - 1, cams, *f.shape[1:]) for f in feats]
            prev = torch.zeros((bs, c.bev_h * c.bev_w, c.embed_dims), device=images.device)
            has = torch.zeros((bs,), dtype=torch.bool, device=images.device)
            for i in range(t - 1):
                has = has & batch["prev_exists"][:, i]
                prev = model.forward_v1(None, batch["can_bus"][:, i], batch["lidar2img"][:, i],
                                        prev, has, only_bev=True,
                                        feats=[f[:, i].reshape(bs * cams, *f.shape[3:])
                                               for f in feats])
                has = torch.ones_like(has)
    finally:
        model.train()
    return prev, batch["prev_exists"][:, t - 1]


def focal(logits, labels, alpha, gamma):
    c = logits.shape[-1]
    target = F.one_hot(labels, c + 1)[:, :c].float()
    p = logits.sigmoid()
    pt = (1.0 - p) * target + p * (1.0 - target)
    weight = (alpha * target + (1.0 - alpha) * (1.0 - target)) * pt.pow(gamma)
    bce = logits.clamp(min=0) - logits * target + torch.log1p(torch.exp(-logits.abs()))
    return (bce * weight).sum(-1)


@torch.no_grad()
def match(cls_pred, bbox_pred, gt_boxes, gt_labels, n, c) -> np.ndarray:
    """The gt index each query is assigned to (-1: background), for one
    sample: focal class cost + L1 on the first 8 code dims, solved by
    scipy's linear_sum_assignment over the sample's `n` boxes."""
    from scipy.optimize import linear_sum_assignment

    eps, a, g = 1e-12, c.focal_alpha, c.focal_gamma
    p = cls_pred.sigmoid()
    neg = -(1.0 - p + eps).log() * (1.0 - a) * p.pow(g)
    pos = -(p + eps).log() * a * (1.0 - p).pow(g)
    lab = gt_labels[:n]
    cost = (pos[:, lab] - neg[:, lab]) * c.cls_loss_weight
    gt_norm = ops.normalize_bbox(gt_boxes[:n])
    cost = cost + (bbox_pred[:, None, :8] - gt_norm[None, :, :8]).abs().sum(-1) * c.bbox_loss_weight
    cost = np.nan_to_num(cost.double().cpu().numpy(), nan=1e8, posinf=1e8, neginf=-1e8)
    out = np.full((cls_pred.shape[0],), -1, np.int64)
    rows, cols = linear_sum_assignment(cost)
    out[rows] = cols
    return out


def loss(preds, batch, c, match_on=None) -> torch.Tensor:
    """Sum over decoder layers of the focal and the weighted L1 terms, each
    divided by the positive count (batch of one). The queries are matched
    on `match_on` (the program's head outputs of the step, whose match the
    reference works out again), or on `preds`."""
    n = int(batch["num_gt"][0])
    gt_boxes, gt_labels = batch["gt_boxes"][0], batch["gt_labels"][0].long()
    cw = torch.tensor(c.code_weights, dtype=torch.float32, device=gt_boxes.device)
    total = 0.0
    on = preds if match_on is None else match_on
    for lid, (cls, box) in enumerate(zip(preds["all_cls_scores"][:, 0],
                                         preds["all_bbox_preds"][:, 0])):
        m_cls, m_box = on["all_cls_scores"][lid, 0].detach(), on["all_bbox_preds"][lid, 0].detach()
        assigned = torch.from_numpy(match(m_cls, m_box, gt_boxes, gt_labels,
                                          min(n, cls.shape[0]), c)).to(cls.device)
        pos = assigned >= 0
        safe = assigned.clamp(min=0)
        labels = torch.where(pos, gt_labels[safe], torch.full_like(safe, c.num_classes))
        num_pos = pos.sum().float().clamp(min=1.0)
        loss_cls = focal(cls, labels, c.focal_alpha, c.focal_gamma).sum() / num_pos
        tgt = ops.normalize_bbox(gt_boxes[safe])
        w = (pos & torch.isfinite(tgt).all(-1))[:, None].float() * cw[None]
        tgt = torch.nan_to_num(tgt, nan=0.0, posinf=0.0, neginf=0.0)
        loss_box = ((box - tgt).abs() * w).sum() / num_pos
        total = total + torch.nan_to_num(loss_cls * c.cls_loss_weight) \
            + torch.nan_to_num(loss_box * c.bbox_loss_weight)
    return total


class AdamW:
    """AdamW over the trainable parameters (the stem and stages up to
    `frozen_stages` do not train; the rest of the backbone at the lower
    rate), betas (0.9, 0.999), eps 1e-8, the rate linear from a third over
    the warm-up, then cosine; the global L2 clip before it."""

    def __init__(self, model: Detector, c, total_steps: int):
        o = c.optim
        frozen = ("img_backbone.conv1.",) + tuple(
            f"img_backbone.layer{i}." for i in range(1, o.frozen_stages + 1)) \
            if o.frozen_stages >= 0 else ()
        self.o, self.total_steps = o, total_steps
        self.params: List[tuple] = []
        for name, p in model.named_parameters():
            if frozen and name.startswith(frozen):
                p.requires_grad_(False)
                continue
            mult = o.backbone_lr_mult if name.startswith("img_backbone.") else 1.0
            self.params.append((name, p, mult))
        self.m = {n: torch.zeros_like(p) for n, p, _ in self.params}
        self.v = {n: torch.zeros_like(p) for n, p, _ in self.params}
        self.t = 0

    def factor(self, step: int) -> float:
        o = self.o
        if step < o.warmup_iters:
            return o.warmup_ratio + (1.0 - o.warmup_ratio) * step / o.warmup_iters
        decay = max(self.total_steps - o.warmup_iters, 1)
        t = min(step - o.warmup_iters, decay) / decay
        return (1.0 - o.min_lr_ratio) * 0.5 * (1.0 + math.cos(math.pi * t)) + o.min_lr_ratio

    @torch.no_grad()
    def step(self) -> Dict[str, torch.Tensor]:
        """Clip, update, and return each parameter's clipped gradient."""
        grads = {n: p.grad for n, p, _ in self.params if p.grad is not None}
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).float()
        coef = torch.clamp(self.o.grad_clip_norm / (norm + 1e-6), max=1.0)
        lr0 = self.o.lr * self.factor(self.t)
        self.t += 1
        b1, b2, eps = 0.9, 0.999, 1e-8
        out = {}
        for n, p, mult in self.params:
            if n not in grads:  # no gradient reached it: torch's AdamW skips it too
                continue
            g = grads[n] * coef
            out[n] = g
            lr = lr0 * mult
            p.mul_(1.0 - lr * self.o.weight_decay)
            self.m[n].mul_(b1).add_(g, alpha=1 - b1)
            self.v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (self.v[n] / (1 - b2 ** self.t)).sqrt() + eps
            p.addcdiv_(self.m[n], denom, value=-lr / (1 - b1 ** self.t))
            p.grad = None
        return out


def train_step(model: Detector, opt: AdamW, batch, draws: Draws, match_on=None):
    """One step on `batch` with the program's draws, the queries matched on
    `match_on` (see `loss`); (loss, clipped gradients, head outputs, the
    loss with the queries matched on the reference's own outputs)."""
    c = model.c
    model.train()
    draws.used = 0
    prev, has = history_bev(model, batch)
    model.set_draws(draws)
    preds = model.forward_v1(batch["images"][:, -1], batch["can_bus"][:, -1],
                             batch["lidar2img"][:, -1], prev, has)
    total = loss(preds, batch, c, match_on)
    with torch.no_grad():
        own = total.detach() if match_on is None else loss(preds, batch, c)
    total.backward()
    model.set_draws(None)
    if draws.used != len(draws.masks):
        raise RuntimeError(f"the program dropped out {len(draws.masks)} times, "
                           f"the reference {draws.used}")
    return float(total.detach()), opt.step(), {k: v.detach() for k, v in preds.items()
                                                if k != "bev_embed"}, float(own)
