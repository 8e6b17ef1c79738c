"""Optimizer: AdamW with parameter groups, warmup + cosine schedule, global
gradient clip.

Port of `bevformer_tpu/runtime/optim.py` (reference
`configs/bevformer/bevformer_base.py:228-244` and mmcv's OptimizerHook):
AdamW lr 2e-4, weight decay 0.01, backbone lr x0.1, clip at L2 norm 35,
linear warmup from lr/3 over 500 steps, then cosine to lr x 1e-3.

Groups by the port's state-dict names: the stem (`img_backbone.conv1`) and
stages 1..`frozen_stages` are frozen with `requires_grad=False`, so no
backward runs below them and the clip sees trainable gradients only; the
rest of `img_backbone.*` is the backbone group; everything else is main.
FrozenBN statistics and affines (v1) are buffers and never train. V2
(`frozen_stages=-1`, JAX `label_params(bn_trainable=True)`) freezes
nothing: its BatchNorms' affines are backbone parameters, the DD3D head
is main, and weight decay covers every trained parameter, as optax's
`add_decayed_weights` does.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn as nn

from bevformer_torch.configs import OptimConfig

FROZEN, BACKBONE, MAIN = "frozen", "backbone", "main"


def _frozen_prefixes(frozen_stages: int) -> Tuple[str, ...]:
    # mmdet ResNet._freeze_stages: 0 freezes the stem, n also stages 1..n
    if frozen_stages < 0:
        return ()
    return ("img_backbone.conv1.",) + tuple(
        f"img_backbone.layer{i}." for i in range(1, frozen_stages + 1)
    )


def label_params(model: nn.Module, frozen_stages: int = 1) -> Dict[str, str]:
    """Parameter name -> 'frozen', 'backbone' or 'main'."""
    prefixes = _frozen_prefixes(frozen_stages)
    labels = {}
    for name, _ in model.named_parameters():
        if prefixes and name.startswith(prefixes):
            labels[name] = FROZEN
        elif name.startswith("img_backbone."):
            labels[name] = BACKBONE
        else:
            labels[name] = MAIN
    return labels


def cosine_lambda(cfg: OptimConfig, total_steps: int):
    """Multiplier of the base lr at a step: optax's
    `join_schedules([linear_schedule(lr * warmup_ratio, lr, warmup),
    cosine_decay_schedule(lr, max(total - warmup, 1), min_lr_ratio)])`
    divided by lr."""
    warmup = cfg.warmup_iters
    decay = max(total_steps - warmup, 1)

    def factor(step: int) -> float:
        if step < warmup:
            return cfg.warmup_ratio + (1.0 - cfg.warmup_ratio) * step / warmup
        t = min(step - warmup, decay) / decay
        return (1.0 - cfg.min_lr_ratio) * 0.5 * (1.0 + math.cos(math.pi * t)) + cfg.min_lr_ratio

    return factor


def make_optimizer(model: nn.Module, cfg: OptimConfig, total_steps: int):
    """Freeze the frozen group (`requires_grad=False`) and return
    (AdamW, LambdaLR, the trainable parameters the clip runs over)."""
    labels = label_params(model, cfg.frozen_stages)
    groups: Dict[str, List[torch.nn.Parameter]] = {BACKBONE: [], MAIN: []}
    for name, p in model.named_parameters():
        if labels[name] == FROZEN:
            p.requires_grad_(False)
        else:
            groups[labels[name]].append(p)
    optimizer = torch.optim.AdamW(
        [
            {"params": groups[MAIN], "lr": cfg.lr},
            {"params": groups[BACKBONE], "lr": cfg.lr * cfg.backbone_lr_mult},
        ],
        lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=cfg.weight_decay,
    )
    scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, cosine_lambda(cfg, total_steps))
    return optimizer, scheduler, groups[MAIN] + groups[BACKBONE]
