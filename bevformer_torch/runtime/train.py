"""Training step: temporal history unroll + loss + AdamW update.

Port of `bevformer_tpu/runtime/train.py` (reference
`detectors/bevformer.py:158-234` and mmcv's OptimizerHook): the
`queue_length - 1` history frames run encoder only, under `torch.no_grad()`
with the model in eval mode (no dropout, no GridMask; the reference switches
to eval, `bevformer.py:161`), their backbone batched over the frames; the
last frame trains, in train mode, with the resulting `prev_bev`.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from bevformer_torch.core.losses import bevformer_loss
from bevformer_torch.device import fp32, precision
from bevformer_torch.models import BEVFormer
from bevformer_torch.runtime.optim import make_optimizer
from bevformer_torch.runtime.train_v2 import loss_fn_v2


class Batch(NamedTuple):
    """One training batch. T = queue_length; the last frame is trained.

    Shapes (B = batch):
      images:      [B, T, cams, H, W, 3]  normalised float32
      can_bus:     [B, T, 18]             relative deltas (union2one format)
      lidar2img:   [B, T, cams, 4, 4]
      prev_exists: [B, T]                 bool (scene continuity per frame)
      gt_boxes:    [B, G, 9]              gravity-centre z, padded
      gt_labels:   [B, G]                 int64
      num_gt:      [B]                    int64
    """

    images: torch.Tensor
    can_bus: torch.Tensor
    lidar2img: torch.Tensor
    prev_exists: torch.Tensor
    gt_boxes: torch.Tensor
    gt_labels: torch.Tensor
    num_gt: torch.Tensor

    def tensors(self):
        """Every tensor of the batch (for `record_stream`)."""
        return list(self)


def collate(samples: Sequence[dict], device) -> Batch:
    """Stack `NuScenesTemporalDataset.get_train_sample` records into a
    `Batch` on `device` (`tools/train.py::collect_batch` of the JAX
    package)."""
    def stack(key, dtype):
        return torch.as_tensor(np.stack([s[key] for s in samples]), dtype=dtype, device=device)

    return Batch(
        images=torch.stack([torch.as_tensor(s["images"], device=device) for s in samples]),
        can_bus=stack("can_bus", torch.float32),
        lidar2img=stack("lidar2img", torch.float32),
        prev_exists=stack("prev_exists", torch.bool),
        gt_boxes=stack("gt_boxes", torch.float32),
        gt_labels=stack("gt_labels", torch.int64),
        num_gt=stack("num_gt", torch.int64),
    )


def history_bev(model: BEVFormer, batch: Batch) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """BEV of frames 0..T-2, encoder only, without gradient
    (`bevformer.py:158-177`); returns (prev_bev, has_prev) for the last
    frame, or (None, all false) when T == 1."""
    bs, t = batch.images.shape[:2]
    if t == 1:
        return None, torch.zeros((bs,), dtype=torch.bool, device=batch.images.device)
    c = model.cfg
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            cams, h, w = batch.images.shape[2:5]
            # one backbone pass over all history frames (`bevformer.py:167`)
            feats = model.extract_feat(
                batch.images[:, : t - 1].reshape(bs * (t - 1), cams, h, w, 3)
            )
            feats = [f.view(bs, t - 1, cams, *f.shape[1:]) for f in feats]
            prev = torch.zeros((bs, c.bev_h * c.bev_w, c.embed_dims),
                               device=batch.images.device)
            has = torch.zeros((bs,), dtype=torch.bool, device=batch.images.device)
            for i in range(t - 1):
                has = has & batch.prev_exists[:, i]  # a scene break resets history
                prev = model(
                    None, batch.can_bus[:, i], batch.lidar2img[:, i], prev, has,
                    only_bev=True,
                    feats=[f[:, i].reshape(bs * cams, *f.shape[3:]) for f in feats],
                )
                has = torch.ones_like(has)
    finally:
        model.train(was_training)
    # the last frame's history validity is its own prev_exists flag
    return prev, batch.prev_exists[:, t - 1]


def loss_fn(model: BEVFormer, batch: Batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total loss and the per-layer terms of the last frame, run in the
    model's current mode (train: dropout and GridMask on). The losses are
    computed in fp32 whatever the autocast around them."""
    c = model.cfg
    prev_bev, has_prev = history_bev(model, batch)
    if prev_bev is None:
        bs = batch.images.shape[0]
        prev_bev = torch.zeros((bs, c.bev_h * c.bev_w, c.embed_dims),
                               device=batch.images.device)
    preds = model(
        batch.images[:, -1], batch.can_bus[:, -1], batch.lidar2img[:, -1],
        prev_bev, has_prev,
    )
    # the head's last layers hand the losses fp32 scores and boxes
    with fp32(batch.images.device):
        losses = bevformer_loss(
            preds, batch.gt_boxes, batch.gt_labels, batch.num_gt, c.code_weights,
            num_classes=c.num_classes, cls_loss_weight=c.cls_loss_weight,
            bbox_loss_weight=c.bbox_loss_weight, focal_alpha=c.focal_alpha,
            focal_gamma=c.focal_gamma,
        )
    return losses["total"], losses


def train_step(model, optimizer, scheduler, params, max_norm: float,
               batch, loss=loss_fn) -> Dict[str, float]:
    """Zero grads, forward + backward (`loss(model, batch)`), global clip,
    AdamW step, scheduler step. Returns the loss terms, `grad_norm` (before
    clipping) and the `lr` this step used."""
    optimizer.zero_grad(set_to_none=True)
    total, losses = loss(model, batch)
    total.backward()
    # global L2 clip over the trainable gradients; the norm before clipping
    grad_norm = torch.nn.utils.clip_grad_norm_(params, max_norm)
    lr = optimizer.param_groups[0]["lr"]
    optimizer.step()
    scheduler.step()
    out = {k: float(v.detach()) for k, v in losses.items()}
    out["grad_norm"] = float(grad_norm)
    out["lr"] = lr
    return out


class Trainer:
    """Model, AdamW, schedule and seed, for a v1 `BEVFormer` (steps on a
    `Batch`) or a `BEVFormerV2` (steps on a `train_v2.BatchV2`, its loss
    `train_v2.loss_fn_v2`). The seed seeds dropout (torch's global
    generators) and GridMask's own generator; the model trains in train
    mode (V2: BatchNorm on batch statistics, its running statistics
    updated). `state_dict` / `load_state_dict` carry all of it, the
    BatchNorms' running statistics with the weights, so a run restored from
    one continues as the run that saved it would have."""

    def __init__(self, model: BEVFormer, total_steps: int, seed: int = 0):
        self.model = model.train()
        self.cfg = model.cfg
        self.loss = loss_fn_v2 if model.cfg.version == "v2" else loss_fn
        torch.manual_seed(seed)
        model.grid_mask.generator.manual_seed(seed)
        self.optimizer, self.scheduler, self.params = make_optimizer(
            model, self.cfg.optim, total_steps
        )

    def step(self, batch: Batch) -> Dict[str, float]:
        """One training step in the config's dtype, whatever the caller's
        TF32 flags."""
        device = next(self.model.parameters()).device
        with precision(self.cfg.dtype, device.type):
            return train_step(self.model, self.optimizer, self.scheduler, self.params,
                              self.cfg.optim.grad_clip_norm, batch, self.loss)

    def state_dict(self) -> dict:
        """Model (reference keys), optimizer, lr schedule, and the random
        generators' states: torch's CPU generator, the card's where the
        model is on one (dropout), GridMask's."""
        rng = {"torch_cpu": torch.get_rng_state(),
               "grid_mask": self.model.grid_mask.generator.get_state()}
        device = next(self.model.parameters()).device
        if device.type == "cuda":
            rng["torch_cuda"] = torch.cuda.get_rng_state(device)
        return {
            "state_dict": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "scheduler": self.scheduler.state_dict(),
            "rng": rng,
        }

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["state_dict"], strict=True)
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])
        rng = state["rng"]
        torch.set_rng_state(rng["torch_cpu"])
        self.model.grid_mask.generator.set_state(rng["grid_mask"])
        device = next(self.model.parameters()).device
        if device.type == "cuda" and "torch_cuda" in rng:
            torch.cuda.set_rng_state(rng["torch_cuda"], device)
