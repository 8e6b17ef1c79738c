"""BEVFormerV2's training step: the history frames' BEVs, the current
frame's detection and DD3D losses, and (through `runtime.train.Trainer`)
the global clip and the AdamW step.

Port of `bevformer_tpu/runtime/train_v2.py` (reference
`detectors/bevformerV2.py:186-224`):
  * each history frame (a nonzero offset of `cfg.frames`) runs `bev_only`
    under `torch.no_grad()` with the model in eval mode (running
    statistics, no dropout), before the current frame moves any BatchNorm
    statistic (JAX `_history_bevs` :57-80); every module's mode is then
    restored;
  * the current frame runs in the model's mode (train: GridMask on its
    images, dropout, BatchNorm batch statistics, every GroupDETR group),
    with the history BEVs fused (JAX `_fused_forward` :147);
  * the loss is `bevformer_loss` (GroupDETR's groups, smooth-L1 boxes) plus
    DD3D's `mono_losses` x `mono_loss_weight` where the config has a mono
    head.

A history frame missing from its scene comes as the current frame's images
(the dataset's fill), and the port encodes it, as the reference and JAX's
`VideoEvaluatorV2` do; JAX's training step multiplies that BEV by 0 instead
(ROADMAP.md §3).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from bevformer_torch.core.losses import bevformer_loss
from bevformer_torch.device import fp32
from bevformer_torch.models import BEVFormerV2

# the DD3D targets as `get_train_sample_v2` names them -> as
# `models.dd3d.assign_targets` takes them
MONO_KEYS = {
    "mono_boxes2d": "boxes2d", "mono_classes": "classes", "mono_num_gt": "num_gt",
    "mono_img_valid": "img_valid", "mono_quat": "box3d_quat", "mono_ctr": "box3d_ctr",
    "mono_depth": "box3d_depth", "mono_size": "box3d_size",
    "mono_attributes": "attributes", "mono_speeds": "speeds",
}


class BatchV2(NamedTuple):
    """One V2 training batch; T = len(cfg.frames) in `frames` order.

      images:         [B, T, cams, H, W, 3] normalised float32
      lidar2img:      [B, T, cams, 4, 4]
      frame_valid:    [B, T] bool (False: the current frame filled in)
      flip:           [B] bool (CropResizeFlip flipped the images)
      bda_mat:        [B, 2, 2] GlobalRotScaleTrans's BEV unwarp
      gt_boxes:       [B, G, 9] gravity-centre z, padded
      gt_labels:      [B, G] int64
      num_gt:         [B] int64
      inv_intrinsics: [B, cams, 3, 3] (the DD3D head's)
      mono_targets:   the DD3D targets per image [B * cams, ...]
                      (`models.dd3d.assign_targets`' keys); a config
                      without the mono head leaves both unread
    """

    images: torch.Tensor
    lidar2img: torch.Tensor
    frame_valid: torch.Tensor
    flip: torch.Tensor
    bda_mat: torch.Tensor
    gt_boxes: torch.Tensor
    gt_labels: torch.Tensor
    num_gt: torch.Tensor
    inv_intrinsics: torch.Tensor
    mono_targets: Dict[str, torch.Tensor]

    def tensors(self) -> List[torch.Tensor]:
        """Every tensor of the batch (for `record_stream`)."""
        return list(self[:9]) + list(self.mono_targets.values())


def collate_v2(samples: Sequence[dict], device) -> BatchV2:
    """Stack `NuScenesTemporalDatasetV2.get_train_sample_v2` records into a
    `BatchV2` on `device` (JAX `tools/train.py::_train_v2.collect`). The
    images of samples padded to different sizes are zero-padded to the
    largest (the reference's collate)."""
    def stack(key, dtype):
        return torch.as_tensor(np.stack([s[key] for s in samples]), dtype=dtype, device=device)

    ph = max(s["images"].shape[-3] for s in samples)
    pw = max(s["images"].shape[-2] for s in samples)
    images = torch.stack([
        F.pad(torch.as_tensor(s["images"], device=device),
              (0, 0, 0, pw - s["images"].shape[-2], 0, ph - s["images"].shape[-3]))
        for s in samples])
    mono = {dst: torch.as_tensor(np.concatenate([s[src] for s in samples]), device=device)
            for src, dst in MONO_KEYS.items()}
    mono["classes"] = mono["classes"].long()
    mono["attributes"] = mono["attributes"].long()
    return BatchV2(
        images=images.contiguous(),
        lidar2img=stack("lidar2img", torch.float32),
        frame_valid=stack("frame_valid", torch.bool),
        flip=stack("flip", torch.bool),
        bda_mat=stack("bda_mat", torch.float32),
        gt_boxes=stack("gt_boxes", torch.float32),
        gt_labels=stack("gt_labels", torch.int64),
        num_gt=stack("num_gt", torch.int64),
        inv_intrinsics=stack("inv_intrinsics", torch.float32),
        mono_targets=mono,
    )


@contextlib.contextmanager
def eval_mode(model: torch.nn.Module):
    """Every module in eval mode within the block, each module's own mode
    restored after it."""
    modes = [(m, m.training) for m in model.modules()]
    model.eval()
    try:
        yield model
    finally:
        for m, mode in modes:
            m.training = mode


def history_bevs(model: BEVFormerV2, batch: BatchV2) -> List[Optional[torch.Tensor]]:
    """Each nonzero offset's BEV [B, HW, e] (None at offset 0), encoded in
    eval mode without gradient."""
    c = model.cfg
    if len(c.frames) == 1:
        return [None]
    with eval_mode(model), torch.no_grad():
        return [None if off == 0 else
                model.bev_only(batch.images[:, i], batch.lidar2img[:, i], batch.flip,
                               batch.bda_mat)
                for i, off in enumerate(c.frames)]


def loss_fn_v2(model: BEVFormerV2, batch: BatchV2
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total loss and its terms (the detection terms of every decoder
    layer, and the DD3D terms `*_mono`), the current frame run in the
    model's mode. The losses are computed in fp32."""
    c = model.cfg
    prev = history_bevs(model, batch)
    cur = c.frames.index(0)
    preds, mono_feats = model(batch.images[:, cur], batch.lidar2img[:, cur], prev, batch.flip,
                              batch.bda_mat, return_mono_feats=True)
    # the head reads every GroupDETR group in train mode, the first in eval
    groups = preds["all_cls_scores"].shape[2] // c.num_query
    with fp32(batch.images.device):
        losses = bevformer_loss(
            preds, batch.gt_boxes, batch.gt_labels, batch.num_gt, c.code_weights,
            num_classes=c.num_classes, cls_loss_weight=c.cls_loss_weight,
            bbox_loss_weight=c.bbox_loss_weight, focal_alpha=c.focal_alpha,
            focal_gamma=c.focal_gamma, group_detr=groups, bbox_loss=c.bbox_loss,
            smooth_l1_beta=c.smooth_l1_beta,
        )
        if mono_feats is not None:
            for k, v in model.mono_losses(mono_feats, batch.inv_intrinsics,
                                          batch.mono_targets).items():
                losses[k] = v
                losses["total"] = losses["total"] + v
    return losses["total"], losses
