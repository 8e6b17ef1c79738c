"""BEVFormerV2 detector: backbone with BatchNorm, a neck with extra levels,
the head on V2's transformer and, where `num_mono_levels > 0`, the DD3D
mono head that supervises the camera features in training
(`fcos3d_bbox_head`). Port of `bevformer_tpu/models/detector_v2.py`
(reference `detectors/bevformerV2.py:18-269`). There is no state across
samples: `runtime.eval.VideoEvaluatorV2` and `runtime.train_v2` encode each
history frame with `bev_only`, then run the current frame with their BEVs.
The module's mode is the JAX `training` flag: in train mode GridMask masks
the current frame's images (with `use_grid_mask`), dropout is on, every
BatchNorm takes batch statistics and the head reads every GroupDETR group.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn as nn

from bevformer_torch.configs import BEVFormerConfig
from bevformer_torch.models.dd3d import NuscenesDD3D
from bevformer_torch.models.fpn import FPN
from bevformer_torch.models.grid_mask import GridMask
from bevformer_torch.models.head import BEVFormerHead
from bevformer_torch.models.resnet import ResNet


class BEVFormerV2(nn.Module):
    def __init__(self, cfg: BEVFormerConfig):
        super().__init__()
        self.cfg = cfg
        self.img_backbone = ResNet(
            depth=cfg.backbone_depth,
            out_indices=cfg.backbone_out_indices,
            dcn_stages=cfg.backbone_dcn_stages,
            style=cfg.backbone_style,
            use_remat=cfg.use_remat,
            norm=cfg.backbone_norm,
        )
        # the neck builds the mono head's levels too; the BEV reads the
        # first num_feature_levels (`bevformerV2.py:177-178, 211-212`)
        self.img_neck = FPN(
            in_channels=cfg.neck_in_channels,
            out_channels=cfg.embed_dims,
            num_outs=max(cfg.num_mono_levels, cfg.num_feature_levels),
        )
        self.pts_bbox_head = BEVFormerHead(cfg)
        if cfg.num_mono_levels > 0:
            self.fcos3d_bbox_head = NuscenesDD3D(cfg.embed_dims, cfg.num_classes,
                                                 cfg.num_mono_levels)
        self.grid_mask = GridMask()

    def extract_feat(self, images: torch.Tensor, flip: Optional[torch.Tensor] = None,
                     use_grid_mask: bool = False) -> List[torch.Tensor]:
        """images [bs, cams, H, W, 3] -> every neck level, each [bs*cams, e,
        h, w], flipped left-right for the samples whose images were
        (`flip` [bs] bool; `bevformerV2.py:102-104`)."""
        bs, cams, h, w, _ = images.shape
        imgs = images.reshape(bs * cams, h, w, 3)
        if use_grid_mask:
            imgs = self.grid_mask(imgs)
        feats = self.img_neck(self.img_backbone(imgs.permute(0, 3, 1, 2)))
        if flip is None:
            return feats
        sel = flip.repeat_interleave(cams).view(-1, 1, 1, 1)
        return [torch.where(sel, f.flip(-1), f) for f in feats]

    def bev_only(self, images: torch.Tensor, lidar2img: torch.Tensor,
                 flip: Optional[torch.Tensor] = None,
                 bda_mat: Optional[torch.Tensor] = None) -> torch.Tensor:
        """A history frame's BEV [bs, HW, e] (`bevformerV2.py:165-184`); no
        GridMask."""
        feats = self.extract_feat(images, flip)[: self.cfg.num_feature_levels]
        return self.pts_bbox_head(feats, None, lidar2img, None, None, only_bev=True,
                                  bda_mat=bda_mat, img_shape=images.shape[2:4])

    def forward(self, images: torch.Tensor, lidar2img: torch.Tensor,
                prev_bev_list: Optional[List[Optional[torch.Tensor]]] = None,
                flip: Optional[torch.Tensor] = None,
                bda_mat: Optional[torch.Tensor] = None,
                return_mono_feats: bool = False):
        """Head outputs of the current frame; `prev_bev_list` holds a BEV
        (or None) for each offset of `cfg.frames`, None at offset 0. With
        `return_mono_feats`, (outputs, the first `num_mono_levels` levels of
        the flipped features, or None without a mono head)."""
        c = self.cfg
        feats = self.extract_feat(images, flip,
                                  use_grid_mask=self.training and c.use_grid_mask)
        out = self.pts_bbox_head(feats[: c.num_feature_levels], None, lidar2img, None, None,
                                 prev_bev_list=prev_bev_list, bda_mat=bda_mat,
                                 img_shape=images.shape[2:4])
        if return_mono_feats:
            return out, (feats[: c.num_mono_levels] if c.num_mono_levels else None)
        return out

    def mono_losses(self, mono_feats: Sequence[torch.Tensor], inv_intrinsics: torch.Tensor,
                    mono_targets: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """DD3D's losses over every camera image (`bevformerV2.py:120-153`),
        each x `mono_loss_weight` and keyed `<name>_mono`. inv_intrinsics
        [bs, cams, 3, 3]; the targets per image ([bs * cams, ...])."""
        inv_k = inv_intrinsics.reshape(-1, 3, 3)
        losses = self.fcos3d_bbox_head(mono_feats, inv_k, mono_targets)
        return {f"{k}_mono": v * self.cfg.mono_loss_weight for k, v in losses.items()}
