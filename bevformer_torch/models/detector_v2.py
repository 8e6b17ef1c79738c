"""BEVFormerV2 detector, inference: backbone with BatchNorm, a neck with
extra levels, and the head on V2's transformer. Port of
`bevformer_tpu/models/detector_v2.py` (reference
`detectors/bevformerV2.py:18-269`) less the DD3D mono head, which only
training runs (`fcos3d_bbox_head`). There is no state across samples:
`runtime.eval.VideoEvaluatorV2` encodes each history frame with
`bev_only`, then runs the current frame with their BEVs.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn

from bevformer_torch.configs import BEVFormerConfig
from bevformer_torch.models.fpn import FPN
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
            norm=cfg.backbone_norm,
        )
        # the neck builds the mono head's levels too (the reference's
        # weights hold them); the BEV reads the first num_feature_levels
        self.img_neck = FPN(
            in_channels=cfg.neck_in_channels,
            out_channels=cfg.embed_dims,
            num_outs=max(cfg.num_mono_levels, cfg.num_feature_levels),
        )
        self.pts_bbox_head = BEVFormerHead(cfg)

    def extract_feat(self, images: torch.Tensor,
                     flip: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
        """images [bs, cams, H, W, 3] -> the BEV's levels, each [bs*cams, e,
        h, w], flipped left-right for the samples whose images were
        (`flip` [bs] bool; `bevformerV2.py:102-104`)."""
        bs, cams, h, w, _ = images.shape
        imgs = images.reshape(bs * cams, h, w, 3).permute(0, 3, 1, 2)
        feats = self.img_neck(self.img_backbone(imgs))[: self.cfg.num_feature_levels]
        if flip is None:
            return feats
        sel = flip.repeat_interleave(cams).view(-1, 1, 1, 1)
        return [torch.where(sel, f.flip(-1), f) for f in feats]

    def bev_only(self, images: torch.Tensor, lidar2img: torch.Tensor,
                 flip: Optional[torch.Tensor] = None,
                 bda_mat: Optional[torch.Tensor] = None) -> torch.Tensor:
        """A history frame's BEV [bs, HW, e] (`bevformerV2.py:165-184`)."""
        return self.pts_bbox_head(self.extract_feat(images, flip), None, lidar2img, None, None,
                                  only_bev=True, bda_mat=bda_mat)

    def forward(self, images: torch.Tensor, lidar2img: torch.Tensor,
                prev_bev_list: Optional[List[Optional[torch.Tensor]]] = None,
                flip: Optional[torch.Tensor] = None,
                bda_mat: Optional[torch.Tensor] = None):
        """Head outputs of the current frame; `prev_bev_list` holds a BEV
        (or None) for each offset of `cfg.frames`, None at offset 0."""
        return self.pts_bbox_head(self.extract_feat(images, flip), None, lidar2img, None, None,
                                  prev_bev_list=prev_bev_list, bda_mat=bda_mat)
