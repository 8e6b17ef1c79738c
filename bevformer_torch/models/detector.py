"""BEVFormer detector: GridMask (train mode) + backbone + neck + head. Port
of `bevformer_tpu/models/detector.py` (reference `detectors/bevformer.py`);
the video state lives in `runtime.eval.VideoEvaluator`, the training
history in `runtime.train.history_bev`.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn as nn

from bevformer_torch.configs import BEVFormerConfig
from bevformer_torch.models.fpn import FPN
from bevformer_torch.models.grid_mask import GridMask
from bevformer_torch.models.head import BEVFormerHead
from bevformer_torch.models.resnet import ResNet


class BEVFormer(nn.Module):
    def __init__(self, cfg: BEVFormerConfig):
        super().__init__()
        self.cfg = cfg
        self.img_backbone = ResNet(
            depth=cfg.backbone_depth,
            out_indices=cfg.backbone_out_indices,
            dcn_stages=cfg.backbone_dcn_stages,
            style=cfg.backbone_style,
            use_remat=cfg.use_remat,
        )
        self.img_neck = FPN(
            in_channels=cfg.neck_in_channels,
            out_channels=cfg.embed_dims,
            num_outs=cfg.num_feature_levels,
        )
        self.pts_bbox_head = BEVFormerHead(cfg)
        self.grid_mask = GridMask()

    def extract_feat(self, images: torch.Tensor) -> List[torch.Tensor]:
        """images [bs, cams, H, W, 3] -> per level [bs*cams, e, h, w]. In
        train mode (with `use_grid_mask`) GridMask masks the images first.
        The NCHW view of the channels-last images is already in
        channels-last memory order, and the convolutions keep it."""
        bs, cams, h, w, _ = images.shape
        imgs = images.reshape(bs * cams, h, w, 3)
        if self.training and self.cfg.use_grid_mask:
            imgs = self.grid_mask(imgs)
        return self.img_neck(self.img_backbone(imgs.permute(0, 3, 1, 2)))

    def forward(
        self,
        images: Optional[torch.Tensor],  # [bs, cams, H, W, 3] normalised
        can_bus: torch.Tensor,  # [bs, 18]
        lidar2img: torch.Tensor,  # [bs, cams, 4, 4]
        prev_bev: torch.Tensor,  # [bs, bev_h*bev_w, e]
        has_prev: torch.Tensor,  # [bs] bool
        only_bev: bool = False,
        feats: Optional[Sequence[torch.Tensor]] = None,
    ):
        """Head outputs of one frame, or only its BEV features
        (`only_bev`). `feats`: `extract_feat`'s output computed beforehand
        (the training history batches the backbone over its frames), in
        place of `images`."""
        if feats is None:
            feats = self.extract_feat(images)
        return self.pts_bbox_head(
            feats, can_bus, lidar2img, prev_bev, has_prev, only_bev=only_bev
        )
