"""BEVFormerHead: the BEV query embedding, the object queries, the learned
BEV positional encoding, the transformer (v1's, or V2's for
`version="v2"`) and the per-layer cls/reg branches. Port of
`bevformer_tpu/models/head.py` (reference `dense_heads/bevformer_head.py`).
With GroupDETR (`group_detr > 1`, V2) the query embedding holds every
group's queries: training (the head in train mode) reads all of them, the
groups apart in the decoder's self-attention (JAX `head.py:209-230`), and
inference reads the first group's (`bevformer_head.py:527-528`).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from bevformer_torch.configs import BEVFormerConfig
from bevformer_torch.models.layers import (
    Fp32Linear,
    LearnedPositionalEncoding,
    inverse_sigmoid,
    layer_norm,
)
from bevformer_torch.models.transformer import PerceptionTransformer
from bevformer_torch.models.transformer_v2 import PerceptionTransformerV2


def bias_init_with_prob(prob: float) -> float:
    return -math.log((1.0 - prob) / prob)


def cls_branch(embed_dims: int, num_classes: int, num_reg_fcs: int) -> nn.Sequential:
    layers = []
    for _ in range(num_reg_fcs):
        layers += [nn.Linear(embed_dims, embed_dims), layer_norm(embed_dims), nn.ReLU()]
    out = Fp32Linear(embed_dims, num_classes)
    nn.init.constant_(out.bias, bias_init_with_prob(0.01))
    return nn.Sequential(*layers, out)


def reg_branch(embed_dims: int, code_size: int, num_reg_fcs: int) -> nn.Sequential:
    layers = []
    for _ in range(num_reg_fcs):
        layers += [nn.Linear(embed_dims, embed_dims), nn.ReLU()]
    return nn.Sequential(*layers, Fp32Linear(embed_dims, code_size))


class BEVFormerHead(nn.Module):
    def __init__(self, cfg: BEVFormerConfig):
        super().__init__()
        c = self.cfg = cfg
        e = c.embed_dims
        self.bev_embedding = nn.Embedding(c.bev_h * c.bev_w, e)
        self.query_embedding = nn.Embedding(c.num_query * c.group_detr, e * 2)
        self.positional_encoding = LearnedPositionalEncoding(e // 2, c.bev_h, c.bev_w)
        common = dict(
            embed_dims=e,
            num_feature_levels=c.num_feature_levels,
            num_cams=c.data.num_cams,
            encoder_layers=c.encoder_layers,
            decoder_layers=c.decoder_layers,
            num_heads=c.num_heads,
            feedforward_channels=c.feedforward_channels,
            num_points_in_pillar=c.num_points_in_pillar,
            pc_range=c.pc_range,
            sca_num_points=c.sca_num_points,
            tsa_num_points=c.tsa_num_points,
            sca_capacity_ratio=c.sca_capacity_ratio,
            ffn_dropout=c.ffn_dropout,
            use_remat=c.use_remat,
        )
        if c.version == "v2":
            self.transformer = PerceptionTransformerV2(
                frames=c.frames, num_fusion=c.num_fusion, inter_channels=c.inter_channels,
                **common)
        else:
            self.transformer = PerceptionTransformer(rotate_center=c.rotate_center, **common)
        self.cls_branches = nn.ModuleList(
            cls_branch(e, c.num_classes, c.num_reg_fcs) for _ in range(c.decoder_layers)
        )
        self.reg_branches = nn.ModuleList(
            reg_branch(e, c.code_size, c.num_reg_fcs) for _ in range(c.decoder_layers)
        )

    def forward(
        self,
        mlvl_feats: Sequence[torch.Tensor],  # [bs*cams, e, h, w] per level
        can_bus: Optional[torch.Tensor],  # [bs, 18] (v1)
        lidar2img: torch.Tensor,  # [bs, cams, 4, 4]
        prev_bev: Optional[torch.Tensor],  # [bs, HW, e] (v1)
        has_prev: Optional[torch.Tensor],  # [bs] bool (v1)
        only_bev: bool = False,
        prev_bev_list: Optional[List[Optional[torch.Tensor]]] = None,  # V2: per frame
        bda_mat: Optional[torch.Tensor] = None,  # V2: [bs, 2, 2] BEV unwarp
        img_shape: Optional[Tuple[int, int]] = None,  # V2: the padded batch's (H, W)
    ):
        """Head outputs, or only the BEV features [bs, HW, e] (encoder only,
        for the history frames of a training sample (v1) or of a sample
        (V2)). v1 takes the CAN bus and the prev-BEV carry; V2 takes the
        other frames' BEVs, the unwarp matrix and the images' padded size,
        which the camera projections are divided by (`img_size` where it is
        not given: a training resize above 640 rows pads to more)."""
        c = self.cfg
        bs = lidar2img.shape[0]
        bev_pos = self.positional_encoding(bs)
        v2 = c.version == "v2"
        img_shape = tuple(img_shape) if img_shape is not None else c.data.img_size
        if only_bev:
            if v2:
                return self.transformer.get_bev_features(
                    mlvl_feats, self.bev_embedding.weight, bev_pos, c.bev_h, c.bev_w,
                    lidar2img, img_shape, bda_mat,
                )
            return self.transformer.get_bev_features(
                mlvl_feats, self.bev_embedding.weight, bev_pos, c.bev_h, c.bev_w,
                c.grid_length, can_bus, lidar2img, c.data.img_size, prev_bev,
                has_prev,
            )

        def reg_branch_fn(lid, states):
            return self.reg_branches[lid](states)

        if v2:
            groups = c.group_detr if self.training else 1
            bev_embed, hs, init_reference, inter_references = self.transformer(
                mlvl_feats, self.bev_embedding.weight,
                self.query_embedding.weight[:c.num_query * groups], bev_pos, c.bev_h, c.bev_w,
                lidar2img, img_shape, prev_bev_list, bda_mat, reg_branch_fn, groups,
            )
        else:
            bev_embed, hs, init_reference, inter_references = self.transformer(
                mlvl_feats,
                self.bev_embedding.weight,
                self.query_embedding.weight,
                bev_pos,
                c.bev_h,
                c.bev_w,
                c.grid_length,
                can_bus,
                lidar2img,
                c.data.img_size,
                prev_bev,
                has_prev,
                reg_branch_fn=reg_branch_fn,
            )
        # per-layer outputs with the reference de-normalised
        # (`bevformer_head.py:175-203`)
        x0, y0, z0, x1, y1, z1 = c.pc_range
        classes, coords = [], []
        for lvl in range(hs.shape[0]):
            reference = init_reference if lvl == 0 else inter_references[lvl - 1]
            reference = inverse_sigmoid(reference)
            out_cls = self.cls_branches[lvl](hs[lvl])
            tmp = self.reg_branches[lvl](hs[lvl])
            xy = (tmp[..., 0:2] + reference[..., 0:2]).sigmoid()
            z = (tmp[..., 4:5] + reference[..., 2:3]).sigmoid()
            coord = torch.cat(
                [
                    xy[..., 0:1] * (x1 - x0) + x0,
                    xy[..., 1:2] * (y1 - y0) + y0,
                    tmp[..., 2:4],
                    z * (z1 - z0) + z0,
                    tmp[..., 5:],
                ],
                dim=-1,
            )
            classes.append(out_cls)
            coords.append(coord)
        return {
            "bev_embed": bev_embed,
            "all_cls_scores": torch.stack(classes),
            "all_bbox_preds": torch.stack(coords),
        }
