"""BEVFormer encoder: TSA + SCA + FFN layers over the BEV grid.

Port of `bevformer_tpu/models/encoder.py` (reference `encoder.py:24-406`).
The reference points, the camera projection and the SCA routing are
computed once per frame; the layers run in a Python loop.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from bevformer_torch.core import geometry
from bevformer_torch.models.attention import (
    SpatialCrossAttention,
    TemporalSelfAttention,
    sca_capacity_routing,
)
from bevformer_torch.models.layers import FFN, layer_norm


class BEVFormerLayer(nn.Module):
    """operation_order = (self_attn, norm, cross_attn, norm, ffn, norm)."""

    def __init__(self, embed_dims=256, num_heads=8, feedforward_channels=512,
                 num_cams=6, num_levels=4, sca_num_points=8, tsa_num_points=4):
        super().__init__()
        self.attentions = nn.ModuleList([
            TemporalSelfAttention(embed_dims, num_heads, 1, tsa_num_points),
            SpatialCrossAttention(
                embed_dims, num_cams, num_heads, num_levels, sca_num_points
            ),
        ])
        self.norms = nn.ModuleList(layer_norm(embed_dims) for _ in range(3))
        self.ffns = nn.ModuleList([FFN(embed_dims, feedforward_channels)])

    def forward(self, query, value, bev_pos, value_queue, hybrid_ref_2d,
                reference_points_cam, bev_mask, spatial_shapes, bev_h, bev_w,
                routing):
        query = self.attentions[0](
            query, value_queue, bev_pos, hybrid_ref_2d, bev_h, bev_w
        )
        query = self.norms[0](query)
        query = self.attentions[1](
            query, value, reference_points_cam, bev_mask, spatial_shapes, routing
        )
        query = self.norms[1](query)
        return self.norms[2](self.ffns[0](query))


class BEVFormerEncoder(nn.Module):
    def __init__(self, num_layers=6, embed_dims=256, num_heads=8,
                 feedforward_channels=512, num_cams=6, num_levels=4,
                 num_points_in_pillar=4,
                 pc_range=(-51.2, -51.2, -5.0, 51.2, 51.2, 3.0),
                 sca_num_points=8, tsa_num_points=4, sca_capacity_ratio=0.0):
        super().__init__()
        self.num_points_in_pillar = num_points_in_pillar
        self.pc_range = tuple(pc_range)
        self.sca_capacity_ratio = sca_capacity_ratio
        self.layers = nn.ModuleList(
            BEVFormerLayer(
                embed_dims, num_heads, feedforward_channels, num_cams,
                num_levels, sca_num_points, tsa_num_points,
            )
            for _ in range(num_layers)
        )

    def forward(
        self,
        bev_query: torch.Tensor,  # [bs, q, e]
        value: torch.Tensor,  # [bs, cams, k, e]
        bev_pos: torch.Tensor,  # [bs, q, e]
        prev_bev: Optional[torch.Tensor],  # [bs, q, e] or None
        has_prev: torch.Tensor,  # [bs] bool
        shift: torch.Tensor,  # [bs, 2]
        lidar2img: torch.Tensor,  # [bs, cams, 4, 4]
        img_shape: Tuple[int, int],
        spatial_shapes: Sequence[Tuple[int, int]],
        bev_h: int,
        bev_w: int,
    ) -> torch.Tensor:
        bs = bev_query.shape[0]
        dev = bev_query.device
        ref_3d = geometry.reference_points_3d(
            bev_h, bev_w, self.pc_range[5] - self.pc_range[2],
            self.num_points_in_pillar, bs=bs, device=dev,
        )
        ref_2d = geometry.reference_points_2d(bev_h, bev_w, bs=bs, device=dev)
        reference_points_cam, bev_mask = geometry.point_sampling(
            ref_3d, self.pc_range, lidar2img, img_shape
        )
        # the prev slot's references are shifted by the ego motion
        has = has_prev.view(bs, 1, 1, 1)
        prev_ref = torch.where(has, ref_2d + shift[:, None, None, :], ref_2d)
        hybrid_ref_2d = torch.stack([prev_ref, ref_2d], dim=1)  # [bs,2,q,1,2]

        routing = None
        if self.sca_capacity_ratio and self.sca_capacity_ratio < 1.0:
            routing = sca_capacity_routing(bev_mask, self.sca_capacity_ratio)

        # TSA value queue: (prev_bev, initial query) for a sample with
        # history, fixed over the layers; (layer input, layer input) without
        hasq = has_prev.view(bs, 1, 1)
        output = bev_query
        for layer in self.layers:
            if prev_bev is not None:
                slot0 = torch.where(hasq, prev_bev, output)
                slot1 = torch.where(hasq, bev_query, output)
            else:
                slot0 = slot1 = output
            value_queue = torch.stack([slot0, slot1], dim=1)
            output = layer(
                output, value, bev_pos, value_queue, hybrid_ref_2d,
                reference_points_cam, bev_mask, spatial_shapes, bev_h, bev_w,
                routing,
            )
        return output
