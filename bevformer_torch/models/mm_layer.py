"""Multi-modality (camera + lidar BEV) encoder layer.

Port of `bevformer_tpu/models/mm_layer.py` (reference `MM_BEVFormerLayer`,
`bevformer/modules/encoder.py:415-594`): BEVFormer's TSA -> norm -> SCA ->
norm -> FFN -> norm layer, except that the camera cross-attention's output
is blended with a one-level deformable attention over a lidar BEV map by a
learned scalar (`cross_model_weights`, 0.5 at init):

    query = w * sca(query, cameras) + (1 - w) * msda(query, lidar_bev)

The lidar branch samples the `bev_h x bev_w` lidar map at the current
frame's half of the hybrid 2D references. All three attentions are the
port's modules, so each runs K1 (`kernels.msda`) on the card, and K3/K4 in
backward. With `sca_capacity_ratio` 0 (the default) SCA routes every query.
Registered but unused by every shipped BEVFormer config (no lidar branch in
the released models); provided for parity. Submodules carry the JAX
module names (`self_attn`, `norm1`, `cross_attn`, `lidar_cross_attn`,
`norm2`, `ffn`, `norm3`, `cross_model_weights`).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn

from bevformer_torch.models.attention import (
    CustomMSDeformableAttention,
    SpatialCrossAttention,
    TemporalSelfAttention,
    sca_capacity_routing,
)
from bevformer_torch.models.layers import FFN, layer_norm


class MMBEVFormerLayer(nn.Module):
    def __init__(self, embed_dims=256, num_heads=8, feedforward_channels=512,
                 ffn_dropout=0.1, num_cams=6, num_levels=4, sca_num_points=8,
                 tsa_num_points=4, lidar_num_points=4, sca_capacity_ratio=0.0):
        super().__init__()
        self.sca_capacity_ratio = sca_capacity_ratio
        self.self_attn = TemporalSelfAttention(embed_dims, num_heads, 1, tsa_num_points)
        self.norm1 = layer_norm(embed_dims)
        self.cross_attn = SpatialCrossAttention(
            embed_dims, num_cams, num_heads, num_levels, sca_num_points)
        self.lidar_cross_attn = CustomMSDeformableAttention(
            embed_dims, num_heads, 1, lidar_num_points)
        self.cross_model_weights = nn.Parameter(torch.tensor(0.5))
        self.norm2 = layer_norm(embed_dims)
        self.ffn = FFN(embed_dims, feedforward_channels, ffn_dropout)
        self.norm3 = layer_norm(embed_dims)

    def forward(
        self,
        query: torch.Tensor,  # [bs, q, e]
        value: torch.Tensor,  # [bs, cams, k, e] camera features
        lidar_bev: torch.Tensor,  # [bs, bev_h * bev_w, e] lidar BEV map
        bev_pos: torch.Tensor,  # [bs, q, e]
        value_queue: torch.Tensor,  # [bs, 2, q, e] TSA value (prev, cur)
        hybrid_ref_2d: torch.Tensor,  # [bs, 2, q, 1, 2]
        reference_points_cam: torch.Tensor,  # [bs, cams, q, nz, 2]
        bev_mask: torch.Tensor,  # [bs, cams, q, nz] bool
        spatial_shapes: Sequence[Tuple[int, int]],
        bev_h: int,
        bev_w: int,
    ) -> torch.Tensor:
        query = self.self_attn(query, value_queue, bev_pos, hybrid_ref_2d, bev_h, bev_w)
        query = self.norm1(query)
        routing = sca_capacity_routing(bev_mask, self.sca_capacity_ratio)
        cam = self.cross_attn(query, value, reference_points_cam, bev_mask, spatial_shapes,
                              routing)
        # the current frame's references (`encoder.py:572-580`: ref_2d[bs:])
        lidar = self.lidar_cross_attn(query, lidar_bev, None, hybrid_ref_2d[:, 1],
                                      ((bev_h, bev_w),))
        w = self.cross_model_weights.to(cam.dtype)
        query = self.norm2(w * cam + (1.0 - w) * lidar)
        return self.norm3(self.ffn(query))
