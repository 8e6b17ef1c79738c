"""DETR decoder with iterative box refinement: MHA self-attention -> LN ->
single-level deformable cross-attention over the BEV map -> LN -> FFN -> LN.

Port of `bevformer_tpu/models/decoder.py` (reference `decoder.py:52-129`).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn as nn

from bevformer_torch.models.attention import CustomMSDeformableAttention
from bevformer_torch.models.layers import (
    FFN,
    MultiheadAttention,
    inverse_sigmoid,
    layer_norm,
)


class DetrDecoderLayer(nn.Module):
    def __init__(self, embed_dims=256, num_heads=8, feedforward_channels=512):
        super().__init__()
        self.attentions = nn.ModuleList([
            MultiheadAttention(embed_dims, num_heads),
            CustomMSDeformableAttention(embed_dims, num_heads, num_levels=1),
        ])
        self.norms = nn.ModuleList(layer_norm(embed_dims) for _ in range(3))
        self.ffns = nn.ModuleList([FFN(embed_dims, feedforward_channels)])

    def forward(self, query, bev_value, query_pos, reference_points,
                bev_spatial_shape: Tuple[int, int]):
        query = self.norms[0](self.attentions[0](query, query_pos))
        query = self.attentions[1](
            query, bev_value, query_pos, reference_points, (bev_spatial_shape,)
        )
        query = self.norms[1](query)
        return self.norms[2](self.ffns[0](query))


class DetectionTransformerDecoder(nn.Module):
    """Returns the per-layer states [L, bs, q, e] and the per-layer refined
    reference points [L, bs, q, 3] (sigmoid space).

    `reg_branch_fn(layer_idx, states)` gives the raw 10-dim regression used
    for refinement: xy += ref[:2] and z (dim 4) += ref[2] in
    inverse-sigmoid space, then sigmoid."""

    def __init__(self, num_layers=6, embed_dims=256, num_heads=8,
                 feedforward_channels=512):
        super().__init__()
        self.layers = nn.ModuleList(
            DetrDecoderLayer(embed_dims, num_heads, feedforward_channels)
            for _ in range(num_layers)
        )

    def forward(self, query, bev_value, query_pos, reference_points,
                bev_spatial_shape: Tuple[int, int],
                reg_branch_fn: Optional[Callable] = None):
        output = query
        states, refs = [], []
        for lid, layer in enumerate(self.layers):
            ref_input = reference_points[..., :2][:, :, None, :]  # [bs,q,1,2]
            output = layer(output, bev_value, query_pos, ref_input, bev_spatial_shape)
            if reg_branch_fn is not None:
                tmp = reg_branch_fn(lid, output)
                new_xy = tmp[..., 0:2] + inverse_sigmoid(reference_points[..., 0:2])
                new_z = tmp[..., 4:5] + inverse_sigmoid(reference_points[..., 2:3])
                reference_points = torch.cat([new_xy, new_z], dim=-1).sigmoid().detach()
            states.append(output)
            refs.append(reference_points)
        return torch.stack(states), torch.stack(refs)
