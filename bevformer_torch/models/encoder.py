"""BEVFormer encoder: TSA + SCA + FFN layers over the BEV grid.

Port of `bevformer_tpu/models/encoder.py` (reference `encoder.py:24-406`).
The reference points, the camera projection and the SCA routing are
computed once per frame; the layers run in a Python loop. With
`use_remat`, each layer is recomputed in backward (`layers.remat`), as
JAX's `nn.remat` of its scanned layer (`encoder.py:273-274`).

Within `runtime.parallel.split_queries` on a mesh with an `sp` axis (JAX's
`maybe_shard(..., "dp", "sp", None)`, `encoder.py:243-246` and `:176`),
each rank runs the layers on its range of the BEV queries: the layer
input, `bev_pos` and the references of those queries, and SCA the rows
of the frame's routing (computed over all queries, as one process routes
them) that are theirs (`attention.split_routing`). After each layer
`parallel.gather_queries` hands every rank the whole BEV, from which the
next layer's TSA value queue is built; it sits outside the recomputed
layer, so a recomputation runs no collective.
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
    split_routing,
)
from bevformer_torch.models.layers import FFN, layer_norm, remat
from bevformer_torch.runtime import parallel


class BEVFormerLayer(nn.Module):
    """operation_order = (self_attn, norm, cross_attn, norm, ffn, norm), on
    the queries of `split` (a `runtime.parallel.QuerySplit`; None: all)."""

    def __init__(self, embed_dims=256, num_heads=8, feedforward_channels=512,
                 num_cams=6, num_levels=4, sca_num_points=8, tsa_num_points=4,
                 ffn_dropout=0.1):
        super().__init__()
        self.attentions = nn.ModuleList([
            TemporalSelfAttention(embed_dims, num_heads, 1, tsa_num_points),
            SpatialCrossAttention(
                embed_dims, num_cams, num_heads, num_levels, sca_num_points
            ),
        ])
        self.norms = nn.ModuleList(layer_norm(embed_dims) for _ in range(3))
        self.ffns = nn.ModuleList([FFN(embed_dims, feedforward_channels, ffn_dropout)])

    def forward(self, query, value, bev_pos, value_queue, hybrid_ref_2d,
                reference_points_cam, bev_mask, spatial_shapes, bev_h, bev_w,
                routing, split=None):
        query = self.attentions[0](
            query, value_queue, bev_pos, hybrid_ref_2d, bev_h, bev_w, split
        )
        query = self.norms[0](query)
        query = self.attentions[1](
            query, value, reference_points_cam, bev_mask, spatial_shapes, routing, split
        )
        query = self.norms[1](query)
        return self.norms[2](self.ffns[0](query, split))


class BEVFormerEncoder(nn.Module):
    def __init__(self, num_layers=6, embed_dims=256, num_heads=8,
                 feedforward_channels=512, num_cams=6, num_levels=4,
                 num_points_in_pillar=4,
                 pc_range=(-51.2, -51.2, -5.0, 51.2, 51.2, 3.0),
                 sca_num_points=8, tsa_num_points=4, sca_capacity_ratio=0.0,
                 ffn_dropout=0.1, use_remat=False):
        super().__init__()
        self.use_remat = use_remat
        self.num_points_in_pillar = num_points_in_pillar
        self.pc_range = tuple(pc_range)
        self.sca_capacity_ratio = sca_capacity_ratio
        self.layers = nn.ModuleList(
            BEVFormerLayer(
                embed_dims, num_heads, feedforward_channels, num_cams,
                num_levels, sca_num_points, tsa_num_points, ffn_dropout,
            )
            for _ in range(num_layers)
        )

    def frame_geometry(self, has_prev, shift, lidar2img, img_shape, bev_h: int, bev_w: int):
        """The per-frame work outside the layers: the pillar and BEV-plane
        reference points, their projection into the cameras
        (`point_sampling`), TSA's hybrid references (the prev slot shifted
        by the ego motion) and SCA's routing. Returns
        (reference_points_cam [bs, cams, q, nz, 2], bev_mask [bs, cams, q,
        nz], hybrid_ref_2d [bs, 2, q, 1, 2], routing or None)."""
        bs, dev = lidar2img.shape[0], lidar2img.device
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
        routing = sca_capacity_routing(bev_mask, self.sca_capacity_ratio)
        return reference_points_cam, bev_mask, hybrid_ref_2d, routing

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
        reference_points_cam, bev_mask, hybrid_ref_2d, routing = self.frame_geometry(
            has_prev, shift, lidar2img, img_shape, bev_h, bev_w)
        split = parallel.query_split(bev_h * bev_w)
        if split is not None:
            rows = split.rows
            bev_pos, hybrid_ref_2d = bev_pos[:, rows], hybrid_ref_2d[:, :, rows]
            reference_points_cam, bev_mask = reference_points_cam[:, :, rows], bev_mask[:, :, rows]
            if routing is not None:
                routing = split_routing(routing, split.lo, split.hi)

        # TSA value queue: (prev_bev, initial query) for a sample with
        # history, fixed over the layers; (layer input, layer input) without
        hasq = has_prev.view(bs, 1, 1)
        output = bev_query
        recompute = self.use_remat and torch.is_grad_enabled()
        for layer in self.layers:
            if prev_bev is not None:
                slot0 = torch.where(hasq, prev_bev, output)
                slot1 = torch.where(hasq, bev_query, output)
            else:
                slot0 = slot1 = output
            value_queue = torch.stack([slot0, slot1], dim=1)
            query = output if split is None else output[:, split.rows]
            args = (query, value, bev_pos, value_queue, hybrid_ref_2d,
                    reference_points_cam, bev_mask, spatial_shapes, bev_h, bev_w, routing, split)
            output = parallel.gather_queries(remat(layer, *args) if recompute else layer(*args),
                                             split)
        return output
