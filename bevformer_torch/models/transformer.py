"""PerceptionTransformer: CAN-bus conditioned BEV queries, ego-motion shift
and prev-BEV rotation, camera and level embeddings on the flattened
multi-scale features, the encoder, then the decoder from learned reference
points. Port of `bevformer_tpu/models/transformer.py` (reference
`transformer.py:27-289`).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from bevformer_torch.core import geometry
from bevformer_torch.device import fp32
from bevformer_torch.models.decoder import DetectionTransformerDecoder
from bevformer_torch.models.encoder import BEVFormerEncoder
from bevformer_torch.models.layers import Fp32Linear, layer_norm
from bevformer_torch.utils.profiler import span


def flatten_feats(mlvl_feats: Sequence[torch.Tensor], bs: int, cams_embeds: torch.Tensor,
                  level_embeds: torch.Tensor):
    """[bs*cams, e, h, w] per level -> [bs, cams, K, e] with the camera and
    level embeddings added, plus the (h, w) of every level."""
    flat, shapes = [], []
    for lvl, feat in enumerate(mlvl_feats):
        n, e, h, w = feat.shape
        f = feat.flatten(2).transpose(1, 2).reshape(bs, n // bs, h * w, e)
        flat.append(f + cams_embeds[None, :, None, :] + level_embeds[lvl])
        shapes.append((h, w))
    return torch.cat(flat, dim=2), tuple(shapes)


class PerceptionTransformer(nn.Module):
    def __init__(self, embed_dims=256, num_feature_levels=4, num_cams=6,
                 encoder_layers=6, decoder_layers=6, num_heads=8,
                 feedforward_channels=512, num_points_in_pillar=4,
                 pc_range=(-51.2, -51.2, -5.0, 51.2, 51.2, 3.0),
                 sca_num_points=8, tsa_num_points=4, sca_capacity_ratio=0.0,
                 rotate_center=(100.0, 100.0), ffn_dropout=0.1, use_remat=False):
        super().__init__()
        e = embed_dims
        self.embed_dims = e
        self.rotate_center = tuple(rotate_center)
        self.level_embeds = nn.Parameter(torch.randn(num_feature_levels, e))
        self.cams_embeds = nn.Parameter(torch.randn(num_cams, e))
        self.reference_points = Fp32Linear(e, 3)
        self.can_bus_mlp = nn.Sequential(
            nn.Linear(18, e // 2), nn.ReLU(), nn.Linear(e // 2, e), nn.ReLU()
        )
        self.can_bus_mlp.add_module("norm", layer_norm(e))
        self.encoder = BEVFormerEncoder(
            encoder_layers, e, num_heads, feedforward_channels, num_cams,
            num_feature_levels, num_points_in_pillar, pc_range,
            sca_num_points, tsa_num_points, sca_capacity_ratio, ffn_dropout, use_remat,
        )
        self.decoder = DetectionTransformerDecoder(
            decoder_layers, e, num_heads, feedforward_channels, ffn_dropout
        )

    def get_bev_features(
        self,
        mlvl_feats: Sequence[torch.Tensor],
        bev_queries: torch.Tensor,  # [HW, e]
        bev_pos: torch.Tensor,  # [bs, HW, e]
        bev_h: int,
        bev_w: int,
        grid_length: Tuple[float, float],
        can_bus: torch.Tensor,  # [bs, 18]
        lidar2img: torch.Tensor,  # [bs, cams, 4, 4]
        img_shape: Tuple[int, int],
        prev_bev: Optional[torch.Tensor],  # [bs, HW, e]
        has_prev: torch.Tensor,  # [bs] bool
    ) -> torch.Tensor:
        bs = can_bus.shape[0]
        queries = bev_queries[None].expand(bs, bev_h * bev_w, self.embed_dims)
        shift = geometry.bev_shift(
            can_bus[:, 0], can_bus[:, 1], can_bus[:, -2], grid_length, bev_h, bev_w
        )
        if prev_bev is not None:
            # in fp32 (the JAX package rotates an fp32 copy)
            prev_bev = prev_bev.float()
            with fp32(prev_bev.device):
                rotated = geometry.rotate_prev_bev(
                    prev_bev, can_bus[:, -1], bev_h, bev_w, self.rotate_center
                )
            prev_bev = torch.where(has_prev.view(bs, 1, 1), rotated, prev_bev)
        queries = queries + self.can_bus_mlp(can_bus)[:, None, :]
        value, spatial_shapes = flatten_feats(mlvl_feats, bs, self.cams_embeds,
                                              self.level_embeds)
        with span("encoder"):
            return self.encoder(
                queries, value, bev_pos, prev_bev, has_prev, shift, lidar2img,
                img_shape, spatial_shapes, bev_h, bev_w,
            )

    def forward(self, mlvl_feats, bev_queries, object_query_embed, bev_pos,
                bev_h, bev_w, grid_length, can_bus, lidar2img, img_shape,
                prev_bev, has_prev, reg_branch_fn: Optional[Callable] = None):
        bev_embed = self.get_bev_features(
            mlvl_feats, bev_queries, bev_pos, bev_h, bev_w, grid_length,
            can_bus, lidar2img, img_shape, prev_bev, has_prev,
        )
        bs = bev_embed.shape[0]
        e = self.embed_dims
        query_pos = object_query_embed[:, :e][None].expand(bs, -1, -1)
        query = object_query_embed[:, e:][None].expand(bs, -1, -1)
        reference_points = self.reference_points(query_pos).sigmoid()
        with span("decoder"):
            states, refs = self.decoder(
                query, bev_embed, query_pos, reference_points, (bev_h, bev_w),
                reg_branch_fn,
            )
        return bev_embed, states, reference_points, refs
