"""BEVFormerV2's transformer: the encoder without temporal state, the BEV
unwarp, the multi-frame fusion and the decoder.

Port of `bevformer_tpu/models/transformer_v2.py` (reference
`modules/transformerV2.py`):
  * `bev_grid_sample`: bilinear sampling of a BEV map (align_corners=False,
    zeros outside), the JAX function's arithmetic;
  * `BasicBlock`, `ResNetFusion`: the per-frame BEVs concatenated by
    channel, a BasicBlock stack, then Linear + LayerNorm
    (`transformerV2.py:16-51`), with the reference keys
    `fusion.layers.{i}.conv1/bn1/conv2/bn2/downsample.{0,1}` and
    `fusion.layer_norm.{0,1}`;
  * `PerceptionTransformerV2`: no CAN bus, shift or prev-BEV rotation (TSA
    attends over the `(query, query)` queue), the inverse-BEV-grid warp by
    `bda_mat`, the fusion when `frames` has more than one offset, and the
    decoder from learned reference points.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from bevformer_torch.device import fp32
from bevformer_torch.models.decoder import DetectionTransformerDecoder
from bevformer_torch.models.encoder import BEVFormerEncoder
from bevformer_torch.models.layers import Fp32Linear, SyncBatchNorm2d, layer_norm
from bevformer_torch.models.transformer import flatten_feats
from bevformer_torch.utils.profiler import span


def bev_grid_sample(bev: torch.Tensor, grid_xy: torch.Tensor) -> torch.Tensor:
    """bev [H, W, C], grid_xy [H, W, 2] normalised (x, y) in [-1, 1] ->
    [H, W, C]: `grid_sample` with align_corners=False and zeros outside,
    with the pixel positions computed as the JAX function computes them
    ((g + 1) * size / 2 - 0.5), so that the identity grid rounds alike."""
    h, w, c = bev.shape
    gx = (grid_xy[..., 0] + 1.0) * w / 2.0 - 0.5
    gy = (grid_xy[..., 1] + 1.0) * h / 2.0 - 0.5
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    tx = gx - x0
    ty = gy - y0
    x0 = x0.long()
    y0 = y0.long()
    flat = bev.reshape(h * w, c)
    out = torch.zeros_like(bev)
    for dy, dx, wt in ((0, 0, (1 - tx) * (1 - ty)), (0, 1, tx * (1 - ty)),
                       (1, 0, (1 - tx) * ty), (1, 1, tx * ty)):
        xx = x0 + dx
        yy = y0 + dy
        valid = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        idx = yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)
        out = out + flat[idx.reshape(-1)].view(h, w, c) * (wt * valid.float())[..., None].to(bev.dtype)
    return out


def _conv3x3(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1, bias=False)


class BasicBlock(nn.Module):
    """conv3x3 - BN - ReLU - conv3x3 - BN, plus the identity (or a conv3x3 -
    BN downsample where the width changes), then ReLU."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = _conv3x3(cin, cout)
        self.bn1 = SyncBatchNorm2d(cout)
        self.conv2 = _conv3x3(cout, cout)
        self.bn2 = SyncBatchNorm2d(cout)
        self.downsample = (nn.Sequential(_conv3x3(cin, cout), SyncBatchNorm2d(cout))
                           if cin != cout else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ResNetFusion(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, inter_channels: int,
                 num_layer: int = 3):
        super().__init__()
        self.layers = nn.ModuleList(
            BasicBlock(in_channels if i == 0 else inter_channels, inter_channels)
            for i in range(num_layer)
        )
        self.layer_norm = nn.Sequential(nn.Linear(inter_channels, out_channels),
                                        layer_norm(out_channels))

    def forward(self, bevs: Sequence[torch.Tensor], bev_h: int, bev_w: int) -> torch.Tensor:
        """bevs: per frame [bs, H*W, C] -> [bs, H*W, out_channels]. The
        convolutions run on an NHWC-ordered NCHW view."""
        bs = bevs[0].shape[0]
        x = torch.cat([b.reshape(bs, bev_h, bev_w, -1) for b in bevs], dim=-1)
        x = x.permute(0, 3, 1, 2)
        for layer in self.layers:
            x = layer(x)
        x = x.permute(0, 2, 3, 1).reshape(bs, bev_h * bev_w, -1)
        return self.layer_norm(x)


class PerceptionTransformerV2(nn.Module):
    def __init__(self, embed_dims=256, num_feature_levels=4, num_cams=6,
                 encoder_layers=6, decoder_layers=6, num_heads=8,
                 feedforward_channels=512, num_points_in_pillar=4,
                 pc_range=(-51.2, -51.2, -5.0, 51.2, 51.2, 3.0),
                 sca_num_points=8, tsa_num_points=4, sca_capacity_ratio=0.0,
                 ffn_dropout=0.1, frames: Tuple[int, ...] = (0,), num_fusion=3,
                 inter_channels: Optional[int] = None, use_remat=False):
        super().__init__()
        e = embed_dims
        self.embed_dims = e
        self.frames = tuple(frames)
        self.level_embeds = nn.Parameter(torch.randn(num_feature_levels, e))
        self.cams_embeds = nn.Parameter(torch.randn(num_cams, e))
        self.reference_points = Fp32Linear(e, 3)
        self.encoder = BEVFormerEncoder(
            encoder_layers, e, num_heads, feedforward_channels, num_cams,
            num_feature_levels, num_points_in_pillar, pc_range,
            sca_num_points, tsa_num_points, sca_capacity_ratio, ffn_dropout, use_remat,
        )
        self.decoder = DetectionTransformerDecoder(
            decoder_layers, e, num_heads, feedforward_channels, ffn_dropout
        )
        if len(self.frames) > 1:
            inter = inter_channels if inter_channels is not None else len(self.frames) * e
            self.fusion = ResNetFusion(len(self.frames) * e, e, inter, num_fusion)

    def get_bev_features(
        self,
        mlvl_feats: Sequence[torch.Tensor],
        bev_queries: torch.Tensor,  # [HW, e]
        bev_pos: torch.Tensor,  # [bs, HW, e]
        bev_h: int,
        bev_w: int,
        lidar2img: torch.Tensor,  # [bs, cams, 4, 4]
        img_shape: Tuple[int, int],
        bda_mat: Optional[torch.Tensor] = None,  # [bs, 2, 2]
    ) -> torch.Tensor:
        """The encoder's BEV [bs, HW, e], sampled back through `bda_mat`
        where one is given (the identity included, as in the JAX package)."""
        bs = lidar2img.shape[0]
        dev = bev_queries.device
        queries = bev_queries[None].expand(bs, bev_h * bev_w, self.embed_dims)
        value, spatial_shapes = flatten_feats(mlvl_feats, bs, self.cams_embeds, self.level_embeds)
        with span("encoder"):
            bev = self.encoder(
                queries, value, bev_pos, None, torch.zeros(bs, dtype=torch.bool, device=dev),
                torch.zeros(bs, 2, device=dev), lidar2img, img_shape, spatial_shapes, bev_h, bev_w,
            )
        if bda_mat is None:
            return bev
        # undo GlobalRotScaleTrans: sample at the bda-rotated grid
        # (`transformerV2.py:144-172`)
        ys = (torch.arange(bev_h, dtype=torch.float32, device=dev) + 0.5) / bev_h
        xs = (torch.arange(bev_w, dtype=torch.float32, device=dev) + 0.5) / bev_w
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        grid = torch.stack([gx, gy], -1) * 2.0 - 1.0  # [H, W, 2]
        with fp32(dev):
            warped = [
                bev_grid_sample(b.reshape(bev_h, bev_w, -1),
                                torch.einsum("ij,hwj->hwi", m.float(), grid))
                .reshape(bev_h * bev_w, -1)
                for b, m in zip(bev, bda_mat)
            ]
        return torch.stack(warped)

    def forward(self, mlvl_feats, bev_queries, object_query_embed, bev_pos, bev_h, bev_w,
                lidar2img, img_shape, prev_bev_list: Optional[List[Optional[torch.Tensor]]] = None,
                bda_mat: Optional[torch.Tensor] = None,
                reg_branch_fn: Optional[Callable] = None, num_groups: int = 1):
        """`object_query_embed` holds `num_groups` GroupDETR groups (more
        than one in training only). A missing history frame's BEV is filled
        from its neighbour with the gradient stopped (JAX :300-305); the
        fusion's BatchNorms follow the module's mode."""
        bev_embed = self.get_bev_features(
            mlvl_feats, bev_queries, bev_pos, bev_h, bev_w, lidar2img, img_shape, bda_mat
        )
        if len(self.frames) > 1:
            cur = self.frames.index(0)
            bevs = list(prev_bev_list) if prev_bev_list is not None else [None] * len(self.frames)
            bevs[cur] = bev_embed
            # a missing history frame takes the next frame's BEV, a missing
            # future frame the one before it
            for i in range(cur - 1, -1, -1):
                if bevs[i] is None:
                    bevs[i] = bevs[i + 1].detach()
            for i in range(cur + 1, len(bevs)):
                if bevs[i] is None:
                    bevs[i] = bevs[i - 1].detach()
            bev_embed = self.fusion(bevs, bev_h, bev_w)
        bs = bev_embed.shape[0]
        e = self.embed_dims
        query_pos = object_query_embed[:, :e][None].expand(bs, -1, -1)
        query = object_query_embed[:, e:][None].expand(bs, -1, -1)
        reference_points = self.reference_points(query_pos).sigmoid()
        with span("decoder"):
            states, refs = self.decoder(
                query, bev_embed, query_pos, reference_points, (bev_h, bev_w), reg_branch_fn,
                num_groups,
            )
        return bev_embed, states, reference_points, refs
