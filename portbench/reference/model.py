"""BEVFormer (v1) and BEVFormerV2 inference and training forward in plain
PyTorch, fp32, with the gathers of `ops` in place of the program's kernels.

A frozen copy of the model code of `bevformer_torch/models` at commit
05c7fb4, without what the benchmark's cells do not run: no bf16, no query
split over ranks, no recomputation, no DD3D head. Submodules and
parameters carry the program's state-dict names, so one weight dict loads
into both. Nothing here imports the program.

Random draws are not made here: in train mode every dropout takes its keep
mask, and the trained frame its GridMask, from a `Draws` that the caller
fills with the program's own draws of the same step, in call order.
"""

from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from torch.utils.checkpoint import checkpoint

from portbench.reference import ops

LN_EPS = 1e-6


def lean(fn, *args):
    """`fn(*args)`, recomputed in backward where a gradient is taken: the
    gathers of `ops` keep a sampled copy of their input per corner, which
    over a training step's layers would not fit on the card."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


class Draws:
    """The keep masks of one step's dropouts, in call order, and the
    trained frame's GridMask keep mask."""

    def __init__(self, masks: Sequence[torch.Tensor] = (), grid: Optional[torch.Tensor] = None):
        self.masks = list(masks)
        self.grid = grid
        self.used = 0

    def take(self, shape) -> torch.Tensor:
        if self.used >= len(self.masks):
            raise RuntimeError("the reference drops out more often than the program did")
        mask = self.masks[self.used]
        self.used += 1
        if tuple(mask.shape) != tuple(shape):
            raise RuntimeError(f"dropout {self.used}: program mask {tuple(mask.shape)}, "
                               f"reference input {tuple(shape)}")
        return mask


class Dropout(nn.Module):
    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.draws: Optional[Draws] = None

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        keep = self.draws.take(x.shape)
        return x * keep.to(x.dtype) * (1.0 / (1 - self.p))


def layer_norm(d):
    return nn.LayerNorm(d, eps=LN_EPS)


def inverse_sigmoid(x, eps=1e-5):
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1.0 - x).clamp(min=eps))


class FFN(nn.Module):
    def __init__(self, e, ff, p):
        super().__init__()
        self.layers = nn.Sequential(nn.Sequential(nn.Linear(e, ff), nn.ReLU(), Dropout(p)),
                                    nn.Linear(ff, e), Dropout(p))

    def forward(self, x):
        (fc1, relu, d1), fc2, d2 = self.layers
        return x + d2(fc2(d1(relu(fc1(x)))))


class _Packed(nn.Module):
    def __init__(self, e):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * e, e))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * e))
        self.out_proj = nn.Linear(e, e)


class MultiheadAttention(nn.Module):
    def __init__(self, e, h):
        super().__init__()
        self.e, self.h = e, h
        self.attn = _Packed(e)
        self.attn_drop = Dropout(0.1)
        self.proj_drop = Dropout(0.1)

    def forward(self, query, query_pos):
        e, h = self.e, self.h
        dh = e // h
        qk = query + query_pos
        w, b = self.attn.in_proj_weight, self.attn.in_proj_bias
        bs, n, _ = query.shape
        q = F.linear(qk, w[:e], b[:e]).view(bs, n, h, dh).transpose(1, 2)
        k = F.linear(qk, w[e:2 * e], b[e:2 * e]).view(bs, n, h, dh).transpose(1, 2)
        v = F.linear(query, w[2 * e:], b[2 * e:]).view(bs, n, h, dh).transpose(1, 2)
        att = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(dh))
        out = torch.matmul(self.attn_drop(att.softmax(-1)), v).transpose(1, 2).reshape(bs, n, e)
        return query + self.proj_drop(self.attn.out_proj(out))


def _normalizer(shapes, like):
    return torch.tensor([[float(w), float(h)] for h, w in shapes], device=like.device)


class MSDeformableAttention3D(nn.Module):
    def __init__(self, e, h, l, p):
        super().__init__()
        self.e, self.h, self.l, self.p = e, h, l, p
        self.sampling_offsets = nn.Linear(e, h * l * p * 2)
        self.attention_weights = nn.Linear(e, h * l * p)
        self.value_proj = nn.Linear(e, e)

    def forward(self, query, value, ref, shapes):
        b, q, _ = query.shape
        h, l, p = self.h, self.l, self.p
        nz = ref.shape[2]
        v = self.value_proj(value).view(b, -1, h, self.e // h)
        off = self.sampling_offsets(query).view(b, q, h, l, p, 2)
        w = self.attention_weights(query).view(b, q, h, l * p).softmax(-1)
        off = (off / _normalizer(shapes, query)[:, None, :]).view(b, q, h, l, p // nz, nz, 2)
        loc = (ref[:, :, None, None, None, :, :] + off).reshape(b, q, h, l, p, 2)
        return lean(ops.msda, v, shapes, loc, w.reshape(b, q, h, l, p))


def sca_routing(bev_mask, ratio):
    """Each camera's first `cap` queries, visible ones first, both groups
    in ascending order; None for dense SCA."""
    if not ratio or ratio >= 1.0:
        return None
    bs, cams, q, nz = bev_mask.shape
    cap = min((int(q * ratio) + 127) // 128 * 128, q)
    anyz = bev_mask.any(-1)
    top_idx = torch.sort((~anyz).to(torch.uint8), dim=-1, stable=True)[1][..., :cap]
    vis_sel = torch.gather(anyz, 2, top_idx)
    nv = torch.cumsum(anyz.long(), -1)
    iq = torch.arange(q, device=anyz.device)
    rank = torch.where(anyz, nv - 1, nv[..., -1:] + iq - nv)
    found = rank < cap
    inv = torch.where(found, rank, torch.zeros_like(rank))
    return dict(top_idx=top_idx, vis_sel=vis_sel, inv=inv, found=found, anyz=anyz)


class SpatialCrossAttention(nn.Module):
    def __init__(self, e, cams, h, l, p):
        super().__init__()
        self.cams = cams
        self.deformable_attention = MSDeformableAttention3D(e, h, l, p)
        self.output_proj = nn.Linear(e, e)
        self.dropout = Dropout(0.1)

    def forward(self, query, value, ref_cam, bev_mask, shapes, routing):
        bs, q, e = query.shape
        cams = self.cams
        v = value.reshape(bs * cams, -1, e)
        nz = ref_cam.shape[3]
        if routing is not None:
            top_idx, inv, found, anyz = (routing[k] for k in ("top_idx", "inv", "found", "anyz"))
            cap = top_idx.shape[-1]
            bidx = torch.arange(bs, device=query.device)[:, None, None]
            cidx = torch.arange(cams, device=query.device)[:, None]
            attn = self.deformable_attention(
                query[bidx, top_idx].reshape(bs * cams, cap, e), v,
                ref_cam[bidx, cidx, top_idx].reshape(bs * cams, cap, nz, 2), shapes,
            ).view(bs, cams, cap, e) * routing["vis_sel"][..., None].float()
            back = torch.gather(attn, 2, inv[..., None].expand(-1, -1, -1, e))
            slots = torch.where(found[..., None], back, torch.zeros_like(back)).sum(1)
        else:
            anyz = bev_mask.any(-1)
            attn = self.deformable_attention(
                query[:, None].expand(bs, cams, q, e).reshape(bs * cams, q, e), v,
                ref_cam.reshape(bs * cams, q, nz, 2), shapes).view(bs, cams, q, e)
            slots = (attn * anyz[..., None].float()).sum(1)
        slots = slots / anyz.float().sum(1).clamp(min=1.0)[..., None]
        return self.dropout(self.output_proj(slots)) + query


class TemporalSelfAttention(nn.Module):
    def __init__(self, e, h, l, p, nq=2):
        super().__init__()
        self.e, self.h, self.l, self.p, self.nq = e, h, l, p, nq
        self.sampling_offsets = nn.Linear(e * nq, nq * h * l * p * 2)
        self.attention_weights = nn.Linear(e * nq, nq * h * l * p)
        self.value_proj = nn.Linear(e, e)
        self.output_proj = nn.Linear(e, e)
        self.dropout = Dropout(0.1)

    def forward(self, query, value_queue, query_pos, ref, bev_h, bev_w):
        bs, q, e = query.shape
        h, l, p, nq = self.h, self.l, self.p, self.nq
        identity = query
        query = query + query_pos
        cat = torch.cat([value_queue[:, 0], query], -1)
        v = self.value_proj(value_queue).view(bs * nq, bev_h * bev_w, h, e // h)
        off = (self.sampling_offsets(cat).view(bs, q, h, nq, l, p, 2)
               .permute(0, 3, 1, 2, 4, 5, 6).reshape(bs * nq, q, h, l, p, 2))
        w = (self.attention_weights(cat).view(bs, q, h, nq, l * p).softmax(-1)
             .view(bs, q, h, nq, l, p).permute(0, 3, 1, 2, 4, 5).reshape(bs * nq, q, h, l, p))
        r = ref.reshape(bs * nq, q, l, 2)
        loc = r[:, :, None, :, None, :] + off / _normalizer(((bev_h, bev_w),), query)[:, None, :]
        out = lean(ops.msda, v, ((bev_h, bev_w),), loc, w).view(bs, nq, q, e).mean(1)
        return self.dropout(self.output_proj(out)) + identity


class CustomMSDeformableAttention(nn.Module):
    def __init__(self, e, h, l, p):
        super().__init__()
        self.e, self.h, self.l, self.p = e, h, l, p
        self.sampling_offsets = nn.Linear(e, h * l * p * 2)
        self.attention_weights = nn.Linear(e, h * l * p)
        self.value_proj = nn.Linear(e, e)
        self.output_proj = nn.Linear(e, e)
        self.dropout = Dropout(0.1)

    def forward(self, query, value, query_pos, ref, shapes):
        bs, q, e = query.shape
        h, l, p = self.h, self.l, self.p
        identity = query
        query = query + query_pos
        v = self.value_proj(value).view(bs, -1, h, e // h)
        off = self.sampling_offsets(query).view(bs, q, h, l, p, 2)
        w = self.attention_weights(query).view(bs, q, h, l * p).softmax(-1).view(bs, q, h, l, p)
        loc = ref[:, :, None, :, None, :] + off / _normalizer(shapes, query)[:, None, :]
        return self.dropout(self.output_proj(lean(ops.msda, v, shapes, loc, w))) + identity


class EncoderLayer(nn.Module):
    def __init__(self, c):
        super().__init__()
        e = c.embed_dims
        self.attentions = nn.ModuleList([
            TemporalSelfAttention(e, c.num_heads, 1, c.tsa_num_points),
            SpatialCrossAttention(e, c.data.num_cams, c.num_heads, c.num_feature_levels,
                                  c.sca_num_points)])
        self.norms = nn.ModuleList(layer_norm(e) for _ in range(3))
        self.ffns = nn.ModuleList([FFN(e, c.feedforward_channels, c.ffn_dropout)])

    def forward(self, query, value, bev_pos, value_queue, hybrid_ref, ref_cam, bev_mask,
                shapes, bev_h, bev_w, routing):
        query = self.norms[0](self.attentions[0](query, value_queue, bev_pos, hybrid_ref,
                                                 bev_h, bev_w))
        query = self.norms[1](self.attentions[1](query, value, ref_cam, bev_mask, shapes,
                                                 routing))
        return self.norms[2](self.ffns[0](query))


class Encoder(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.c = c
        self.layers = nn.ModuleList(EncoderLayer(c) for _ in range(c.encoder_layers))

    def forward(self, bev_query, value, bev_pos, prev_bev, has_prev, shift, lidar2img,
                img_shape, shapes, bev_h, bev_w):
        c = self.c
        bs, dev = bev_query.shape[0], bev_query.device
        ref_3d = ops.reference_points_3d(bev_h, bev_w, c.pc_range[5] - c.pc_range[2],
                                         c.num_points_in_pillar, bs, dev)
        ref_2d = ops.reference_points_2d(bev_h, bev_w, bs, dev)
        ref_cam, bev_mask = ops.point_sampling(ref_3d, c.pc_range, lidar2img, img_shape)
        has = has_prev.view(bs, 1, 1, 1)
        hybrid = torch.stack([torch.where(has, ref_2d + shift[:, None, None, :], ref_2d),
                              ref_2d], 1)
        routing = sca_routing(bev_mask, c.sca_capacity_ratio)
        hasq = has_prev.view(bs, 1, 1)
        out = bev_query
        for layer in self.layers:
            if prev_bev is not None:
                slot0, slot1 = torch.where(hasq, prev_bev, out), torch.where(hasq, bev_query, out)
            else:
                slot0 = slot1 = out
            out = layer(out, value, bev_pos, torch.stack([slot0, slot1], 1), hybrid, ref_cam,
                        bev_mask, shapes, bev_h, bev_w, routing)
        return out


class DecoderLayer(nn.Module):
    def __init__(self, c):
        super().__init__()
        e = c.embed_dims
        self.attentions = nn.ModuleList([
            MultiheadAttention(e, c.num_heads),
            CustomMSDeformableAttention(e, c.num_heads, 1, 4)])
        self.norms = nn.ModuleList(layer_norm(e) for _ in range(3))
        self.ffns = nn.ModuleList([FFN(e, c.feedforward_channels, c.ffn_dropout)])

    def forward(self, query, bev, query_pos, ref, bev_shape):
        query = self.norms[0](self.attentions[0](query, query_pos))
        query = self.norms[1](self.attentions[1](query, bev, query_pos, ref, (bev_shape,)))
        return self.norms[2](self.ffns[0](query))


class Decoder(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.layers = nn.ModuleList(DecoderLayer(c) for _ in range(c.decoder_layers))

    def forward(self, query, bev, query_pos, ref, bev_shape, reg_fn):
        states, refs = [], []
        for lid, layer in enumerate(self.layers):
            query = layer(query, bev, query_pos, ref[..., :2][:, :, None, :], bev_shape)
            tmp = reg_fn(lid, query)
            xy = tmp[..., 0:2] + inverse_sigmoid(ref[..., 0:2])
            z = tmp[..., 4:5] + inverse_sigmoid(ref[..., 2:3])
            ref = torch.cat([xy, z], -1).sigmoid().detach()
            states.append(query)
            refs.append(ref)
        return torch.stack(states), torch.stack(refs)


def flatten_feats(feats, bs, cams_embeds, level_embeds):
    flat, shapes = [], []
    for lvl, f in enumerate(feats):
        n, e, h, w = f.shape
        flat.append(f.flatten(2).transpose(1, 2).reshape(bs, n // bs, h * w, e)
                    + cams_embeds[None, :, None, :] + level_embeds[lvl])
        shapes.append((h, w))
    return torch.cat(flat, 2), tuple(shapes)


class BasicBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1, bias=False)
        self.bn1 = BatchNorm(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1, bias=False)
        self.bn2 = BatchNorm(cout)
        self.downsample = (nn.Sequential(nn.Conv2d(cin, cout, 3, padding=1, bias=False),
                                         BatchNorm(cout)) if cin != cout else None)

    def forward(self, x):
        out = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        return F.relu(out + (x if self.downsample is None else self.downsample(x)))


class ResNetFusion(nn.Module):
    def __init__(self, cin, cout, inter, n):
        super().__init__()
        self.layers = nn.ModuleList(BasicBlock(cin if i == 0 else inter, inter) for i in range(n))
        self.layer_norm = nn.Sequential(nn.Linear(inter, cout), layer_norm(cout))

    def forward(self, bevs, bev_h, bev_w):
        bs = bevs[0].shape[0]
        x = torch.cat([b.reshape(bs, bev_h, bev_w, -1) for b in bevs], -1).permute(0, 3, 1, 2)
        for layer in self.layers:
            x = layer(x)
        return self.layer_norm(x.permute(0, 2, 3, 1).reshape(bs, bev_h * bev_w, -1))


class Transformer(nn.Module):
    """v1's PerceptionTransformer, or V2's (`c.version == "v2"`)."""

    def __init__(self, c):
        super().__init__()
        e = c.embed_dims
        self.c = c
        self.level_embeds = nn.Parameter(torch.empty(c.num_feature_levels, e))
        self.cams_embeds = nn.Parameter(torch.empty(c.data.num_cams, e))
        self.reference_points = nn.Linear(e, 3)
        if c.version == "v1":
            self.can_bus_mlp = nn.Sequential(nn.Linear(18, e // 2), nn.ReLU(),
                                             nn.Linear(e // 2, e), nn.ReLU())
            self.can_bus_mlp.add_module("norm", layer_norm(e))
        self.encoder = Encoder(c)
        self.decoder = Decoder(c)
        if c.version == "v2" and len(c.frames) > 1:
            inter = c.inter_channels or len(c.frames) * e
            self.fusion = ResNetFusion(len(c.frames) * e, e, inter, c.num_fusion)

    def bev_v1(self, feats, bev_queries, bev_pos, can_bus, lidar2img, prev_bev, has_prev):
        c = self.c
        bs = can_bus.shape[0]
        q = bev_queries[None].expand(bs, c.bev_h * c.bev_w, c.embed_dims)
        shift = ops.bev_shift(can_bus[:, 0], can_bus[:, 1], can_bus[:, -2], grid_length(c),
                              c.bev_h, c.bev_w)
        if prev_bev is not None:
            rotated = ops.rotate_prev_bev(prev_bev, can_bus[:, -1], c.bev_h, c.bev_w,
                                          c.rotate_center)
            prev_bev = torch.where(has_prev.view(bs, 1, 1), rotated, prev_bev)
        q = q + self.can_bus_mlp(can_bus)[:, None, :]
        value, shapes = flatten_feats(feats, bs, self.cams_embeds, self.level_embeds)
        return self.encoder(q, value, bev_pos, prev_bev, has_prev, shift, lidar2img,
                            img_size(c), shapes, c.bev_h, c.bev_w)

    def bev_v2(self, feats, bev_queries, bev_pos, lidar2img, img_shape, bda_mat):
        c = self.c
        bs, dev = lidar2img.shape[0], lidar2img.device
        q = bev_queries[None].expand(bs, c.bev_h * c.bev_w, c.embed_dims)
        value, shapes = flatten_feats(feats, bs, self.cams_embeds, self.level_embeds)
        bev = self.encoder(q, value, bev_pos, None, torch.zeros(bs, dtype=torch.bool, device=dev),
                           torch.zeros(bs, 2, device=dev), lidar2img, img_shape, shapes,
                           c.bev_h, c.bev_w)
        ys = (torch.arange(c.bev_h, dtype=torch.float32, device=dev) + 0.5) / c.bev_h
        xs = (torch.arange(c.bev_w, dtype=torch.float32, device=dev) + 0.5) / c.bev_w
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        grid = torch.stack([gx, gy], -1) * 2.0 - 1.0
        return torch.stack([
            ops.bev_grid_sample(b.reshape(c.bev_h, c.bev_w, -1),
                                torch.einsum("ij,hwj->hwi", m, grid)).reshape(c.bev_h * c.bev_w, -1)
            for b, m in zip(bev, bda_mat)])

    def decode(self, bev, object_query_embed, reg_fn):
        c = self.c
        bs, e = bev.shape[0], c.embed_dims
        query_pos = object_query_embed[:, :e][None].expand(bs, -1, -1)
        query = object_query_embed[:, e:][None].expand(bs, -1, -1)
        ref = self.reference_points(query_pos).sigmoid()
        states, refs = self.decoder(query, bev, query_pos, ref, (c.bev_h, c.bev_w), reg_fn)
        return states, ref, refs


def grid_length(c):
    return ((c.pc_range[4] - c.pc_range[1]) / c.bev_h, (c.pc_range[3] - c.pc_range[0]) / c.bev_w)


def img_size(c):
    h, w = int(c.data.raw_size[0] * c.data.scale), int(c.data.raw_size[1] * c.data.scale)
    d = c.data.size_divisor
    return ((h + d - 1) // d * d, (w + d - 1) // d * d)


class LearnedPositionalEncoding(nn.Module):
    def __init__(self, f, rows, cols):
        super().__init__()
        self.row_embed = nn.Embedding(rows, f)
        self.col_embed = nn.Embedding(cols, f)

    def forward(self, bs):
        row, col = self.row_embed.weight, self.col_embed.weight
        h, w, f = row.shape[0], col.shape[0], row.shape[1]
        pos = torch.cat([col[None].expand(h, w, f), row[:, None].expand(h, w, f)], -1)
        return pos.reshape(h * w, 2 * f)[None].expand(bs, h * w, 2 * f)


class Head(nn.Module):
    def __init__(self, c):
        super().__init__()
        e = c.embed_dims
        self.c = c
        self.bev_embedding = nn.Embedding(c.bev_h * c.bev_w, e)
        self.query_embedding = nn.Embedding(c.num_query * c.group_detr, 2 * e)
        self.positional_encoding = LearnedPositionalEncoding(e // 2, c.bev_h, c.bev_w)
        self.transformer = Transformer(c)

        def cls_branch():
            layers = []
            for _ in range(c.num_reg_fcs):
                layers += [nn.Linear(e, e), layer_norm(e), nn.ReLU()]
            return nn.Sequential(*layers, nn.Linear(e, c.num_classes))

        def reg_branch():
            layers = []
            for _ in range(c.num_reg_fcs):
                layers += [nn.Linear(e, e), nn.ReLU()]
            return nn.Sequential(*layers, nn.Linear(e, c.code_size))

        self.cls_branches = nn.ModuleList(cls_branch() for _ in range(c.decoder_layers))
        self.reg_branches = nn.ModuleList(reg_branch() for _ in range(c.decoder_layers))

    def outputs(self, bev_embed, states, init_ref, refs):
        x0, y0, z0, x1, y1, z1 = self.c.pc_range
        classes, coords = [], []
        for lvl in range(states.shape[0]):
            ref = inverse_sigmoid(init_ref if lvl == 0 else refs[lvl - 1])
            tmp = self.reg_branches[lvl](states[lvl])
            xy = (tmp[..., 0:2] + ref[..., 0:2]).sigmoid()
            z = (tmp[..., 4:5] + ref[..., 2:3]).sigmoid()
            coords.append(torch.cat([xy[..., 0:1] * (x1 - x0) + x0, xy[..., 1:2] * (y1 - y0) + y0,
                                     tmp[..., 2:4], z * (z1 - z0) + z0, tmp[..., 5:]], -1))
            classes.append(self.cls_branches[lvl](states[lvl]))
        return dict(bev_embed=bev_embed, all_cls_scores=torch.stack(classes),
                    all_bbox_preds=torch.stack(coords))

    def reg_fn(self, lid, states):
        return self.reg_branches[lid](states)


class FrozenBN(nn.Module):
    def __init__(self, n, eps=1e-5):
        super().__init__()
        self.eps = eps
        for k in ("weight", "bias", "running_mean", "running_var"):
            self.register_buffer(k, torch.empty(n))

    def forward(self, x):
        mul = self.weight * torch.rsqrt(self.running_var + self.eps)
        return x * mul[:, None, None] + (self.bias - self.running_mean * mul)[:, None, None]


class BatchNorm(nn.Module):
    """A BatchNorm in eval mode (running statistics), with
    nn.BatchNorm2d's state-dict names."""

    def __init__(self, n, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(n))
        self.bias = nn.Parameter(torch.empty(n))
        self.register_buffer("running_mean", torch.empty(n))
        self.register_buffer("running_var", torch.empty(n))
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.long))

    def forward(self, x):
        inv = torch.rsqrt(self.running_var + self.eps)
        return ((x - self.running_mean[:, None, None]) * (inv * self.weight)[:, None, None]
                + self.bias[:, None, None])


class DeformConv(nn.Module):
    def __init__(self, cin, cout, stride):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3))
        self.conv_offset = nn.Conv2d(cin, 27, 3, stride, padding=1)

    def forward(self, x):
        om = self.conv_offset(x).permute(0, 2, 3, 1)
        c = self.weight.shape[1]
        w = self.weight.permute(2, 3, 1, 0).reshape(9 * c, -1)
        out = lean(ops.dcn, x.permute(0, 2, 3, 1), om[..., 0:18:2], om[..., 1:18:2],
                   om[..., 18:].sigmoid(), w, self.stride)
        return out.permute(0, 3, 1, 2)


DEPTHS = {10: (1, 1, 1, 1), 50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


class Bottleneck(nn.Module):
    def __init__(self, cin, planes, stride, downsample, dcn, style, norm):
        super().__init__()
        s1, s2 = (stride, 1) if style == "caffe" else (1, stride)
        self.conv1 = nn.Conv2d(cin, planes, 1, s1, bias=False)
        self.bn1 = norm(planes)
        self.conv2 = (DeformConv(planes, planes, s2) if dcn
                      else nn.Conv2d(planes, planes, 3, s2, padding=1, bias=False))
        self.bn2 = norm(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = norm(planes * 4)
        self.downsample = (nn.Sequential(nn.Conv2d(cin, planes * 4, 1, stride, bias=False),
                                         norm(planes * 4)) if downsample else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + (x if self.downsample is None else self.downsample(x)))


class ResNet(nn.Module):
    def __init__(self, c):
        super().__init__()
        norm = FrozenBN if c.backbone_norm == "frozen" else BatchNorm
        self.out_indices = tuple(c.backbone_out_indices)
        self.conv1 = nn.Conv2d(3, 64, 7, 2, padding=3, bias=False)
        self.bn1 = norm(64)
        cin, planes = 64, 64
        for stage, n in enumerate(DEPTHS[c.backbone_depth]):
            stride = 1 if stage == 0 else 2
            dcn = stage in c.backbone_dcn_stages
            blocks = [Bottleneck(cin, planes, stride, True, dcn, c.backbone_style, norm)]
            blocks += [Bottleneck(planes * 4, planes, 1, False, dcn, c.backbone_style, norm)
                       for _ in range(n - 1)]
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
            cin, planes = planes * 4, planes * 2

    def forward(self, x):
        out = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, stride=2, padding=1)
        outs = []
        for stage in range(4):
            out = getattr(self, f"layer{stage + 1}")(out)
            if stage in self.out_indices:
                outs.append(out)
        return outs


class ConvModule(nn.Module):
    def __init__(self, cin, cout, k, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, stride=stride, padding=padding)

    def forward(self, x):
        return self.conv(x)


class FPN(nn.Module):
    def __init__(self, cins, cout, num_outs):
        super().__init__()
        self.lateral_convs = nn.ModuleList(ConvModule(ci, cout, 1) for ci in cins)
        self.fpn_convs = nn.ModuleList(ConvModule(cout, cout, 3, padding=1) for _ in cins)
        for _ in range(len(cins), num_outs):
            self.fpn_convs.append(ConvModule(cout, cout, 3, stride=2, padding=1))

    def forward(self, inputs):
        used = len(self.lateral_convs)
        lat = [conv(x) for conv, x in zip(self.lateral_convs, inputs)]
        for i in range(used - 1, 0, -1):
            lat[i - 1] = lat[i - 1] + F.interpolate(lat[i], size=lat[i - 1].shape[-2:],
                                                    mode="nearest-exact")
        outs = [self.fpn_convs[i](lat[i]) for i in range(used)]
        src = outs[-1]
        for i in range(used, len(self.fpn_convs)):
            if i > used:
                src = F.relu(src)
            src = self.fpn_convs[i](src)
            outs.append(src)
        return outs


class Detector(nn.Module):
    """BEVFormer (v1) or BEVFormerV2 without its DD3D head."""

    def __init__(self, c):
        super().__init__()
        self.c = c
        self.img_backbone = ResNet(c)
        self.img_neck = FPN(c.neck_in_channels, c.embed_dims,
                            max(c.num_mono_levels, c.num_feature_levels))
        self.pts_bbox_head = Head(c)
        self.grid_keep: Optional[torch.Tensor] = None

    def set_draws(self, draws: Optional[Draws]) -> None:
        """Hand every dropout (and the GridMask) this step's draws."""
        for m in self.modules():
            if isinstance(m, Dropout):
                m.draws = draws
        self.grid_keep = None if draws is None else draws.grid

    def extract_feat(self, images, grid_mask=False):
        """images [bs, cams, H, W, 3] -> the neck's levels [bs*cams, e, h, w]."""
        bs, cams, h, w, _ = images.shape
        imgs = images.reshape(bs * cams, h, w, 3)
        if grid_mask:
            imgs = imgs * self.grid_keep.to(imgs.dtype)
        return self.img_neck(self.img_backbone(imgs.permute(0, 3, 1, 2)))

    def forward_v1(self, images, can_bus, lidar2img, prev_bev, has_prev, only_bev=False,
                   feats=None):
        c, head = self.c, self.pts_bbox_head
        if feats is None:
            feats = self.extract_feat(images, self.training and c.use_grid_mask)
        bs = lidar2img.shape[0]
        bev = head.transformer.bev_v1(feats, head.bev_embedding.weight,
                                      head.positional_encoding(bs), can_bus, lidar2img,
                                      prev_bev, has_prev)
        if only_bev:
            return bev
        states, init_ref, refs = head.transformer.decode(bev, head.query_embedding.weight,
                                                         head.reg_fn)
        return head.outputs(bev, states, init_ref, refs)

    def bev_v2(self, images, lidar2img, bda_mat):
        c, head = self.c, self.pts_bbox_head
        feats = self.extract_feat(images)[: c.num_feature_levels]
        bs = lidar2img.shape[0]
        return head.transformer.bev_v2(feats, head.bev_embedding.weight,
                                       head.positional_encoding(bs), lidar2img,
                                       tuple(images.shape[2:4]), bda_mat)

    def forward_v2(self, images, lidar2img, bda_mat):
        """An eval sample: images [1, T, cams, H, W, 3] and lidar2img [1, T,
        cams, 4, 4] over `c.frames`; every frame's BEV, fused."""
        c, head = self.c, self.pts_bbox_head
        bevs = [self.bev_v2(images[:, i], lidar2img[:, i], bda_mat) for i in range(len(c.frames))]
        cur = c.frames.index(0)
        bev = head.transformer.fusion(bevs, c.bev_h, c.bev_w) if len(c.frames) > 1 else bevs[cur]
        states, init_ref, refs = head.transformer.decode(
            bev, head.query_embedding.weight[: c.num_query], head.reg_fn)
        return head.outputs(bev, states, init_ref, refs)


def config(d: Dict) -> SimpleNamespace:
    """A configuration file's dict as attributes (`data` and `optim` nested)."""
    c = SimpleNamespace(**{k: v for k, v in d.items() if k not in ("about", "data", "optim")})
    c.data = SimpleNamespace(**d["data"])
    c.optim = SimpleNamespace(**d["optim"])
    for k in ("frames", "backbone_out_indices", "backbone_dcn_stages", "neck_in_channels",
              "rotate_center", "pc_range", "post_center_range", "code_weights"):
        setattr(c, k, tuple(getattr(c, k)))
    return c
