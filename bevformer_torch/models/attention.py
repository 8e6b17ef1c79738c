"""BEVFormer's deformable attention modules, exact paths.

Ports of `bevformer_tpu/models/attention.py` (reference
`temporal_self_attention.py`, `spatial_cross_attention.py` and
`decoder.py::CustomMSDeformableAttention`). Every module samples through
`kernels.msda.ms_deform_attn` and drops out (`DROPOUT`, train mode only) its
output projection before the residual, as the JAX package does. On BEV
queries split over ranks (`runtime.parallel.QuerySplit`), TSA and SCA
compute this rank's rows: TSA samples the whole BEV, SCA the rows its
routing (`split_routing`) keeps. Projections
are plain `nn.Linear` layers with their output channels in reference order:
TSA (h, queue, l, p[, 2]), the SCA inner attention (h, l, p[, 2]) with p
split offset-major over the Z anchors. Under bf16 the value and output
projections run in bf16 and the msda kernel reads a bf16 value; the offset
and weight projections (`Fp32Linear`), the softmax and the sampling
locations stay fp32, as in the JAX package.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from bevformer_torch.kernels.msda import ms_deform_attn
from bevformer_torch.models.layers import Fp32Linear, QueryDropout

Shapes = Sequence[Tuple[int, int]]

DROPOUT = 0.1  # on each module's output projection (train mode only)


def grid_init_bias(num_heads: int, num_levels: int, num_points: int) -> np.ndarray:
    """Deformable-DETR sampling-offset bias init (circular per-head spread),
    flat in (h, l, p, 2) order."""
    thetas = np.arange(num_heads, dtype=np.float32) * (2.0 * math.pi / num_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, num_levels, num_points, 1))
    for i in range(num_points):
        grid[:, :, i, :] *= i + 1
    return grid.reshape(-1)


def _normalizer(spatial_shapes: Shapes, like: torch.Tensor) -> torch.Tensor:
    """[l, 2] of (w, h) per level, fp32 on `like`'s device."""
    return torch.tensor([[float(w), float(h)] for h, w in spatial_shapes],
                        dtype=torch.float32, device=like.device)


class MSDeformableAttention3D(nn.Module):
    """SCA inner attention: `num_points` sampling points spread over the
    `num_Z_anchors` projected pillar anchors. No output projection and no
    residual."""

    def __init__(self, embed_dims=256, num_heads=8, num_levels=4, num_points=8):
        super().__init__()
        self.embed_dims, self.num_heads = embed_dims, num_heads
        self.num_levels, self.num_points = num_levels, num_points
        self.sampling_offsets = Fp32Linear(embed_dims, num_heads * num_levels * num_points * 2)
        self.attention_weights = Fp32Linear(embed_dims, num_heads * num_levels * num_points)
        self.value_proj = nn.Linear(embed_dims, embed_dims)

    def forward(
        self,
        query: torch.Tensor,  # [b, q, e]
        value: torch.Tensor,  # [b, k, e]
        reference_points: torch.Tensor,  # [b, q, nz, 2]
        spatial_shapes: Shapes,
    ) -> torch.Tensor:
        b, q, _ = query.shape
        h, l, p = self.num_heads, self.num_levels, self.num_points
        nz = reference_points.shape[2]
        v = self.value_proj(value).view(b, -1, h, self.embed_dims // h)
        offsets = self.sampling_offsets(query).view(b, q, h, l, p, 2)
        weights = self.attention_weights(query).view(b, q, h, l * p).softmax(-1)
        offsets = offsets / _normalizer(spatial_shapes, query)[:, None, :]
        # points split offset-major, anchor-minor over the Z anchors
        offsets = offsets.view(b, q, h, l, p // nz, nz, 2)
        ref = reference_points[:, :, None, None, None, :, :].float()
        loc = (ref + offsets).reshape(b, q, h, l, p, 2)
        return ms_deform_attn(
            v, spatial_shapes, loc, weights.reshape(b, q, h, l, p).contiguous()
        )


def sca_capacity_routing(bev_mask: torch.Tensor, capacity_ratio: float) -> Optional[Dict]:
    """Static per-camera query selection for SCA: the first `cap` queries of
    each camera, visible ones first in ascending index order, then
    invisible fillers in ascending order (`sca_capacity_precompute`).
    Visible queries beyond `cap` are dropped, as in the JAX package
    (counted inside `capacity_count`). A ratio of 0 (or 1 and more) routes every query: None, SCA's dense
    path, as JAX's `attention.py:726` takes it.

    bev_mask [bs, cams, q, nz] -> top_idx [bs, cams, cap], vis_sel
    [bs, cams, cap], and the inverse map inv/found [bs, cams, q]."""
    if not capacity_ratio or capacity_ratio >= 1.0:
        return None
    bs, cams, q, nz = bev_mask.shape
    cap = min((int(q * capacity_ratio) + 127) // 128 * 128, q)
    anyz = bev_mask.any(dim=-1)
    for count in _CAPACITY_COUNTS:
        count.add(anyz, cap)
    # a stable sort on "invisible" keeps the ascending order within each group
    top_idx = torch.sort((~anyz).to(torch.uint8), dim=-1, stable=True)[1][..., :cap]
    vis_sel = torch.gather(anyz, 2, top_idx)
    inv, found = routing_inverse_vis(anyz, cap)
    return dict(top_idx=top_idx, vis_sel=vis_sel, inv=inv, found=found, anyz=anyz)


class CapacityCount:
    """The visible SCA queries that `sca_capacity_routing` drops, counted on
    the device over the frames routed while it is active
    (`capacity_count`), with no host sync: per frame, the sum over (batch,
    camera) of max(visible - cap, 0), and the most visible queries of one
    camera; `read` (one sync) gives the largest of each over the frames,
    JAX's `max_capacity_clipped` (`attention.py:741-751`, `tools/test.py:
    237-243`) and the largest visible count."""

    def __init__(self):
        self.clipped: Optional[torch.Tensor] = None
        self.visible: Optional[torch.Tensor] = None
        self.cap: Optional[int] = None
        self.frames = 0

    def add(self, anyz: torch.Tensor, cap: int) -> None:
        vis = anyz.sum(dim=-1)  # [bs, cams]
        clipped = (vis - cap).clamp(min=0).sum()
        most = vis.max()
        if self.clipped is None:
            self.clipped, self.visible = clipped, most
        else:
            self.clipped = torch.maximum(self.clipped, clipped)
            self.visible = torch.maximum(self.visible, most)
        self.cap = cap
        self.frames += 1

    def read(self) -> Dict[str, Optional[int]]:
        """max_capacity_clipped (0 when nothing was routed: dense SCA drops
        nothing), max_visible and the capacity (None when nothing was
        routed), and the routings counted."""
        return dict(max_capacity_clipped=0 if self.clipped is None else int(self.clipped),
                    max_visible=None if self.visible is None else int(self.visible),
                    sca_capacity=self.cap, routings=self.frames)


_CAPACITY_COUNTS: List[CapacityCount] = []


@contextmanager
def capacity_count():
    """A `CapacityCount` of every SCA routing made inside the block."""
    count = CapacityCount()
    _CAPACITY_COUNTS.append(count)
    try:
        yield count
    finally:
        _CAPACITY_COUNTS.remove(count)


def routing_inverse_vis(anyz: torch.Tensor, cap: int):
    """Slot of every query in its camera's selection, from visibility
    cumsums: inv[b, c, i] = j with top_idx[b, c, j] == i, found = selected."""
    q = anyz.shape[-1]
    nv = torch.cumsum(anyz.long(), dim=-1)  # inclusive visible count
    n_vis = nv[..., -1:]
    iq = torch.arange(q, device=anyz.device)
    rank = torch.where(anyz, nv - 1, n_vis + iq - nv)
    found = rank < cap
    return torch.where(found, rank, torch.zeros_like(rank)), found


def split_routing(routing: Dict, lo: int, hi: int) -> Dict:
    """The rows of a routing (`sca_capacity_routing`, over all q queries)
    whose query is in [lo, hi), as the routing of those hi - lo queries:
    each camera's kept rows packed in their order, padded to the largest
    count over the batch and cameras (pad rows read query 0 and are not
    visible, so they add 0), and the inverse map to the packed slots. The
    rows the whole routing drops stay dropped, and its fillers stay."""
    top_idx, vis_sel = routing["top_idx"], routing["vis_sel"]
    keep = (top_idx >= lo) & (top_idx < hi)  # [bs, cams, cap]
    rows = max(int(keep.sum(-1).max()), 1)
    # a stable sort on "not kept" packs the kept slots in their order
    order = torch.sort((~keep).to(torch.uint8), dim=-1, stable=True)[1][..., :rows]
    kept = torch.gather(keep, 2, order)
    packed = torch.cumsum(keep.long(), dim=-1) - 1  # each kept slot's packed slot
    found = routing["found"][..., lo:hi]
    inv = torch.gather(packed, 2, routing["inv"][..., lo:hi])
    return dict(
        top_idx=torch.where(kept, torch.gather(top_idx, 2, order) - lo, 0),
        vis_sel=torch.gather(vis_sel, 2, order) & kept,
        inv=torch.where(found, inv, 0), found=found, anyz=routing["anyz"][..., lo:hi])


class SpatialCrossAttention(nn.Module):
    """Camera -> BEV cross attention. Given a routing
    (`sca_capacity_routing`, or `split_routing` on a split), each camera
    attends for its routed queries only; given none, every camera processes
    every query and invisible ones are masked. Slots are normalised by the
    per-query camera hit count."""

    def __init__(self, embed_dims=256, num_cams=6, num_heads=8, num_levels=4,
                 num_points=8):
        super().__init__()
        self.num_cams = num_cams
        self.deformable_attention = MSDeformableAttention3D(
            embed_dims, num_heads, num_levels, num_points
        )
        self.output_proj = nn.Linear(embed_dims, embed_dims)
        self.dropout = QueryDropout(DROPOUT)

    def forward(
        self,
        query: torch.Tensor,  # [bs, q, e] (on a split, this rank's rows)
        value: torch.Tensor,  # [bs, cams, k, e]
        reference_points_cam: torch.Tensor,  # [bs, cams, q, nz, 2]
        bev_mask: torch.Tensor,  # [bs, cams, q, nz]
        spatial_shapes: Shapes,
        routing: Optional[Dict],  # sca_capacity_routing(bev_mask, ratio); None: dense
        split=None,  # runtime.parallel.QuerySplit: the queries are its rows
    ) -> torch.Tensor:
        bs, q, e = query.shape
        cams = self.num_cams
        v = value.reshape(bs * cams, -1, e)
        nz = reference_points_cam.shape[3]

        if routing is not None:
            top_idx, inv, found = routing["top_idx"], routing["inv"], routing["found"]
            anyz = routing["anyz"]
            cap = top_idx.shape[-1]
            bidx = torch.arange(bs, device=query.device)[:, None, None]
            cidx = torch.arange(cams, device=query.device)[:, None]
            q_sel = query[bidx, top_idx]  # [bs, cams, cap, e]
            ref_sel = reference_points_cam[bidx, cidx, top_idx]  # [bs, cams, cap, nz, 2]
            attn = self.deformable_attention(
                q_sel.reshape(bs * cams, cap, e), v,
                ref_sel.reshape(bs * cams, cap, nz, 2), spatial_shapes,
            ).view(bs, cams, cap, e)
            attn = attn * routing["vis_sel"][..., None].to(attn.dtype)
            # fold back to BEV slots: each query reads its slot in every
            # camera that selected it
            back = torch.gather(attn, 2, inv[..., None].expand(-1, -1, -1, e))
            slots = torch.where(found[..., None], back, torch.zeros_like(back)).sum(1)
        else:
            anyz = bev_mask.any(dim=-1)
            q_cam = query[:, None].expand(bs, cams, q, e).reshape(bs * cams, q, e)
            attn = self.deformable_attention(
                q_cam, v, reference_points_cam.reshape(bs * cams, q, nz, 2),
                spatial_shapes,
            ).view(bs, cams, q, e)
            slots = (attn * anyz[..., None].to(attn.dtype)).sum(1)

        count = anyz.float().sum(dim=1).clamp(min=1.0)
        slots = slots / count[..., None]
        return self.dropout(self.output_proj(slots), split) + query


class TemporalSelfAttention(nn.Module):
    """Deformable self-attention over the (prev BEV, current) queue of 2."""

    def __init__(self, embed_dims=256, num_heads=8, num_levels=1, num_points=4,
                 num_bev_queue=2):
        super().__init__()
        self.embed_dims, self.num_heads = embed_dims, num_heads
        self.num_levels, self.num_points = num_levels, num_points
        self.num_bev_queue = num_bev_queue
        nq = num_bev_queue
        self.sampling_offsets = Fp32Linear(
            embed_dims * nq, nq * num_heads * num_levels * num_points * 2
        )
        self.attention_weights = Fp32Linear(
            embed_dims * nq, nq * num_heads * num_levels * num_points
        )
        self.value_proj = nn.Linear(embed_dims, embed_dims)
        self.output_proj = nn.Linear(embed_dims, embed_dims)
        self.dropout = QueryDropout(DROPOUT)

    def forward(
        self,
        query: torch.Tensor,  # [bs, q, e] (on a split, this rank's rows)
        value_queue: torch.Tensor,  # [bs, 2, HW, e]: (prev BEV, current), whole
        query_pos: Optional[torch.Tensor],  # as query
        reference_points: torch.Tensor,  # [bs, 2, q, 1, 2]
        bev_h: int,
        bev_w: int,
        split=None,  # runtime.parallel.QuerySplit: the queries are its rows
    ) -> torch.Tensor:
        bs, q, e = query.shape
        h, l, p, nq = self.num_heads, self.num_levels, self.num_points, self.num_bev_queue
        identity = query
        if query_pos is not None:
            query = query + query_pos
        # offsets and weights see [prev-slot value, query] of each query
        rows = slice(None) if split is None else split.rows
        query_cat = torch.cat([value_queue[:, 0, rows], query], dim=-1)
        v = self.value_proj(value_queue).view(bs * nq, bev_h * bev_w, h, e // h)
        offsets = (
            self.sampling_offsets(query_cat).view(bs, q, h, nq, l, p, 2)
            .permute(0, 3, 1, 2, 4, 5, 6).reshape(bs * nq, q, h, l, p, 2)
        )
        # softmax over (l, p) per (h, queue)
        weights = (
            self.attention_weights(query_cat).view(bs, q, h, nq, l * p).softmax(-1)
            .view(bs, q, h, nq, l, p).permute(0, 3, 1, 2, 4, 5)
            .reshape(bs * nq, q, h, l, p).contiguous()
        )
        ref = reference_points.reshape(bs * nq, q, l, 2).float()
        norm = _normalizer(((bev_h, bev_w),), query)
        loc = ref[:, :, None, :, None, :] + offsets / norm[:, None, :]
        out = ms_deform_attn(v, ((bev_h, bev_w),), loc, weights)
        out = out.view(bs, nq, q, e).mean(dim=1)
        return self.dropout(self.output_proj(out), split) + identity


class CustomMSDeformableAttention(nn.Module):
    """Decoder cross-attention: single-level deformable attention over the
    BEV map, with output projection and residual."""

    def __init__(self, embed_dims=256, num_heads=8, num_levels=1, num_points=4):
        super().__init__()
        self.embed_dims, self.num_heads = embed_dims, num_heads
        self.num_levels, self.num_points = num_levels, num_points
        self.sampling_offsets = Fp32Linear(embed_dims, num_heads * num_levels * num_points * 2)
        self.attention_weights = Fp32Linear(embed_dims, num_heads * num_levels * num_points)
        self.value_proj = nn.Linear(embed_dims, embed_dims)
        self.output_proj = nn.Linear(embed_dims, embed_dims)
        self.dropout = nn.Dropout(DROPOUT)

    def forward(
        self,
        query: torch.Tensor,  # [bs, q, e]
        value: torch.Tensor,  # [bs, k, e]
        query_pos: Optional[torch.Tensor],
        reference_points: torch.Tensor,  # [bs, q, l, 2]
        spatial_shapes: Shapes,
    ) -> torch.Tensor:
        bs, q, e = query.shape
        h, l, p = self.num_heads, self.num_levels, self.num_points
        identity = query
        if query_pos is not None:
            query = query + query_pos
        v = self.value_proj(value).view(bs, -1, h, e // h)
        offsets = self.sampling_offsets(query).view(bs, q, h, l, p, 2)
        weights = (
            self.attention_weights(query).view(bs, q, h, l * p).softmax(-1)
            .view(bs, q, h, l, p)
        )
        loc = (
            reference_points[:, :, None, :, None, :].float()
            + offsets / _normalizer(spatial_shapes, query)[:, None, :]
        )
        out = ms_deform_attn(v, spatial_shapes, loc, weights)
        return self.dropout(self.output_proj(out)) + identity
