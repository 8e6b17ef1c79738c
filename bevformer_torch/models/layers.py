"""Shared building blocks: the FFN with residual, the decoder's multi-head
self-attention, the learned BEV positional encoding and `inverse_sigmoid`.

Submodule and parameter names follow the reference `.pth` keys, so a
reference state dict loads with `load_state_dict`. Dropout sits where the
reference (and the JAX package) has it; `nn.Dropout` follows the module's
train/eval mode.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from bevformer_torch.device import fp32

# flax.linen.LayerNorm's default epsilon, which the JAX package uses
LN_EPS = 1e-6


def layer_norm(dims: int) -> nn.LayerNorm:
    return nn.LayerNorm(dims, eps=LN_EPS)


class Fp32Linear(nn.Linear):
    """An `nn.Linear` that computes in fp32, on its input cast to fp32,
    whatever the autocast around it: the Dense layers the JAX package pins
    to fp32 under bf16 (sampling offsets, attention weights, reference
    points, the head's last layers). Its parameters and state-dict keys are
    nn.Linear's."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with fp32(x.device):
            return super().forward(x.float())


class FFN(nn.Module):
    """mmcv FFN: Linear -> ReLU -> Dropout -> Linear -> Dropout, plus the
    residual."""

    def __init__(self, embed_dims: int, feedforward_channels: int, dropout: float = 0.1):
        super().__init__()
        self.layers = nn.Sequential(
            nn.Sequential(
                nn.Linear(embed_dims, feedforward_channels), nn.ReLU(), nn.Dropout(dropout)
            ),
            nn.Linear(feedforward_channels, embed_dims),
            nn.Dropout(dropout),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.layers(x)


class _PackedProjection(nn.Module):
    """The parameters of `torch.nn.MultiheadAttention` (packed q/k/v input
    projection and the output projection) under their reference names."""

    def __init__(self, embed_dims: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dims, embed_dims))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dims))
        self.out_proj = nn.Linear(embed_dims, embed_dims)
        nn.init.xavier_uniform_(self.in_proj_weight)


class MultiheadAttention(nn.Module):
    """Multi-head self-attention written as matmul and softmax, with dropout
    on the attention map and on the output projection, and the residual.
    Inputs are batch-first [bs, n, e]."""

    def __init__(self, embed_dims: int, num_heads: int):
        super().__init__()
        self.embed_dims = embed_dims
        self.num_heads = num_heads
        self.attn = _PackedProjection(embed_dims)
        # the decoder's attn_dropout (`decoder.py:46-47` of the JAX package)
        self.attn_drop = nn.Dropout(0.1)
        self.proj_drop = nn.Dropout(0.1)

    def forward(
        self, query: torch.Tensor, query_pos: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        identity = query
        qk = query + query_pos if query_pos is not None else query
        e, h = self.embed_dims, self.num_heads
        dh = e // h
        w, b = self.attn.in_proj_weight, self.attn.in_proj_bias
        q = F.linear(qk, w[:e], b[:e])
        k = F.linear(qk, w[e:2 * e], b[e:2 * e])
        v = F.linear(query, w[2 * e:], b[2 * e:])
        bs, n, _ = q.shape
        q = q.view(bs, n, h, dh).transpose(1, 2)
        k = k.view(bs, n, h, dh).transpose(1, 2)
        v = v.view(bs, n, h, dh).transpose(1, 2)
        logits = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(dh))
        out = torch.matmul(self.attn_drop(logits.softmax(dim=-1)), v)
        out = out.transpose(1, 2).reshape(bs, n, e)
        return identity + self.proj_drop(self.attn.out_proj(out))


class LearnedPositionalEncoding(nn.Module):
    """mmdet LearnedPositionalEncoding over the BEV grid: per cell,
    concat(col_embed[x], row_embed[y]) -> [bs, h*w, 2*num_feats]."""

    def __init__(self, num_feats: int, row_num_embed: int, col_num_embed: int):
        super().__init__()
        self.row_embed = nn.Embedding(row_num_embed, num_feats)
        self.col_embed = nn.Embedding(col_num_embed, num_feats)

    def forward(self, bs: int) -> torch.Tensor:
        row = self.row_embed.weight  # [h, F]
        col = self.col_embed.weight  # [w, F]
        h, w, f = row.shape[0], col.shape[0], row.shape[1]
        pos = torch.cat(
            [col[None, :, :].expand(h, w, f), row[:, None, :].expand(h, w, f)],
            dim=-1,
        ).reshape(h * w, 2 * f)
        return pos[None].expand(bs, h * w, 2 * f)


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1.0 - x).clamp(min=eps))
