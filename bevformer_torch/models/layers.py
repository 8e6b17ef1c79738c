"""Shared building blocks: the FFN with residual, the dropout of BEV
queries split over ranks, the decoder's multi-head self-attention, the
learned BEV positional encoding, `inverse_sigmoid`, the BatchNorm synced
over ranks and the recomputation of a block in backward (`remat`).

Submodule and parameter names follow the reference `.pth` keys, so a
reference state dict loads with `load_state_dict`. Dropout sits where the
reference (and the JAX package) has it; `nn.Dropout` follows the module's
train/eval mode.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bevformer_torch.device import fp32
from bevformer_torch.runtime import distributed

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


class QueryDropout(nn.Dropout):
    """Dropout of [bs, q, ...] BEV queries that draws its mask of all q
    queries with `bernoulli_` and keeps the rows of `split` (a
    `runtime.parallel.QuerySplit`, whose rows `x` holds; None: all of
    them). The ranks of an `sp` group share their generator, so each keeps
    its rows of the one mask a process drops by, as a sharded
    `jax.random` draw equals an unsharded one. Train mode only."""

    def forward(self, x: torch.Tensor, split=None) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        shape = x.shape if split is None else (x.shape[0], split.q, *x.shape[2:])
        keep = torch.empty(shape, device=x.device).bernoulli_(1 - self.p)
        if split is not None:
            keep = keep[:, split.rows].clone()  # not a view of the whole mask
        return x * keep.to(x.dtype) * (1.0 / (1 - self.p))


class FFN(nn.Module):
    """mmcv FFN: Linear -> ReLU -> Dropout -> Linear -> Dropout, plus the
    residual. On BEV queries split over ranks, `split` names this rank's
    rows (`QueryDropout`)."""

    def __init__(self, embed_dims: int, feedforward_channels: int, dropout: float = 0.1):
        super().__init__()
        self.layers = nn.Sequential(
            nn.Sequential(
                nn.Linear(embed_dims, feedforward_channels), nn.ReLU(), QueryDropout(dropout)
            ),
            nn.Linear(feedforward_channels, embed_dims),
            QueryDropout(dropout),
        )

    def forward(self, x: torch.Tensor, split=None) -> torch.Tensor:
        (fc1, relu, drop1), fc2, drop2 = self.layers
        return x + drop2(fc2(drop1(relu(fc1(x)), split)), split)


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


class _SyncBatchNormFn(torch.autograd.Function):
    """Train-mode BatchNorm over the batch of every rank of the `dp` group
    (`runtime.distributed.dp_group`: the ranks that hold distinct samples).
    Forward all-reduces each rank's count, per-channel mean and sum of
    squared deviations (one float64 row a rank: summing rows of zeros but
    one's own is exact) and combines them (Chan's formula, which keeps the
    variance of a channel whose mean dwarfs its spread); backward
    all-reduces the per-channel sums of dy and dy * x_hat, which is linear
    in dy: the `sp` ranks' partial gradients of one sample add up after it.
    The affine gradients are this rank's own: DDP averages them with the
    rest."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, eps, momentum):
        world, rank, group = distributed.dp_size(), distributed.dp_index(), distributed.dp_group()
        c = x.shape[1]
        xf = x.float()
        var, mean = torch.var_mean(xf, dim=(0, 2, 3), correction=0)
        n = xf.numel() // c
        rows = torch.zeros((world, 2 * c + 1), dtype=torch.float64, device=x.device)
        rows[rank] = torch.cat([mean.double(), var.double() * n, rows.new_tensor([n])])
        dist.all_reduce(rows, group=group)
        counts = rows[:, 2 * c:]  # [world, 1]
        total = counts.sum()
        g_mean = (rows[:, :c] * counts).sum(0) / total
        m2 = (rows[:, c:2 * c] + counts * (rows[:, :c] - g_mean) ** 2).sum(0)
        g_var = m2 / total
        if running_mean is not None:
            running_mean.mul_(1 - momentum).add_(g_mean.float(), alpha=momentum)
            unbiased = m2 / max(float(total) - 1, 1.0)
            running_var.mul_(1 - momentum).add_(unbiased.float(), alpha=momentum)
        g_mean, invstd = g_mean.float(), torch.rsqrt(g_var + eps).float()
        x_hat = (xf - g_mean[:, None, None]) * invstd[:, None, None]
        ctx.save_for_backward(xf, weight, g_mean, invstd)
        ctx.total, ctx.dtype, ctx.group = float(total), x.dtype, group
        return (x_hat * weight[:, None, None] + bias[:, None, None]).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        xf, weight, mean, invstd = ctx.saved_tensors
        dy = dy.float()
        x_hat = (xf - mean[:, None, None]) * invstd[:, None, None]
        sum_dy = dy.sum((0, 2, 3))
        sum_dy_xhat = (dy * x_hat).sum((0, 2, 3))
        sums = torch.cat([sum_dy, sum_dy_xhat])
        dist.all_reduce(sums, group=ctx.group)
        c = sum_dy.shape[0]
        g_dy, g_dy_xhat = sums[:c] / ctx.total, sums[c:] / ctx.total
        dx = (weight * invstd)[:, None, None] * (
            dy - g_dy[:, None, None] - x_hat * g_dy_xhat[:, None, None])
        return dx.to(ctx.dtype), sum_dy_xhat, sum_dy, None, None, None, None


class SyncBatchNorm2d(nn.BatchNorm2d):
    """`nn.BatchNorm2d` whose train-mode batch statistics are those of the
    batch over the ranks of the `dp` group, as JAX's are over the whole
    `dp`-sharded batch (the reference's SyncBN); the `sp` ranks of a sample
    all hold it, and counting it once per `sp` rank would bias the running
    variance. Its parameters, buffers and state-dict keys are
    nn.BatchNorm2d's, and so is its running variance (torch's unbiased one,
    over the global count). In eval mode, or with a `dp` group of one rank
    or none, it is nn.BatchNorm2d itself."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and distributed.dp_size() > 1):
            return super().forward(x)
        momentum = 0.0 if self.momentum is None else self.momentum
        tracking = self.track_running_stats
        if tracking:
            self.num_batches_tracked.add_(1)
            if self.momentum is None:
                momentum = 1.0 / float(self.num_batches_tracked)
        return _SyncBatchNormFn.apply(
            x, self.weight, self.bias, self.running_mean if tracking else None,
            self.running_var if tracking else None, self.eps, momentum)


@contextlib.contextmanager
def _running_stats_kept(norms):
    """The BatchNorms in `norms` leave the block with the running statistics
    and counters they entered it with (the block runs them as it would)."""
    kept = [(m, [b.clone() for b in (m.running_mean, m.running_var, m.num_batches_tracked)])
            for m in norms]
    try:
        yield
    finally:
        with torch.no_grad():
            for m, (mean, var, count) in kept:
                m.running_mean.copy_(mean)
                m.running_var.copy_(var)
                m.num_batches_tracked.copy_(count)


def remat(module: nn.Module, *args):
    """`module(*args)`, its activations recomputed in backward instead of
    kept (`torch.utils.checkpoint`, non-reentrant; Flax's `nn.remat`). The
    random generators' states are replayed, so dropout draws the same masks.
    A train-mode BatchNorm inside updates its running statistics once: the
    recomputation gives them back as it found them, as Flax drops the
    recomputed mutation."""
    norms = [m for m in module.modules()
             if isinstance(m, nn.modules.batchnorm._BatchNorm) and m.track_running_stats]
    return checkpoint(module, *args, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(), _running_stats_kept(norms)))
