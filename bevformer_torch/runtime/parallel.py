"""The `(dp, sp)` mesh over the ranks of a process group: what the axes of
`bevformer_tpu/runtime/mesh.py` do, without the mesh.

`dp` (data parallel). JAX shards the global batch over `dp` and XLA reduces
the gradients inside the jitted step. Here each `dp` index steps its own
samples and `DistributedDataParallel` averages the gradients in backward;
the loss normalisers are means over the `dp` group
(`core.losses.rank_mean_normalisers`) and the trained BatchNorms take their
statistics over it (`models.layers.SyncBatchNorm2d`), so the step equals
JAX's over the global batch.

`sp` (sequence parallel). JAX shards the encoder's BEV queries over `sp`
(`maybe_shard(bev_query, "dp", "sp", None)`, `models/encoder.py:243-246`,
and after every layer, `:176`). Here the `sp` ranks of one `dp` index hold
the same samples; within `split_queries` (the counterpart of
`mesh.activate`) the encoder asks `query_split` for this rank's contiguous
range of queries (`torch.tensor_split`'s), runs TSA, SCA and the FFN on it,
and `gather_queries` hands every rank the whole BEV after each layer.
Everything else is replicated over `sp`. The loss on every rank is
unscaled, the gather's backward sums the ranks' gradients of each range,
and DDP averages over all `dp * sp` ranks: a replicated parameter's `sp`
equal gradients and a split one's `sp` partial sums (each `sp` times its
share through the last gather) both average to the `dp` mean of each
sample's gradient, JAX's.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
from torch.nn.parallel import DistributedDataParallel

from bevformer_torch.runtime import distributed


def check_mesh(dp: Optional[int], sp: int) -> int:
    """The data-parallel size of a `(dp, sp)` mesh over the world: `dp`
    (None: world // sp). Raises ValueError unless dp * sp is the world
    size."""
    world = distributed.world_size()
    if sp < 1 or world % sp:
        raise ValueError(f"--sp {sp} does not divide the {world} rank(s): launch dp x sp "
                         "processes (torchrun --nproc-per-node, or bevformer_torch/tools/"
                         "dist_train.sh)")
    if dp is None:
        dp = world // sp
    if dp * sp != world:
        raise ValueError(f"--dp {dp} with {world} rank(s) at --sp {sp}: launch dp x sp "
                         f"processes (torchrun --nproc-per-node {dp * sp}, or "
                         "bevformer_torch/tools/dist_train.sh)")
    return dp


class LossModule(nn.Module):
    """`loss(model, batch)` as a module's forward, so that DDP sees the
    whole training computation (a V2 loss runs the DD3D head outside the
    detector's forward). Its state is the model's, under `model.`."""

    def __init__(self, model: nn.Module, loss: Callable):
        super().__init__()
        self.model = model
        self.loss = loss

    def forward(self, batch):
        return self.loss(self.model, batch)


def data_parallel(model: nn.Module, loss: Callable) -> nn.Module:
    """A module whose forward(batch) is `loss(model, batch)`: under a
    process group (any world size) wrapped in DDP over the world, which
    all-reduces the gradients in backward and averages them. Build it
    after the frozen parameters have `requires_grad=False`.

    Every trainable parameter of the v1 and V2 configs takes part in each
    step's loss, so DDP runs without `find_unused_parameters` and with a
    graph that may change between steps (GroupDETR, a history frame or
    none). Buffers are not broadcast: FrozenBN's never change, and the
    synced BatchNorms keep theirs equal on every rank."""
    module = LossModule(model, loss)
    if not distributed.initialized():
        return module
    device = next(model.parameters()).device
    return DistributedDataParallel(
        module, device_ids=[device.index] if device.type == "cuda" else None,
        broadcast_buffers=False)


_SPLIT = {"on": False}


@contextlib.contextmanager
def split_queries():
    """Within the block, an encoder runs its layers on this rank's range of
    BEV queries (`query_split`) where the mesh has an `sp` axis
    (`distributed.make_groups`); without one the block changes nothing."""
    before = _SPLIT["on"]
    _SPLIT["on"] = True
    try:
        yield
    finally:
        _SPLIT["on"] = before


class QuerySplit(NamedTuple):
    """This rank's share of q BEV queries: rows [lo, hi) of every
    [bs, q, ...] tensor, and every `sp` rank's (lo, hi) in rank order."""

    q: int
    lo: int
    hi: int
    bounds: Tuple[Tuple[int, int], ...]
    group: Any

    @property
    def rows(self) -> slice:
        return slice(self.lo, self.hi)


def query_bounds(q: int, sp: int) -> Tuple[Tuple[int, int], ...]:
    """The (lo, hi) of each of `torch.tensor_split`'s `sp` ranges of q (the
    first q % sp one longer)."""
    sizes = [q // sp + (i < q % sp) for i in range(sp)]
    return tuple((sum(sizes[:i]), sum(sizes[:i + 1])) for i in range(sp))


def query_split(q: int) -> Optional[QuerySplit]:
    """This rank's range of q queries within `split_queries` on a mesh
    with an `sp` axis: the `sp_index`-th of `query_bounds`. None
    otherwise."""
    sp = distributed.sp_size()
    if not _SPLIT["on"] or sp == 1:
        return None
    bounds = query_bounds(q, sp)
    lo, hi = bounds[distributed.sp_index()]
    return QuerySplit(q, lo, hi, bounds, distributed.sp_group())


class _GatherQueries(torch.autograd.Function):
    """Forward: every `sp` rank's [bs, hi - lo, ...] rows, padded to the
    longest range and all-gathered, as the whole [bs, q, ...]. Backward:
    the sum over the ranks of the gradient of this rank's rows (a
    reduce-scatter of sums), computed as an all-reduce of the whole
    gradient, which gloo takes too."""

    @staticmethod
    def forward(ctx, x, split: QuerySplit):
        ctx.split = split
        comm = distributed.comm_device()
        longest = max(hi - lo for lo, hi in split.bounds)
        padded = x.new_zeros((x.shape[0], longest, *x.shape[2:]), device=comm)
        padded[:, : x.shape[1]] = x.to(comm)
        parts = [torch.empty_like(padded) for _ in split.bounds]
        dist.all_gather(parts, padded, group=split.group)
        whole = torch.cat([p[:, : hi - lo] for p, (lo, hi) in zip(parts, split.bounds)], dim=1)
        return whole.to(x.device)

    @staticmethod
    def backward(ctx, grad):
        split = ctx.split
        total = grad.to(distributed.comm_device(), copy=True)
        dist.all_reduce(total, group=split.group)
        return total[:, split.rows].to(grad.device), None


def gather_queries(x: torch.Tensor, split: Optional[QuerySplit]) -> torch.Tensor:
    """The whole [bs, q, ...] from every `sp` rank's rows of it (`x`, this
    rank's [bs, hi - lo, ...]); `x` itself without a split."""
    if split is None:
        return x
    return _GatherQueries.apply(x, split)
