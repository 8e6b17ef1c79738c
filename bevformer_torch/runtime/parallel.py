"""Data parallelism over the ranks of a process group: what the `dp` axis of
`bevformer_tpu/runtime/mesh.py` does, without the mesh.

JAX shards the global batch over `dp` and XLA reduces the gradients inside
the jitted step. Here each rank steps its own samples and
`DistributedDataParallel` averages the gradients in backward; the loss
normalisers are rank means (`core.losses.rank_mean_normalisers`) and the
trained BatchNorms take their statistics over every rank
(`models.layers.SyncBatchNorm2d`), so the step equals JAX's over the
global batch. The `sp` axis (BEV queries sharded inside the encoder) is
not ported.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn as nn
from torch.nn.parallel import DistributedDataParallel

from bevformer_torch.runtime import distributed


def check_mesh(dp: Optional[int], sp: int) -> int:
    """The data-parallel size: `dp`, which must equal the world size (None:
    the world size). `sp` above 1 raises NotImplementedError."""
    if sp != 1:
        raise NotImplementedError(
            f"--sp {sp}: the sequence-parallel axis (BEV queries sharded over ranks inside "
            "the encoder) is not ported; ROADMAP.md §1 queues it")
    world = distributed.world_size()
    if dp is not None and dp != world:
        raise ValueError(f"--dp {dp} with {world} rank(s): launch --dp processes (torchrun "
                         f"--nproc-per-node {dp}, or bevformer_torch/tools/dist_train.sh)")
    return world


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
    process group (any world size) wrapped in DDP, which all-reduces the
    gradients in backward and averages them. Build it after the frozen
    parameters have `requires_grad=False`.

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
