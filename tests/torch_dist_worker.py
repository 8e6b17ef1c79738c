"""Worker processes of `tests/test_torch_distributed.py`, one per rank of a
`torchrun` launch on the CPU (gloo). It imports torch and the port only,
never JAX:

    python -m torch.distributed.run --nproc-per-node N tests/torch_dist_worker.py CASE OUT

CASE `sync_bn`: each rank normalises its two samples of a seeded global
batch with a train-mode `SyncBatchNorm2d` and backpropagates a seeded
cotangent; rank 0 writes every rank's output, dx, dgamma, dbeta and
running statistics. CASE `allgather`: each rank holds a seeded, ragged
list of result arrays (rank r: 2 r + 1 samples, some without boxes) and
gathers them with `allgather_results` in chunks of 2 samples; rank 0 writes
what every rank received.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bevformer_torch.models.layers import SyncBatchNorm2d  # noqa: E402
from bevformer_torch.runtime import distributed  # noqa: E402

CHANNELS = 5
SAMPLES_PER_RANK = 2


def bn_inputs(world: int):
    """The global batch x [world * 2, C, 3, 4] (channel means far from 0),
    the cotangent, and the BN's weight, bias and running statistics."""
    rng = np.random.RandomState(0)
    shape = (world * SAMPLES_PER_RANK, CHANNELS, 3, 4)
    x = rng.randn(*shape) * rng.uniform(0.5, 3.0, (1, CHANNELS, 1, 1)) + rng.uniform(
        -20, 20, (1, CHANNELS, 1, 1))
    g = rng.randn(*shape)
    params = [rng.uniform(0.5, 1.5, CHANNELS), rng.randn(CHANNELS),
              rng.randn(CHANNELS), rng.uniform(0.5, 2.0, CHANNELS)]
    return [torch.tensor(a, dtype=torch.float32) for a in (x, g, *params)]


def ragged_results(rank: int):
    """Rank `rank`'s results: 2 rank + 1 arrays [n_i, 11], n_i in 0..4."""
    rng = np.random.RandomState(100 + rank)
    return [rng.randn(int(rng.randint(0, 5)), 11).astype(np.float32)
            for _ in range(2 * rank + 1)]


def sync_bn(out: str) -> None:
    world, rank = distributed.world_size(), distributed.rank()
    x, g, weight, bias, mean, var = bn_inputs(world)
    lo, hi = rank * SAMPLES_PER_RANK, (rank + 1) * SAMPLES_PER_RANK
    bn = SyncBatchNorm2d(CHANNELS)
    with torch.no_grad():
        for p, v in zip((bn.weight, bn.bias, bn.running_mean, bn.running_var),
                        (weight, bias, mean, var)):
            p.copy_(v)
    xr = x[lo:hi].clone().requires_grad_(True)
    y = bn.train()(xr)
    (y * g[lo:hi]).sum().backward()
    mine = dict(y=y.detach(), dx=xr.grad, dweight=bn.weight.grad, dbias=bn.bias.grad,
                **{k: v.clone() for k, v in bn.state_dict().items()})
    gathered = distributed.all_gather_object(mine)
    if rank == 0:
        torch.save(gathered, out)


def allgather(out: str) -> None:
    got = distributed.allgather_results(ragged_results(distributed.rank()), width=11,
                                        chunk_samples=2)
    gathered = distributed.all_gather_object(got)
    if distributed.rank() == 0:
        torch.save(gathered, out)


def main() -> None:
    case, out = sys.argv[1], sys.argv[2]
    distributed.maybe_initialize("cpu")
    try:
        {"sync_bn": sync_bn, "allgather": allgather}[case](out)
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    main()
