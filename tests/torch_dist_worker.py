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
what every rank received. CASE `sp_encoder`: the ranks form one `sp`
group, and each runs every `ENCODER_CASES` encoder of `encoder_case`
within `parallel.split_queries`, forward and backward of a seeded
cotangent; rank 0 writes every rank's BEV, gradients and msda calls
((B, Q) of each, forward).
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bevformer_torch.models import attention  # noqa: E402
from bevformer_torch.models.encoder import BEVFormerEncoder  # noqa: E402
from bevformer_torch.models.layers import SyncBatchNorm2d  # noqa: E402
from bevformer_torch.runtime import distributed, parallel  # noqa: E402

CHANNELS = 5
SAMPLES_PER_RANK = 2
# the split encoder's cases: (name, SCA capacity ratio, use_remat). At 31 x
# 33 BEV queries (odd) a capacity of 0.1 routes 128 rows a camera, fewer
# than five of the rigs see (visible queries dropped) and more than the
# back camera, zoomed in 2x, sees (fillers); 0.25 routes 256, more than
# any sees; 0 is the dense SCA
ENCODER_CASES = (("capacity", 0.1, False), ("capacity_remat", 0.1, True),
                 ("wide_capacity", 0.25, False), ("dense", 0.0, False))
BEV_HW = (31, 33)
ENCODER_IMG = (96, 160)
ENCODER_LEVELS = ((12, 20), (6, 10))


def encoder_case(ratio: float, remat: bool):
    """A seeded 2-layer encoder (32 channels, 4 heads, 6 cameras, 2 levels)
    in eval mode, its inputs (batch 2: a sample with a previous BEV and one
    without; the six synthetic rigs) and the cotangent of its BEV."""
    from bevformer_torch.data.synth import rig_lidar2img

    torch.manual_seed(0)
    enc = BEVFormerEncoder(num_layers=2, embed_dims=32, num_heads=4, feedforward_channels=64,
                           num_levels=len(ENCODER_LEVELS), sca_num_points=4, tsa_num_points=2,
                           sca_capacity_ratio=ratio, use_remat=remat).eval()
    rng = np.random.RandomState(1)
    bs, q, k = 2, BEV_HW[0] * BEV_HW[1], sum(h * w for h, w in ENCODER_LEVELS)

    def randn(*shape):
        return torch.tensor(rng.randn(*shape), dtype=torch.float32)

    l2i = rig_lidar2img(ENCODER_IMG[1], ENCODER_IMG[0])
    # the back camera (CAM_BACK, 4th) zoomed 2x about the image's centre
    cy, cx = ENCODER_IMG[0] / 2, ENCODER_IMG[1] / 2
    l2i[3, 0], l2i[3, 1] = 2 * l2i[3, 0] - cx * l2i[3, 2], 2 * l2i[3, 1] - cy * l2i[3, 2]
    inputs = dict(bev_query=randn(bs, q, 32), value=randn(bs, 6, k, 32), bev_pos=randn(bs, q, 32),
                  prev_bev=randn(bs, q, 32), has_prev=torch.tensor([True, False]),
                  shift=randn(bs, 2) * 0.01,
                  lidar2img=torch.tensor(np.stack([l2i] * bs), dtype=torch.float32))
    return enc, inputs, randn(bs, q, 32)


def run_encoder(enc, inputs, cotangent):
    """The encoder's BEV and the gradients of the cotangent's dot product
    with it: of every parameter and of the float inputs."""
    leaves = {k: v.clone().requires_grad_(True) for k, v in inputs.items() if v.is_floating_point()}
    args = dict(inputs, **leaves)
    out = enc(args["bev_query"], args["value"], args["bev_pos"], args["prev_bev"],
              args["has_prev"], args["shift"], args["lidar2img"], ENCODER_IMG, ENCODER_LEVELS,
              *BEV_HW)
    (out * cotangent).sum().backward()
    grads = {f"input.{k}": v.grad for k, v in leaves.items()}
    grads.update({n: p.grad for n, p in enc.named_parameters()})
    return out.detach(), grads


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


def sp_encoder(out: str) -> None:
    distributed.make_groups(1, distributed.world_size())
    calls = []
    plain = attention.ms_deform_attn

    def recorded(value, shapes, loc, attw):
        calls.append(tuple(loc.shape[:2]))
        return plain(value, shapes, loc, attw)

    attention.ms_deform_attn = recorded
    mine = {}
    with parallel.split_queries():
        for name, ratio, remat in ENCODER_CASES:
            calls.clear()
            bev, grads = run_encoder(*encoder_case(ratio, remat))
            mine[name] = dict(bev=bev, grads=grads, calls=list(calls),
                              split=parallel.query_split(BEV_HW[0] * BEV_HW[1])[:3])
    gathered = distributed.all_gather_object(mine)
    if distributed.rank() == 0:
        torch.save(gathered, out)


def main() -> None:
    case, out = sys.argv[1], sys.argv[2]
    distributed.maybe_initialize("cpu")
    try:
        {"sync_bn": sync_bn, "allgather": allgather, "sp_encoder": sp_encoder}[case](out)
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    main()
