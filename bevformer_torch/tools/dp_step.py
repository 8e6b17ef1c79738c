"""Training steps of one global batch split over the ranks of a launch: the
data- and sequence-parallel check that a one-process step of the same
batch is held against.

    torchrun --nproc-per-node N -m bevformer_torch.tools.dp_step SPEC OUT
        [--dp D] [--sp S] [--dropout] [--device cuda] [--dist-backend nccl|gloo]

SPEC is a `torch.save` file this repo's callers write: {"cfg": a
`BEVFormerConfig`, "state_dict": the weights, "batch": a `Batch` or
`BatchV2` of B samples (B a multiple of D), "steps": how many steps,
"total_steps": the lr schedule's length, and optionally "frame": the
arguments of a v1 model's forward (images, can_bus, lidar2img, prev_bev,
has_prev) to encode first}. The N ranks form a (D, S) mesh
(`runtime.parallel.check_mesh`: D x S = N, D defaults to N // S, S to 1).
Each rank builds the model on its device, switches every dropout off
unless `--dropout` (a one-process step of two samples draws other masks),
takes the B / D samples of its `dp` index (index d the d-th share, in
order; its S ranks split their BEV queries in the encoder) and steps them
`steps` times through `Trainer.step` (seed 0; DDP, the synced BatchNorms,
the rank-mean loss normalisers). Rank 0 writes OUT: {"outs": each step's
losses, grad norm and lr (the `dp` group's means), "step_ms", "peak_gib",
"states": the model's state dict after each step and "grads": the trained
parameters' gradients of the last step, averaged over the ranks and
clipped, all on the CPU, "world", "mesh": (D, S), "ranks": each rank's
{"step_ms", "peak_gib", "launches" (`kernels.launch_counts`, over the
steps) and "queries" (`kernels.launch_queries`: launches by (B, Q)), and
given a frame "encode" (`encode`'s record)}, and given a frame "bev": its
BEV}. Without a card `--device cuda` raises.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import torch

from bevformer_torch.device import precision
from bevformer_torch.kernels import launch_counts, launch_queries, zero_counts
from bevformer_torch.runtime import Batch, Trainer, build_model, distributed, parallel
from bevformer_torch.runtime.train_v2 import eval_mode


def rank_share(batch, rank: int, world: int):
    """The samples of `dp` index `rank` of a global `Batch` / `BatchV2`: the
    `rank`-th of `world` equal shares (a `BatchV2`'s DD3D targets, one row
    per camera image, with their samples)."""
    b = batch.images.shape[0]
    if b % world:
        raise ValueError(f"a batch of {b} samples does not split over {world} ranks")
    per = b // world
    lo, hi = rank * per, (rank + 1) * per
    if isinstance(batch, Batch):
        return Batch(*[t[lo:hi] for t in batch])
    cams = batch.images.shape[2]
    return batch._replace(
        **{k: v[lo:hi] for k, v in batch._asdict().items() if k != "mono_targets"},
        mono_targets={k: v[lo * cams:hi * cams] for k, v in batch.mono_targets.items()})


def encode(model, frame, device) -> dict:
    """A v1 frame's BEV (`frame`: the forward's arguments, on the CPU),
    encoded in eval mode without gradient within `parallel.split_queries`
    (this rank's queries, where the mesh has an `sp` axis), after a
    warm-up: {"bev" on the CPU, "ms", "peak_gib" (None on the CPU),
    "launches", "queries"} of the second run."""
    args = [t.to(device) for t in frame]
    cuda = device.type == "cuda"
    with eval_mode(model), torch.no_grad(), precision(model.cfg.dtype, device.type), \
            parallel.split_queries():
        model(*args, only_bev=True)
        if cuda:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        zero_counts()
        t0 = time.perf_counter()
        bev = model(*args, only_bev=True)
        if cuda:
            torch.cuda.synchronize(device)
        ms = (time.perf_counter() - t0) * 1e3
    return dict(bev=bev.cpu(), ms=ms,
                peak_gib=torch.cuda.max_memory_allocated(device) / 2**30 if cuda else None,
                launches=launch_counts(), queries=launch_queries())


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description="data-parallel training steps of one batch")
    p.add_argument("spec")
    p.add_argument("out")
    p.add_argument("--dp", type=int, default=None)
    p.add_argument("--sp", type=int, default=1)
    p.add_argument("--dropout", action="store_true", help="keep the config's dropout")
    p.add_argument("--device", default="cuda")
    p.add_argument("--dist-backend", default=None, choices=("nccl", "gloo"))
    args = p.parse_args(argv)
    device = distributed.maybe_initialize(args.device, args.dist_backend)
    try:
        dp = parallel.check_mesh(args.dp, args.sp)
        distributed.make_groups(dp, args.sp)
        spec = torch.load(args.spec, map_location="cpu", weights_only=False)
        model = build_model(spec["cfg"], spec["state_dict"], device)
        # the frame first, beside nothing but the model (no batch, no DDP)
        encoded = None if "frame" not in spec else encode(model, spec["frame"], device)
        trainer = Trainer(model, spec["total_steps"], seed=0)
        for m in model.modules():
            if isinstance(m, torch.nn.Dropout) and not args.dropout:
                m.p = 0.0  # (v1's history restores every module's train mode)
        world, rank = distributed.world_size(), distributed.rank()
        share = rank_share(spec["batch"], distributed.dp_index(), dp)
        batch = type(share)(*[
            {k: v.to(device) for k, v in t.items()} if isinstance(t, dict) else t.to(device)
            for t in share])
        steps = spec["steps"]
        del spec
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        zero_counts()
        outs, step_ms, states = [], [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            outs.append(trainer.step(batch))
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if rank == 0:
                states.append({k: v.detach().to("cpu", copy=True)
                               for k, v in model.state_dict().items()})
        peak = torch.cuda.max_memory_allocated(device) / 2**30 if device.type == "cuda" else None
        mine = dict(step_ms=step_ms, peak_gib=peak, launches=launch_counts(),
                    queries=launch_queries())
        if encoded is not None:
            bev = encoded.pop("bev")
            mine["encode"] = encoded
        ranks = distributed.all_gather_object(mine)
        if rank == 0:
            torch.save(dict(outs=outs, step_ms=step_ms, peak_gib=peak, world=world, states=states,
                            mesh=(dp, args.sp), ranks=ranks,
                            grads={k: p.grad.cpu() for k, p in model.named_parameters()
                                   if p.grad is not None},
                            **({} if encoded is None else {"bev": bev})),
                       args.out)
        distributed.barrier()
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    main()
