"""Training steps of one global batch split over the ranks of a launch: the
data-parallel check that a one-process step of the same batch is held
against.

    torchrun --nproc-per-node N -m bevformer_torch.tools.dp_step SPEC OUT
        [--device cuda] [--dist-backend nccl|gloo]

SPEC is a `torch.save` file this repo's callers write: {"cfg": a
`BEVFormerConfig`, "state_dict": the weights, "batch": a `Batch` or
`BatchV2` of B samples (B a multiple of N), "steps": how many steps,
"total_steps": the lr schedule's length}. Each rank builds the model on its
device, switches every dropout off (a one-process step of the same batch
draws other masks), takes its B / N samples (rank r the r-th share, in
order) and steps them `steps` times through `Trainer.step` (seed 0; DDP,
the synced BatchNorms, the rank-mean loss normalisers). Rank 0 writes OUT: {"outs":
each step's losses, grad norm and lr (the ranks' means), "step_ms",
"peak_gib", "states": the model's state dict after each step and
"grads": the trained parameters' gradients of the last step, averaged
over the ranks and clipped, all on the CPU, "world"}. Without a card `--device cuda` raises.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import torch

from bevformer_torch.runtime import Batch, Trainer, build_model, distributed


def rank_share(batch, rank: int, world: int):
    """Rank `rank`'s samples of a global `Batch` / `BatchV2`: the `rank`-th
    of `world` equal shares (a `BatchV2`'s DD3D targets, one row per
    camera image, with their samples)."""
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


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description="data-parallel training steps of one batch")
    p.add_argument("spec")
    p.add_argument("out")
    p.add_argument("--device", default="cuda")
    p.add_argument("--dist-backend", default=None, choices=("nccl", "gloo"))
    args = p.parse_args(argv)
    device = distributed.maybe_initialize(args.device, args.dist_backend)
    try:
        spec = torch.load(args.spec, map_location="cpu", weights_only=False)
        model = build_model(spec["cfg"], spec["state_dict"], device)
        trainer = Trainer(model, spec["total_steps"], seed=0)
        for m in model.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = 0.0  # (v1's history restores every module's train mode)
        world, rank = distributed.world_size(), distributed.rank()
        share = rank_share(spec["batch"], rank, world)
        batch = type(share)(*[
            {k: v.to(device) for k, v in t.items()} if isinstance(t, dict) else t.to(device)
            for t in share])
        steps = spec["steps"]
        del spec
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        outs, step_ms, states = [], [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            outs.append(trainer.step(batch))
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if rank == 0:
                states.append({k: v.detach().to("cpu", copy=True)
                               for k, v in model.state_dict().items()})
        peak = torch.cuda.max_memory_allocated(device) / 2**30 if device.type == "cuda" else None
        if rank == 0:
            torch.save(dict(outs=outs, step_ms=step_ms, peak_gib=peak, world=world, states=states,
                            grads={k: p.grad.cpu() for k, p in model.named_parameters()
                                   if p.grad is not None}),
                       args.out)
        distributed.barrier()
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    main()
