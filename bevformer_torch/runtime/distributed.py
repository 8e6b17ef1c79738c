"""Processes over ranks: the process group, a barrier, and the gather of
evaluation results.

Port of `bevformer_tpu/runtime/distributed.py` (reference `init_dist`,
`tools/train.py:168-175`, and `collect_results_cpu`, `apis/test.py:116-160`):
  * `maybe_initialize` joins the process group a `torchrun` launch describes
    in its environment (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`,
    `MASTER_PORT`). On the card the backend is NCCL and each rank's device
    `cuda:LOCAL_RANK`; gloo only where the caller asks for it (`--device
    cpu`, or `--dist-backend gloo` for two ranks on one card, which NCCL
    refuses). A failed initialisation raises.
  * `allgather_results` gathers each rank's per-sample result rows to every
    rank (of the world, or of a group) in rank order, in chunks padded to
    each chunk's largest box count, as JAX's does, with `all_reduce` of
    zero-padded rows (which NCCL and gloo both take, on CUDA tensors too).
  * `make_groups(dp, sp)` lays the ranks out as the `(dp, sp)` mesh of
    `bevformer_tpu/runtime/mesh.py:25-29` does the devices, row-major:
    rank = d * sp + s. The `sp` group (the ranks of one `d`, which hold the
    same samples) splits the encoder's BEV queries
    (`runtime.parallel.split_queries`); the `dp` group (the ranks of one
    `s`, which hold distinct samples) is what the synced BatchNorm and the
    loss normalisers reduce over. `dp_index`, `sp_index`, `dp_group`,
    `sp_group` and `dp_size`, `sp_size` read the layout.

Without a process group (a process that `torchrun` did not start), each of
these is a no-op and `world_size()` is 1; without `make_groups`, or at
`sp` 1, the `dp` group is the world and each rank its own `sp` group.
"""

from __future__ import annotations

import os
from typing import Any, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from bevformer_torch.device import resolve as resolve_device


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if initialized() else 1


def rank() -> int:
    return dist.get_rank() if initialized() else 0


# the (dp, sp) layout of the ranks: `make_groups`
_LAYOUT = dict(sp=1, dp_group=None, sp_group=None)


def make_groups(dp: int, sp: int) -> None:
    """Lay the `dp * sp` ranks out as a `(dp, sp)` mesh, rank = d * sp + s,
    and make its groups: `sp` groups of consecutive ranks, `dp` groups of
    the ranks with the same `s`. Every rank calls it, with the same sizes
    (each makes every group, in the same order). At `sp` 1 it makes none:
    the `dp` group is the world."""
    if dp * sp != world_size():
        raise ValueError(f"a ({dp}, {sp}) mesh over {world_size()} rank(s)")
    _LAYOUT.update(sp=sp, dp_group=None, sp_group=None)
    if sp == 1:
        return
    for d in range(dp):
        group = dist.new_group([d * sp + s for s in range(sp)])
        if d == dp_index():
            _LAYOUT["sp_group"] = group
    for s in range(sp):
        group = dist.new_group([d * sp + s for d in range(dp)])
        if s == sp_index():
            _LAYOUT["dp_group"] = group


def sp_size() -> int:
    return _LAYOUT["sp"]


def dp_size() -> int:
    return world_size() // sp_size()


def dp_index() -> int:
    """This rank's `d`: the samples it holds (its rank without an `sp` axis)."""
    return rank() // sp_size()


def sp_index() -> int:
    """This rank's `s`: its place in its `sp` group."""
    return rank() % sp_size()


def dp_group():
    """The group of the ranks with this rank's `s`, for collectives (None:
    the world, which it is at `sp` 1)."""
    return _LAYOUT["dp_group"]


def sp_group():
    """The group of the ranks with this rank's `d` (None at `sp` 1)."""
    return _LAYOUT["sp_group"]


def maybe_initialize(device="cuda", backend: Optional[str] = None) -> torch.device:
    """The device this process runs on, after joining the process group of
    a `torchrun` launch (none without `WORLD_SIZE` in the environment).

    Under a launch, a `device` of "cuda" without an index is
    `cuda:LOCAL_RANK`; an explicit index is kept (two gloo ranks on one
    card both pass `cuda:0`). `backend` defaults to NCCL on the card and
    gloo on the CPU; NCCL on the CPU raises. Must run before any other use
    of the card. Returns `device` resolved (`device.resolve`: no card for a
    CUDA device raises) when there is no launch."""
    device = torch.device(device)
    launched = "WORLD_SIZE" in os.environ
    if launched and device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    device = resolve_device(device)
    if not launched or initialized():
        return device
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"the NCCL backend runs on the card, not on {device}: use gloo")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    address = f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    dist.init_process_group(backend, init_method=address, rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    return device


def shutdown() -> None:
    """Leave the process group, where this process joined one."""
    if initialized():
        dist.destroy_process_group()


def barrier() -> None:
    """Every rank waits here for the others (`dist.barrier`, `apis/test.py:138`)."""
    if world_size() > 1:
        dist.barrier()


def comm_device() -> torch.device:
    """Where the process group's tensors live: the card under NCCL, the CPU
    under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """[n, *x.shape]: every rank's `x` (same shape and dtype on every rank)
    of the n ranks of `group` (None: the world) in rank order, on every
    one of them. An `all_reduce` of zero rows but one's own, exact for any
    values."""
    rows = torch.zeros((dist.get_world_size(group), *x.shape), dtype=x.dtype,
                       device=comm_device())
    rows[dist.get_rank(group)] = x.to(rows.device)
    dist.all_reduce(rows, group=group)
    return rows


def all_gather_object(obj: Any) -> List[Any]:
    """Every rank's picklable `obj`, in rank order ([obj] alone)."""
    if world_size() == 1:
        return [obj]
    out: List[Any] = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out


def mean_over_ranks(x: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of `x` over the ranks of `group` (None: the world; `x`
    itself alone), without gradient."""
    if not initialized():
        return x
    total = x.detach().clone()
    dist.all_reduce(total, group=group)
    return total / dist.get_world_size(group)


def allgather_results(local: List[np.ndarray], width: int,
                      chunk_samples: int = 256, group=None) -> List[np.ndarray]:
    """Every rank's per-sample result arrays ([n_i, width] float32, n_i
    varying) on every rank of `group` (None: the world), in rank order:
    rank 0's samples, then rank 1's, ... (the contiguous eval split makes
    that the split's order).

    Each rank's sample counts and per-sample box counts are gathered first;
    then chunks of `chunk_samples` samples, each padded only to that chunk's
    largest box count over the ranks, so the padded traffic stays within
    world x chunk_samples x max boxes x width floats."""
    if not initialized() or dist.get_world_size(group) == 1:
        return list(local)
    n_local = len(local)
    n_by_rank = gather_rows(torch.tensor([n_local], dtype=torch.int64), group)[:, 0].tolist()
    max_s = max(n_by_rank)
    sizes = torch.zeros((max_s,), dtype=torch.int64)
    sizes[:n_local] = torch.tensor([a.shape[0] for a in local], dtype=torch.int64)
    sizes_by_rank = gather_rows(sizes, group).cpu().numpy()  # [world, max_s]
    per_rank: List[List[np.ndarray]] = [[] for _ in n_by_rank]
    for c0 in range(0, max_s, chunk_samples):
        c1 = min(c0 + chunk_samples, max_s)
        max_n = max(1, int(sizes_by_rank[:, c0:c1].max(initial=0)))
        packed = np.zeros((c1 - c0, max_n, width), np.float32)
        for i in range(c0, min(c1, n_local)):
            packed[i - c0, : local[i].shape[0]] = local[i]
        rows = gather_rows(torch.from_numpy(packed), group).cpu().numpy()  # [world, c1-c0, max_n, w]
        for r, n_r in enumerate(n_by_rank):
            for i in range(c0, min(c1, n_r)):
                per_rank[r].append(rows[r, i - c0, : sizes_by_rank[r, i]].copy())
    return [a for rows in per_rank for a in rows]
