"""Training CLI: the JAX package's `tools/train.py`, v1 and V2.

    python3 -m bevformer_torch.tools.train <config> --data-root DATA
        [--work-dir DIR] [--max-iters N] [--resume-from CKPT] [--load-from PTH]
        [--seed 0] [--log-interval 50] [--ckpt-interval-epochs 1]
        [--eval-interval-epochs 0] [--cfg-options key=val ...] [--device cuda]
        [--dp N] [--sp S] [--dist-backend nccl|gloo]

DATA holds `nuscenes_infos_temporal_train.pkl` (and `_val.pkl` for the
in-training evaluation), as `bevformer_torch.tools.create_data synth`
writes them. Each step takes `samples_per_gpu` samples: for a v1 config
of the `GroupShuffleSampler` order (`get_train_sample`); for a V2 config
(`bevformerv2-r50-*`, JAX `_train_v2` :265-391) indices drawn uniformly,
a sample without ground truth drawn again (`get_train_sample_v2`: the
frames of `cfg.frames`, the resize ladder, the flip, GlobalRotScaleTrans
and the DD3D targets). JAX draws them with `jax.random`; the port draws
each step's indices, and seeds the dataset's augmentation draws, from
generators of (`--seed`, step), so that a resumed run draws what the
unbroken run would have. An epoch is len(dataset) // samples_per_gpu
steps, the run `total_epochs` of them or `--max-iters` steps. A thread
builds the batches two steps ahead (`BatchPrefetcher`); `train_log.jsonl`
records, every `--log-interval` steps and at the last, the losses, grad
norm, lr, the step's time (`step_ms`), the thread's time for the batch
(`host_ms`) and the time the step waited for it (`data_wait_ms`).

Checkpoints go to `WORK_DIR/ckpts/iter_<step>.pth` (`runtime.checkpoint.
save_checkpoint`: mmcv's layout plus the schedule, step and random
generators) every `--ckpt-interval-epochs` epochs and at the last step.
`--resume-from` continues such a run; `--load-from` starts from the
weights of a model-zoo `.pth` (or of a checkpoint), with a fresh optimizer.
Without it the weights are `init_state_dict`'s, seeded by `--seed`, which
also seeds the data order, the augmentations, dropout and GridMask.

Data and sequence parallel (JAX `tools/train.py:33-34`, :100-131,
:289-291): launched by `torchrun --nproc-per-node N`
(`bevformer_torch/tools/dist_train.sh`), each rank joins the process
group (`runtime.distributed.maybe_initialize`: NCCL on `cuda:LOCAL_RANK`,
gloo with `--device cpu` or `--dist-backend gloo`), and the N ranks form a
`(dp, sp)` mesh, dp x sp = N (`--dp` defaults to N // `--sp`, `--sp` to
1; rank = d x sp + s, as JAX's `make_mesh` lays the devices out). Each
`dp` index steps `samples_per_gpu` samples of its own (its share of the
`GroupShuffleSampler` order; V2: draws from generators of (`--seed`, step,
`dp` index), index 0's those of a one-process run), its `sp` ranks the same
ones with the encoder's BEV queries split between them
(`runtime.parallel`), and DDP averages the gradients: a step of the global
batch of dp x samples_per_gpu, an epoch len(dataset) // that many steps.
Rank 0 prints, writes `train_log.jsonl` and the checkpoints (which hold
every rank's random generators; `--resume-from` restores each rank's own);
the in-training evaluation runs each rank (of the world, whatever `--sp`)
over a contiguous segment of the val split and rank 0 scores the gathered
results, as `tools.test` does.

The run is on the card unless `--device cpu`; with no card it raises.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import queue
import threading
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from bevformer_torch.configs import apply_overrides, get_config
from bevformer_torch.core.evaluation import evaluate_detections
from bevformer_torch.data import (
    ContiguousVideoSampler,
    GroupShuffleSampler,
    NuScenesTemporalDataset,
    NuScenesTemporalDatasetV2,
)
from bevformer_torch.kernels import launch_counts, zero_counts
from bevformer_torch.runtime import (
    Trainer,
    VideoEvaluator,
    VideoEvaluatorV2,
    build_model,
    collate,
    collate_v2,
    distributed,
    init_state_dict,
    load_reference_pth,
    parallel,
    restore_checkpoint,
    save_checkpoint,
)
from bevformer_torch.runtime.eval import gather_results


def parse_args(argv):
    p = argparse.ArgumentParser(description="Train the PyTorch port of BEVFormer")
    p.add_argument("config", help="config name (e.g. bevformer_base)")
    p.add_argument("--data-root", required=True)
    p.add_argument("--work-dir", default=None)
    p.add_argument("--resume-from", default=None, help="a checkpoint of this CLI")
    p.add_argument("--load-from", default=None, help="weights of a reference-layout .pth")
    p.add_argument("--max-iters", type=int, default=None, help="cap on the steps")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-interval", type=int, default=50)
    p.add_argument("--ckpt-interval-epochs", type=int, default=1)
    p.add_argument("--eval-interval-epochs", type=int, default=0,
                   help="val NDS/mAP every N epochs (0: off), the reference's "
                   "CustomDistEvalHook")
    p.add_argument("--cfg-options", nargs="*", default=[], help="key=val config overrides")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    p.add_argument("--dp", type=int, default=None,
                   help="data-parallel size: the world size of the launch (the default)")
    p.add_argument("--sp", type=int, default=1,
                   help="sequence-parallel size: ranks that split each sample's BEV queries "
                   "in the encoder")
    p.add_argument("--dist-backend", default=None, choices=("nccl", "gloo"),
                   help="the process group's backend (default: nccl on the card, gloo on "
                   "the CPU; gloo for several ranks on one card)")
    return p.parse_args(argv)


def rng_digests(rng: dict) -> dict:
    """A short hash of each generator state of `Trainer.state_dict()["rng"]`."""
    return {k: hashlib.sha256(v.numpy().tobytes()).hexdigest()[:16] for k, v in sorted(rng.items())}


class BatchPrefetcher:
    """One thread builds the batches of steps [start_step, total_steps)
    with `fn(step)`, up to `depth` ahead of the trainer (the reference
    overlaps data loading through dataloader workers). On the card the
    thread issues its device work on a stream of its own; `get` makes the
    trainer's stream wait for it.

    `get()` returns (batch, host_ms, wait_ms): host_ms is the thread's wall
    time for the batch, wait_ms the time the trainer blocked for it (0
    when loading hides behind the step). It raises, rather than waiting
    for ever, once the thread has ended with nothing left to hand over."""

    def __init__(self, fn: Callable, start_step: int, total_steps: int, device: torch.device,
                 depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._device = device
        self._stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self._thread = threading.Thread(target=self._run, args=(fn, start_step, total_steps),
                                        daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run(self, fn, start_step, total_steps):
        on_stream = (torch.cuda.stream(self._stream) if self._stream is not None
                     else contextlib.nullcontext())
        try:
            with on_stream:
                for step in range(start_step, total_steps):
                    t0 = time.perf_counter()
                    batch = fn(step)
                    ready = None
                    if self._stream is not None:
                        ready = torch.cuda.Event()
                        ready.record(self._stream)
                    if not self._put((batch, ready, (time.perf_counter() - t0) * 1e3, None)):
                        return
        except Exception as e:  # handed to the trainer by get()
            self._put((None, None, 0.0, e))

    def get(self):
        t0 = time.perf_counter()
        while True:
            try:
                batch, ready, host_ms, err = self._q.get(timeout=1.0)
                break
            except queue.Empty:
                # the thread puts before it ends: an empty queue after its
                # end stays empty
                if not self._thread.is_alive() and self._q.empty():
                    raise RuntimeError("the batch thread ended without a batch for this step")
        if err is not None:
            raise err
        if ready is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(ready)
            # the thread's stream made these tensors: keep their memory
            # from reuse until this stream is done with them
            for t in batch.tensors():
                t.record_stream(stream)
        return batch, host_ms, (time.perf_counter() - t0) * 1e3

    def close(self):
        self._stop.set()
        self._thread.join(timeout=60)


def run_eval(model, cfg, data_root: str, work_dir: str, step: int, device) -> Optional[dict]:
    """NDS/mAP over the val split (the reference's CustomDistEvalHook; V2:
    JAX `_run_eval_v2` :394, sample by sample through `VideoEvaluatorV2`),
    each rank over its contiguous segment; rank 0 scores the gathered
    results and appends them to `eval_log.jsonl` (the other ranks return
    None). The model goes back to train mode."""
    val_pkl = os.path.join(data_root, "nuscenes_infos_temporal_val.pkl")
    if not os.path.exists(val_pkl):
        if distributed.rank() == 0:
            print("eval skipped: no val pkl", flush=True)
        return None
    v2 = cfg.version == "v2"
    ds = (NuScenesTemporalDatasetV2 if v2 else NuScenesTemporalDataset)(
        val_pkl, cfg, data_root=data_root, device=device)
    segment = ContiguousVideoSampler(len(ds), distributed.world_size(), distributed.rank())
    try:
        results = (VideoEvaluatorV2 if v2 else VideoEvaluator)(model).run(
            ds, indices=segment.indices(), progress_every=0)
    finally:
        model.train()
    results = gather_results(results, [ds.infos[i]["token"] for i in range(len(ds))])
    if distributed.rank() != 0:
        return None
    m = evaluate_detections(results, ds.gt_by_token(range(len(ds))), verbose=True)
    entry = dict(step=step, NDS=m["nd_score"], mAP=m["mean_ap"])
    print(json.dumps(entry), flush=True)
    with open(os.path.join(work_dir, "eval_log.jsonl"), "a") as f:
        f.write(json.dumps(entry) + "\n")
    return entry


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    # the process group before any other use of the card (the reference's
    # init_dist, `tools/train.py:168-175`)
    device = distributed.maybe_initialize(args.device, args.dist_backend)
    try:
        return train(args, device)
    finally:
        distributed.shutdown()


def train(args, device: torch.device) -> dict:
    dp = parallel.check_mesh(args.dp, args.sp)
    distributed.make_groups(dp, args.sp)
    d = distributed.dp_index()  # whose samples this rank holds
    lead = distributed.rank() == 0

    def say(msg: str) -> None:
        if lead:
            print(msg, flush=True)

    cfg = get_config(args.config)
    if args.cfg_options:
        cfg = apply_overrides(cfg, dict(kv.split("=", 1) for kv in args.cfg_options))
    work_dir = args.work_dir or os.path.join("work_dirs", args.config)
    if lead:
        os.makedirs(work_dir, exist_ok=True)
        with open(os.path.join(work_dir, "config.json"), "w") as f:
            json.dump({"config": args.config, "overrides": args.cfg_options}, f)

    v2 = cfg.version == "v2"
    ds = (NuScenesTemporalDatasetV2 if v2 else NuScenesTemporalDataset)(
        os.path.join(args.data_root, "nuscenes_infos_temporal_train.pkl"), cfg,
        data_root=args.data_root, seed=args.seed, device=device,
    )
    bs = cfg.optim.samples_per_gpu
    steps_per_epoch = max(1, len(ds) // (dp * bs))
    total_steps = steps_per_epoch * cfg.optim.total_epochs
    if args.max_iters:
        total_steps = min(total_steps, args.max_iters)
    say(f"mesh dp={dp} sp={args.sp}; dataset: {len(ds)} samples; batch {bs} on each of {dp} "
        f"dp rank(s) (global {dp * bs}); {steps_per_epoch} steps an epoch; {total_steps} steps; "
        f"device {device}")

    if args.load_from:
        state_dict = load_reference_pth(args.load_from)
        say(f"weights from {args.load_from}")
    else:
        state_dict = init_state_dict(cfg, seed=args.seed)
    trainer = Trainer(build_model(cfg, state_dict, device), total_steps, seed=args.seed)
    del state_dict
    start_step = 0
    if args.resume_from:
        start_step, _ = restore_checkpoint(args.resume_from, trainer)
        rng = rng_digests(trainer.state_dict()["rng"])  # on every rank: a collective
        say(json.dumps(dict(resumed_from=args.resume_from, step=start_step,
                            lr=trainer.scheduler.get_last_lr(), rng=rng)))

    # the epoch-seeded shuffle of the reference's DistributedGroupSampler
    # (`datasets/samplers/group_sampler.py:62-103`), this dp index's share
    sampler = GroupShuffleSampler(len(ds), num_replicas=dp, rank=d, seed=args.seed)
    order = {"epoch": -1, "indices": [], "pos": 0}

    def next_index(step: int) -> int:
        epoch = step // steps_per_epoch
        if epoch != order["epoch"]:
            sampler.set_epoch(epoch)
            # a resumed run picks the epoch up where its step is
            order.update(epoch=epoch, indices=sampler.indices(),
                         pos=(step - epoch * steps_per_epoch) * bs)
        if order["pos"] >= len(order["indices"]):
            order["pos"] = 0
        idx = order["indices"][order["pos"]]
        order["pos"] += 1
        return int(idx)

    def collect_batch(step: int):
        if v2:
            # the step's own generators (see the module's docstring)
            seeds = [args.seed, step] + ([d] if d else [])
            ds.rng = np.random.RandomState(seeds)
            draw = np.random.default_rng(seeds)
        samples, tries = [], 0
        while len(samples) < bs:
            # None: no GT (filter_empty_gt)
            s = (ds.get_train_sample_v2(int(draw.integers(len(ds)))) if v2
                 else ds.get_train_sample(next_index(step)))
            tries += 1
            if s is not None:
                samples.append(s)
            if tries > 10 * bs + 100:
                raise RuntimeError("the dataset yielded no sample with ground truth")
        if v2:
            return collate_v2(samples, device)
        return collate(samples, device)

    log_path = os.path.join(work_dir, "train_log.jsonl")
    ckpt_every = steps_per_epoch * args.ckpt_interval_epochs
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    zero_counts()  # the launches of this run's steps, also where a process runs several
    t_start = time.perf_counter()
    last = None
    prefetch = BatchPrefetcher(collect_batch, start_step, total_steps, device)
    try:
        for step in range(start_step, total_steps):
            batch, host_ms, wait_ms = prefetch.get()
            t0 = time.perf_counter()
            out = trainer.step(batch)  # its floats wait for the device
            step_ms = (time.perf_counter() - t0) * 1e3
            del batch
            last = dict(out, step=step, step_ms=step_ms, host_ms=host_ms, data_wait_ms=wait_ms,
                        time=time.perf_counter() - t_start)
            if lead and (step % args.log_interval == 0 or step == total_steps - 1):
                print(json.dumps(last), flush=True)
                with open(log_path, "a") as f:
                    f.write(json.dumps(last) + "\n")
            done = step + 1
            if done % ckpt_every == 0 or done == total_steps:
                path = os.path.join(work_dir, "ckpts", f"iter_{done}.pth")
                save_checkpoint(path, trainer, done, done // steps_per_epoch)
                say(f"saved checkpoint @ step {done}: {path}")
            eval_every = steps_per_epoch * args.eval_interval_epochs
            if eval_every and done % eval_every == 0:
                run_eval(trainer.model, cfg, args.data_root, work_dir, done, device)
    finally:
        prefetch.close()
    summary = dict(done=True, steps=total_steps - start_step, last=last, dp=dp, sp=args.sp,
                   launches=launch_counts(),
                   peak_gib=(torch.cuda.max_memory_allocated(device) / 2**30
                             if device.type == "cuda" else None))
    say(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
