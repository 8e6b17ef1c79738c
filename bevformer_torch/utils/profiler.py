"""Lightweight profiling utilities.

Port of `bevformer_tpu/utils/profiler.py`. `run_time(name)` mirrors the
reference decorator (`models/utils/bricks.py:7-19`): it waits for the card
to finish the call's work (`torch.cuda.synchronize`, where an output tensor
lies on the card), then prints the call's time and the running mean per
name. `trace(log_dir)` records a `torch.profiler` trace of the block, the
card's activity included where there is a card (view it with TensorBoard or
Perfetto).
"""

from __future__ import annotations

import contextlib
import functools
import time
from collections import defaultdict

import torch

_TOTALS = defaultdict(float)
_COUNTS = defaultdict(int)


def _leaves(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _leaves(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _leaves(v)


def _sync(x):
    """Wait for the card's work behind `x` (tensors in nested lists, tuples
    and dicts); nothing to wait for on the CPU."""
    for dev in {t.device for t in _leaves(x) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)
    return x


def run_time(name: str):
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            out = _sync(fn(*args, **kwargs))
            dt = time.perf_counter() - t0
            _TOTALS[name] += dt
            _COUNTS[name] += 1
            print(f"{name}: {dt * 1e3:.2f} ms (mean {1e3 * _TOTALS[name] / _COUNTS[name]:.2f} "
                  f"over {_COUNTS[name]})")
            return out

        return wrapper

    return deco


@contextlib.contextmanager
def trace(log_dir: str = "work_dirs/trace"):
    """`torch.profiler` trace of the block, written to `log_dir` as a
    TensorBoard trace; yields the profiler (its `key_averages()` too)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
        yield prof
