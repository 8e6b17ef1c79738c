"""The traced stretch of a `--trace 1` run: ranges around the port's
layers, opened and closed by forward hooks on its module instances, a
`torch.profiler` trace of a few frames or steps, and what the per-layer
readers take from it.

A kernel belongs to a range when the host launched it inside the range's
interval on the range's thread. A range's backward is the kernels launched
inside the backward functions (`autograd::engine::evaluate_function: ...`)
whose sequence number is that of an operation the forward range recorded.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch

PREFIX = "pb::"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
BACKWARD = "autograd::engine::evaluate_function: "
TOP = 10


def select(model: torch.nn.Module, selectors: Sequence[str]) -> List[torch.nn.Module]:
    """The module instances named by `selectors`: `path:<dotted name>` or
    `class:<class name>`."""
    found = []
    named = dict(model.named_modules())
    for sel in selectors:
        kind, _, what = sel.partition(":")
        if kind == "path":
            if what in named:
                found.append(named[what])
        elif kind == "class":
            found += [m for m in named.values() if type(m).__name__ == what]
        else:
            raise ValueError(f"selector {sel!r}: path:<name> or class:<name>")
    return found


class Ranges:
    """Forward hooks that open `pb::<range>` around each selected module's
    calls; `close` removes them."""

    def __init__(self, model: torch.nn.Module, ranges: Dict[str, Sequence[str]]):
        self.handles = []
        for name, selectors in ranges.items():
            for mod in select(model, selectors):
                self.handles.append(mod.register_forward_pre_hook(self._opener(name)))
                self.handles.append(mod.register_forward_hook(self._closer()))
        self.open: List = []

    def _opener(self, name):
        def hook(module, args):
            rf = torch.profiler.record_function(PREFIX + name)
            rf.__enter__()
            self.open.append(rf)
        return hook

    def _closer(self):
        def hook(module, args, output):
            self.open.pop().__exit__(None, None, None)
        return hook

    def close(self):
        for h in self.handles:
            h.remove()


def profile(step: Callable[[], None], units: int, device) -> Dict:
    """Run `step` `units` times under the profiler (CPU and CUDA), and
    summarise the trace."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(units):
            step()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    out = summarise(events)
    out["window_s"] = window_s
    out["units"] = units
    return out


def _union(intervals):
    total, end = 0.0, -float("inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def summarise(events: List[dict]) -> Dict:
    """busy_s (the union of device activity), device ms of each range
    forward and backward, the top device operations and idle gaps, from a
    chrome trace's events (microsecond times)."""
    xs = [e for e in events if e.get("ph") == "X"]
    device = [e for e in xs if e.get("cat") in DEVICE_CATS]
    launch = {}
    for e in xs:
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {}):
            launch[e["args"]["correlation"]] = (e["tid"], e["ts"])
    # kernels by the (thread, time) of their launch
    by_thread = collections.defaultdict(list)
    for e in device:
        tid_ts = launch.get(e.get("args", {}).get("correlation"))
        if tid_ts is not None:
            by_thread[tid_ts[0]].append((tid_ts[1], float(e["dur"])))
    for v in by_thread.values():
        v.sort()
    starts = {t: [s for s, _ in v] for t, v in by_thread.items()}
    prefix = {}
    for t, v in by_thread.items():
        acc = [0.0]
        for _, d in v:
            acc.append(acc[-1] + d)
        prefix[t] = acc

    def launched_us(tid, t0, t1) -> float:
        if tid not in starts:
            return 0.0
        i, j = bisect.bisect_left(starts[tid], t0), bisect.bisect_right(starts[tid], t1)
        return prefix[tid][j] - prefix[tid][i]

    ops = [e for e in xs if e.get("cat") == "cpu_op"]
    ranges = collections.defaultdict(lambda: dict(fwd_ms=0.0, bwd_ms=0.0, calls=0))
    seqs = collections.defaultdict(set)
    annotations = [e for e in xs if e.get("cat") == "user_annotation"
                   and e["name"].startswith(PREFIX)]
    ops_by_tid = collections.defaultdict(list)
    for e in ops:
        ops_by_tid[e["tid"]].append(e)
    for v in ops_by_tid.values():
        v.sort(key=lambda e: e["ts"])
    op_starts = {t: [e["ts"] for e in v] for t, v in ops_by_tid.items()}
    for a in annotations:
        name = a["name"][len(PREFIX):]
        t0, t1 = a["ts"], a["ts"] + a["dur"]
        r = ranges[name]
        r["fwd_ms"] += launched_us(a["tid"], t0, t1) / 1e3
        r["calls"] += 1
        tid_ops = ops_by_tid.get(a["tid"], [])
        i = bisect.bisect_left(op_starts.get(a["tid"], []), t0)
        while i < len(tid_ops) and tid_ops[i]["ts"] <= t1:
            seq = tid_ops[i].get("args", {}).get("Sequence number")
            if seq is not None and not tid_ops[i]["name"].startswith(BACKWARD):
                seqs[name].add(seq)
            i += 1
    backward = [e for e in ops if e["name"].startswith(BACKWARD)]
    for name, s in seqs.items():
        for e in backward:
            if e.get("args", {}).get("Sequence number") in s:
                ranges[name]["bwd_ms"] += launched_us(e["tid"], e["ts"], e["ts"] + e["dur"]) / 1e3

    busy_us = _union([(e["ts"], e["ts"] + e["dur"]) for e in device])
    by_name = collections.Counter()
    for e in device:
        by_name[e["name"]] += e["dur"] / 1e6
    return dict(busy_s=busy_us / 1e6, ranges={k: dict(v) for k, v in ranges.items()},
                device_ops=[[n, s] for n, s in by_name.most_common(TOP)],
                idle_gaps=idle_gaps(device, ops + annotations))


def idle_gaps(device: List[dict], host: List[dict], short_us: float = 20.0) -> List[list]:
    """The device's idle gaps, summed by the innermost host operation or
    range running at each gap's middle, the longest first; gaps under
    `short_us` are summed as one entry."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in device)
    gaps, end = [], None
    for s, e in spans:
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    host = sorted(host, key=lambda e: e["ts"])
    host_starts = [e["ts"] for e in host]
    sums = collections.Counter()
    for g0, g1 in gaps:
        if g1 - g0 < short_us:
            sums[f"(gaps under {short_us:g} us)"] += (g1 - g0) / 1e6
            continue
        mid = 0.5 * (g0 + g1)
        best = None
        i = bisect.bisect_right(host_starts, mid)
        for e in host[max(0, i - 500):i]:
            if e["ts"] + e["dur"] >= mid and (best is None or e["dur"] < best["dur"]):
                best = e
        sums["(no host op)" if best is None else best["name"]] += (g1 - g0) / 1e6
    return [[n, s] for n, s in sums.most_common(TOP)]


def layer_device_ms(summary: Optional[Dict], name: str, backward: bool = True) -> Optional[float]:
    """Device ms of a range over the traced stretch, forward and (with
    `backward`) backward; None where the range never ran."""
    if summary is None:
        return None
    r = summary["ranges"].get(name)
    if not r or r["calls"] == 0:
        return None
    return r["fwd_ms"] + (r["bwd_ms"] if backward else 0.0)
