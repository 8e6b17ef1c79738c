"""The program's own spans in the traced stretch.

`bevformer_torch` opens `bevformer::<name>` around its layers and phases
(`utils/profiler.py::span`) while a profiler records: `frame`, `sample` and
`step` a unit, `encoder` and `decoder` within them, and a step's phases
`history`, `forward`, `loss` (with `match` in it), `backward`, `clip`,
`optimizer` and `readback`. Each span's device time is that of the kernels,
copies and fills launched inside its interval on any thread (a backward's
come from the autograd engine's thread), and its idle time the part of its
interval in which the device ran nothing.

`install()` makes `trace.summarise` add these as `spans`, and name the idle
gaps with them beside the host operations and the `pb::` ranges; the
ranges, `busy_s` and every other field keep their rules. The readers of the
span metrics call it when they are loaded, before the traced stretch. A
program without spans leaves `spans` empty and the gaps named as before.
"""

from __future__ import annotations

import bisect
import collections
import functools
import itertools
import sys
from typing import Dict, List, Optional

from portbench import trace

PREFIX = "bevformer::"  # the program's `utils.profiler.SPAN_PREFIX`
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _is_span(e: dict) -> bool:
    return e.get("cat") == "user_annotation" and e["name"].startswith(PREFIX)


def _merged(intervals) -> List[List[float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def collect(events: List[dict]) -> Dict[str, Dict]:
    """For each span name over a chrome trace's events (microsecond times):
    `calls`, `host_ms` (the sum of its durations), `device_ms` and
    `launches` (the device work and the kernels launched inside it) and
    `idle_ms` (the device's idle time inside it)."""
    xs = [e for e in events if e.get("ph") == "X"]
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in xs
                 if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    device = [e for e in xs if e.get("cat") in trace.DEVICE_CATS]
    launched = sorted((launch_ts[c], float(e["dur"]), e["cat"] == "kernel") for e in device
                      if (c := e.get("args", {}).get("correlation")) in launch_ts)
    at = [t for t, _, _ in launched]
    dur_acc = list(itertools.accumulate((d for _, d, _ in launched), initial=0.0))
    kernel_acc = list(itertools.accumulate((k for _, _, k in launched), initial=0))
    busy = _merged((e["ts"], e["ts"] + e["dur"]) for e in device)
    busy_starts = [s for s, _ in busy]
    busy_ends = [e for _, e in busy]
    busy_acc = list(itertools.accumulate((e - s for s, e in busy), initial=0.0))

    def busy_within(t0: float, t1: float) -> float:
        i, j = bisect.bisect_right(busy_ends, t0), bisect.bisect_left(busy_starts, t1)
        if i >= j:
            return 0.0
        return (busy_acc[j] - busy_acc[i] - max(0.0, t0 - busy_starts[i])
                - max(0.0, busy_ends[j - 1] - t1))

    spans = collections.defaultdict(
        lambda: dict(calls=0, host_ms=0.0, device_ms=0.0, launches=0, idle_ms=0.0))
    for e in xs:
        if not _is_span(e):
            continue
        t0, t1 = e["ts"], e["ts"] + e["dur"]
        i, j = bisect.bisect_left(at, t0), bisect.bisect_right(at, t1)
        s = spans[e["name"][len(PREFIX):]]
        s["calls"] += 1
        s["host_ms"] += e["dur"] / 1e3
        s["device_ms"] += (dur_acc[j] - dur_acc[i]) / 1e3
        s["launches"] += kernel_acc[j] - kernel_acc[i]
        s["idle_ms"] += (e["dur"] - busy_within(t0, t1)) / 1e3
    return {k: dict(v) for k, v in spans.items()}


def idle_gaps(device: List[dict], host: List[dict], spans: List[dict],
              short_us: float = 20.0) -> List[list]:
    """`trace.idle_gaps` with the program's `spans` among the host entries:
    each gap summed by the innermost host operation, range or span running
    at its middle. Every span is looked at for every gap, since a unit's
    span opens thousands of operations before a gap in it."""
    merged = _merged((e["ts"], e["ts"] + e["dur"]) for e in device)
    host = sorted(host, key=lambda e: e["ts"])
    host_starts = [e["ts"] for e in host]
    sums = collections.Counter()
    for (_, g0), (g1, _) in zip(merged, merged[1:]):
        if g1 - g0 < short_us:
            sums[f"(gaps under {short_us:g} us)"] += (g1 - g0) / 1e6
            continue
        mid = 0.5 * (g0 + g1)
        i = bisect.bisect_right(host_starts, mid)
        running = [e for e in host[max(0, i - 500):i] if e["ts"] + e["dur"] >= mid]
        running += [e for e in spans if e["ts"] <= mid <= e["ts"] + e["dur"]]
        best: Optional[dict] = min(running, key=lambda e: e["dur"], default=None)
        sums["(no host op)" if best is None else best["name"]] += (g1 - g0) / 1e6
    return [[n, s] for n, s in sums.most_common(trace.TOP)]


def install() -> None:
    """Make `trace.summarise` add the program's spans to its summary and
    name the idle gaps with them; once in a process."""
    if hasattr(trace.summarise, "__wrapped__"):
        return
    base = trace.summarise

    @functools.wraps(base)
    def summarise(events: List[dict]) -> Dict:
        out = base(events)
        xs = [e for e in events if e.get("ph") == "X"]
        ops = [e for e in xs if e.get("cat") == "cpu_op"]
        ranges = [e for e in xs if e.get("cat") == "user_annotation"
                  and e["name"].startswith(trace.PREFIX)]
        device = [e for e in xs if e.get("cat") in trace.DEVICE_CATS]
        out["spans"] = collect(events)
        out["idle_gaps"] = idle_gaps(device, ops + ranges, [e for e in xs if _is_span(e)])
        if out["spans"]:
            print("portbench: traced spans (over the stretch): " + "; ".join(
                f"{k} calls {v['calls']} host {v['host_ms']:.3f} ms device {v['device_ms']:.3f} "
                f"ms launches {v['launches']} idle {v['idle_ms']:.3f} ms"
                for k, v in out["spans"].items()), file=sys.stderr, flush=True)
        return out

    trace.summarise = summarise


def per_unit(ctx, field: str, *names: str) -> Optional[float]:
    """`field` summed over the spans `names`, a traced unit; None where one
    of them never ran (a program without spans)."""
    spans = ctx.trace.get("spans", {}) if ctx.trace else {}
    if not all(spans.get(n, {}).get("calls") for n in names):
        return None
    return sum(spans[n][field] for n in names) / ctx.trace["units"]
