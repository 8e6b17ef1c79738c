"""One run of one cell: set-up, the measured window, the traced stretch,
the check against the reference, and the result line.

Everything is found by name from files: the cell in `BENCHMARK.json`, its
configuration in `portbench/configs/<config>.json`, its traffic mix in
`portbench/traffic/<traffic>.json` (which names the driver in
`portbench/drivers/`), its check sizes and limits in
`portbench/workloads/<cell>.json`, and each metric's reader in
`portbench/metrics/<metric>.py` (or `<base>.py` for `<base>.<part>`).
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from portbench.reference.model import config as reference_config

ROOT = Path(__file__).resolve().parent.parent
PKG = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "bevformer_tpu")


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    config: Dict
    traffic_name: str
    traffic: Dict
    spec: Dict  # portbench/workloads/<cell>.json: the check's sizes and limits
    chips: int
    end_to_end: List[Dict]
    per_layer: List[Dict]


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json (cells: {sorted(cells)})")
    w = cells[name]
    return Cell(
        name=name, config_name=w["config"],
        config=_json(PKG / "configs" / f"{w['config']}.json"),
        traffic_name=w["traffic"], traffic=_json(PKG / "traffic" / f"{w['traffic']}.json"),
        spec=_json(PKG / "workloads" / f"{name}.json"), chips=w["chips"],
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def reader(metric: str):
    """The module `portbench/metrics/<metric>.py`, or where there is none
    `<base>.py` for a metric named `<base>.<part>` (one reader for the
    frame and the step cells' metric, which tells them apart by
    `ctx.unit`): `read(ctx)` and, for a traced metric, `RANGES`."""
    path = PKG / "metrics" / f"{metric}.py"
    if not path.exists():
        path = PKG / "metrics" / f"{metric.partition('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver_class(cell: Cell):
    return importlib.import_module(f"portbench.drivers.{cell.traffic['driver']}").Driver


@dataclasses.dataclass
class Context:
    """What a metric's reader reads."""

    cell: Cell
    cfg: object  # the configuration as attributes (`reference.model.config`)
    unit: str
    setup_s: float
    window_s: float
    units: int
    latencies_s: List[float]
    peak_bytes: int
    on_device: bool
    trace: Optional[Dict] = None


def forbidden_modules() -> List[str]:
    return sorted({m.partition(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        fault: Optional[str] = None, control: bool = False, log=print) -> Dict:
    """One run; returns the result line's fields and `checks` (each number
    compared, with its limit). `fault` plants one of the driver's faults in
    the timed path; `control` adds the numbers of the control (the
    reference in TF32 in the program's place) under `control`."""
    drv = driver_class(cell)(cell, seed, device, fault=fault)
    drv.setup()
    log("set-up phases (s): " + ", ".join(f"{k} {v:.3f}" for k, v in drv.setup_phases.items())
        + f"; before them {time.perf_counter() - t_start - sum(drv.setup_phases.values()):.3f}")
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    lat = []
    now = t0
    while now - t0 < seconds:
        t = time.perf_counter()
        drv.step()
        now = time.perf_counter()
        lat.append(now - t)
    window_s = now - t0
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    log(f"window: {len(lat)} {drv.unit}s in {window_s:.3f} s; set-up {setup_s:.3f} s")

    summary = None
    metrics_spec = cell.per_layer if trace else cell.end_to_end
    readers = {m["name"]: reader(m["name"]) for m in metrics_spec}
    if trace:
        from portbench import trace as tracing

        ranges = {}
        for mod in readers.values():
            ranges.update(getattr(mod, "RANGES", {}))
        hooks = tracing.Ranges(drv.model, ranges)
        try:
            summary = tracing.profile(drv.step, int(cell.traffic["trace_units"]), device)
        finally:
            hooks.close()
        per_unit = summary["window_s"] / summary["units"]
        log(f"traced stretch: {per_unit:.4f} s a {drv.unit} against the window's "
            f"{window_s / len(lat):.4f}; device busy {summary['busy_s'] / summary['units']:.4f} s "
            f"a {drv.unit}, the stretch's own idle {100 * (1 - summary['busy_s'] / summary['window_s']):.2f}%")
        log("traced ranges (device ms over the stretch): " + ", ".join(
            f"{k} fwd {v['fwd_ms']:.3f} bwd {v['bwd_ms']:.3f} calls {v['calls']}"
            for k, v in summary["ranges"].items()))
    ctx = Context(cell, reference_config(cell.config), drv.unit, setup_s, window_s, len(lat),
                  lat, peak, device.type == "cuda", summary)
    metrics = {}
    for m in metrics_spec:
        value = readers[m["name"]].read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    drv.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = drv.check()
    log(f"check: {time.perf_counter() - t_check:.3f} s; " + ", ".join(
        f"{k} {v:.3e}" for k, v in numbers.items()))
    limits = cell.spec["limits"]
    missing = sorted(set(limits) - set(numbers))
    if missing:
        raise KeyError(f"the check of {cell.name} gives no number {missing}")
    # a gap that is not finite (a label that differs) prints as the largest float
    checks = {k: {"value": v if math.isfinite(v) else sys.float_info.max, "limit": limits[k]}
              for k, v in numbers.items() if k in limits}
    correct = bool(checks) and all(c["value"] <= c["limit"] for c in checks.values())
    out = {"correct": correct, "attempted": len(lat), "failed": 0, "metrics": metrics,
           "device": device_info(device, cell.chips, peak)}
    if summary is not None:
        out["device"]["busy_s"] = summary["busy_s"]
        out["device"]["window_s"] = summary["window_s"]
        out["breakdown"] = {"device_ops": summary["device_ops"], "idle_gaps": summary["idle_gaps"]}
    if control:
        out["details"] = getattr(drv, "details", None)
        out["control"] = drv.check(control=True)
        out["control_details"] = getattr(drv, "details", None)
        log("control: " + ", ".join(f"{k} {v:.3e}" for k, v in out["control"].items()))
    out["checks"] = checks
    return out


def device_info(device, chips: int, peak: int) -> Dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
            "memory_peak_bytes": int(peak)}


def rel_gap(program: torch.Tensor, reference: torch.Tensor) -> float:
    """||program - reference|| / ||reference|| over every element, in
    float64."""
    p, r = program.double(), reference.double()
    return float(torch.linalg.vector_norm(p - r) / torch.linalg.vector_norm(r))


class Clock:
    """Seconds of each phase of set-up, the device synchronised."""

    def __init__(self, device):
        self.device = device
        self.laps = {}
        self.t = time.perf_counter()

    def lap(self, name: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.laps[name] = now - self.t
        self.t = now


class tf32_flags:
    """cuBLAS and cuDNN TF32 on or off inside the block."""

    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        self.saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.on
        torch.backends.cudnn.allow_tf32 = self.on

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved
