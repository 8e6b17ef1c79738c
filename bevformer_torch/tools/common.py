"""What the port's kernel benchmark and probe tools and its model measuring
tools share: their shapes, the seeded inputs, CUDA-event timing, the card's
line and the JSON records.

The default shape is bevformer_base's spatial cross-attention (SCA) as the
JAX tools time it: B = 6 cameras, H = 8 heads, D = 32, P = 8 points, the
four FPN levels (116, 200), (58, 100), (29, 50), (15, 25) (K = 30825) and
Q = 16000 routed queries per camera (`--q 10112` is capacity 0.25).
`--tsa` switches to temporal self-attention's: B = 2, Q = 40000, one
200 x 200 level, P = 4. Inputs are made with numpy from seed 0, as the JAX
tools make theirs, then moved to the card. Nothing here allocates on import,
and nothing falls back to the CPU: a tool without a card raises.

The model measuring tools (`benchmark`, `bench_*` of whole modules,
`audit_sca_capacity`) share `example_inputs` (the JAX package's seeded
frame), `seeded_model`, `time_calls` (CUDA events around each call after a
warm-up: the median and the spread) and `json_line`, the one JSON record a
run prints. Their inner functions take a device, so that they run on the
CPU too (timed there on the host clock).
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bevformer_torch.kernels import gather, launch_counts, msda, zero_counts
from bevformer_torch.tools import roofline

SCA_LEVELS = ((116, 200), (58, 100), (29, 50), (15, 25))
TSA_LEVELS = ((200, 200),)
JITTER_ROWS = 3.0  # y-coherent inputs: +-3 image rows of every level
OUTSIDE = 1.0 / 18  # incoherent inputs: uniform on [-1/18, 1 + 1/18], 10% outside [0, 1]
L2_FLUSH_BYTES = 128 << 20  # more than the card's 50 MB L2
# a device spin enqueued ahead of the timed launches, per launch: ~0.2 ms at
# the H100's 1.98 GHz, longer than the host takes to enqueue one
SPIN_CYCLES_PER_REP = 400_000
SEED = 0
PLAIN_REPS = 3  # timed launches of a plain version


@dataclass(frozen=True)
class Shape:
    name: str
    b: int
    q: int
    h: int
    d: int
    levels: Tuple[Tuple[int, int], ...]
    p: int

    @property
    def k(self) -> int:
        return sum(hh * ww for hh, ww in self.levels)

    def describe(self) -> str:
        return (f"{self.name}: B {self.b}, Q {self.q}, H {self.h}, D {self.d}, "
                f"levels {list(self.levels)}, P {self.p}")


def sca_shape(q: int = 16000, levels=SCA_LEVELS) -> Shape:
    return Shape("sca" if levels == SCA_LEVELS else "sca_level0", 6, q, 8, 32, tuple(levels), 8)


def tsa_shape(q: int = 40000) -> Shape:
    return Shape("tsa", 2, q, 8, 32, TSA_LEVELS, 4)


class CaseParser(argparse.ArgumentParser):
    """Positional case names (all of them when none is given) and `--reps`."""

    def __init__(self, description: str, cases: Sequence[str], reps: int = 20):
        super().__init__(description=description)
        self.cases = list(cases)
        self.add_argument("cases", nargs="*", choices=self.cases, metavar="case",
                          help=f"cases to run (default all): {', '.join(self.cases)}")
        self.add_argument("--reps", type=int, default=reps, help="timed launches per case")

    def parse_args(self, argv=None, namespace=None):
        args = super().parse_args(argv, namespace)
        args.cases = args.cases or self.cases
        return args


def parser(description: str, cases: Sequence[str]) -> CaseParser:
    """A `CaseParser` with the msda shape options `--q` and `--tsa`."""
    ap = CaseParser(description, cases)
    ap.add_argument("--q", type=int, default=None,
                    help="queries per camera (default 16000 for SCA, 40000 for TSA)")
    ap.add_argument("--tsa", action="store_true", help="temporal self-attention's shape")
    return ap


def shape_of(args) -> Shape:
    if args.tsa:
        return tsa_shape() if args.q is None else tsa_shape(args.q)
    return sca_shape() if args.q is None else sca_shape(args.q)


@functools.lru_cache(maxsize=2)
def coherent_inputs(shape: Shape):
    """value [B, K, H, D] N(0, 1), loc [B, Q, H, L, P, 2], attw [B, Q, H, L,
    P] uniform [0, 1), fp32 numpy, drawn as `tools/bench_msda_kernel.py`
    draws them: y grows with the query index, each sample within +-3 image
    rows of it at every level (the order SCA's anchor sort produces); x is
    uniform on [0, 1)."""
    b, q, h, d, p, levels = shape.b, shape.q, shape.h, shape.d, shape.p, shape.levels
    rng = np.random.RandomState(SEED)
    value = rng.randn(b, shape.k, h, d).astype(np.float32)
    base = (np.arange(q) + 0.5) / q
    y = np.empty((b, q, h, len(levels), p), np.float32)
    for lvl, (hh, _) in enumerate(levels):
        jit = rng.uniform(-JITTER_ROWS, JITTER_ROWS, size=(b, q, h, p))
        y[:, :, :, lvl, :] = base[None, :, None, None] + jit / hh
    x = rng.rand(b, q, h, len(levels), p).astype(np.float32)
    loc = np.stack([x, y], -1)
    attw = rng.rand(b, q, h, len(levels), p).astype(np.float32)
    return value, loc, attw


def incoherent_locations(shape: Shape) -> np.ndarray:
    """loc [B, Q, H, L, P, 2] uniform on [-1/18, 1 + 1/18]: no order, and 10%
    of the coordinates outside [0, 1]."""
    rng = np.random.RandomState(SEED + 1)
    size = (shape.b, shape.q, shape.h, len(shape.levels), shape.p, 2)
    return rng.uniform(-OUTSIDE, 1 + OUTSIDE, size).astype(np.float32)


def to_device(arrays, device) -> List[torch.Tensor]:
    return [torch.from_numpy(a).to(device) for a in arrays]


def require_cuda() -> torch.device:
    """The card. A timing never falls back to the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("the kernel tools time CUDA kernels and need a CUDA device")
    return torch.device("cuda", 0)


@functools.lru_cache(maxsize=None)
def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` of the card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


@functools.lru_cache(maxsize=None)
def _flush_buffer(device) -> torch.Tensor:
    return torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=device)


def time_ms(fn: Callable[[], torch.Tensor], reps: int):
    """(mean ms per launch, the first launch's output). The first launch is
    the warm-up and its output is the one compared with the plain version;
    then `reps` launches, each between its own pair of CUDA events, each
    after a write of 128 MB that evicts the L2 (the model's callers find the
    value map cold: it is larger than the L2). A device spin enqueued before
    them keeps the host ahead of the card, so no event pair times the host's
    wrapper."""
    out = fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    torch.cuda._sleep(SPIN_CYCLES_PER_REP * reps)
    for start, end in events:
        _flush_buffer(out.device).zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / max(reps, 1), out


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def record(tool: str, case: str, cost: Optional[roofline.Cost], ms: float, **extra) -> dict:
    """One measured case, printed as a JSON line and returned."""
    rec = dict(tool=tool, case=case, ms=ms)
    if cost is not None:
        rec.update(cost.as_dict(), share_of_bound=cost.bound_ms / ms if ms > 0 else None,
                   GB_per_s=cost.bytes / ms / 1e6 if ms > 0 else None)
    rec.update(extra, card=card_line(), peaks=roofline.PEAKS)
    print(json.dumps(rec), flush=True)
    return rec


def launch_counters() -> dict:
    """The launch count of every kernel wrapper the tools call."""
    return dict(msda_fwd=msda.ms_deform_attn, msda_fwd_bf16=msda.MSDA_FWD_BF16,
                msda_bwd_bf16=msda.MSDA_BWD_BF16, msda_fwd_ho=msda.ms_deform_attn_ho,
                msda_probe=msda.msda_probe, row_gather=gather.row_gather)


def measure(tool: str, case: str, fn: Callable[[], torch.Tensor], ref: torch.Tensor,
            cost: Optional[roofline.Cost], reps: int, plain: Optional[Callable] = None,
            exact: bool = False, **extra) -> dict:
    """Time `fn` (`reps` launches after a warm-up), hold its first output
    against `ref` (max abs error, `scale` = max |ref|, and with `exact`
    whether the two are bitwise equal), count the kernel launches it made,
    time `plain` too where given (`PLAIN_REPS` launches), and record the
    case."""
    counters = launch_counters()
    before = {k: f.launches for k, f in counters.items()}
    ms, out = time_ms(fn, reps)
    launches = sum(f.launches - before[k] for k, f in counters.items())
    if exact:
        extra["bitwise_equal"] = bool(torch.equal(out, ref))
    if plain is not None:
        extra["plain_ms"] = time_ms(plain, PLAIN_REPS)[0]
    return record(tool, case, cost, ms, max_abs_err=max_abs_err(out, ref),
                  scale=float(ref.abs().max()), launches=launches, **extra)


# ------------------------------------------------ the model measuring tools

EXAMPLE_FOCAL = 1000.0  # px: the example rig's focal length (`__graft_entry__.py:29`)


def example_inputs(cfg, bs: int, device):
    """The JAX package's seeded example frame (`__graft_entry__.py::
    _example_inputs`), drawn in the same order from numpy seed 0: images
    [bs, cams, H, W, 3] N(0, 1) x 0.1 at `cfg.data.img_size`, can_bus
    [bs, 18] N(0, 1) x 0.1, lidar2img [bs, cams, 4, 4] of one camera of
    focal length 1000 px at the image centre looking along the lidar's +x
    (every camera the same), prev_bev [bs, bev_h * bev_w, e] zeros and
    has_prev [bs] false; float32 (has_prev bool), on `device`."""
    h, w = cfg.data.img_size
    rng = np.random.RandomState(SEED)
    images = rng.randn(bs, cfg.data.num_cams, h, w, 3).astype(np.float32) * 0.1
    can_bus = rng.randn(bs, 18).astype(np.float32) * 0.1
    return (torch.from_numpy(images).to(device), torch.from_numpy(can_bus).to(device),
            example_lidar2img(cfg, bs, device),
            torch.zeros((bs, cfg.bev_h * cfg.bev_w, cfg.embed_dims), device=device),
            torch.zeros((bs,), dtype=torch.bool, device=device))


def example_lidar2img(cfg, bs: int, device) -> torch.Tensor:
    """The example frame's lidar2img [bs, cams, 4, 4] (`example_inputs`)."""
    h, w = cfg.data.img_size
    f = EXAMPLE_FOCAL
    intr = np.array([[f, 0, w / 2, 0], [0, f, h / 2, 0], [0, 0, 1, 0], [0, 0, 0, 1]])
    extr = np.array([[0, -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0], [0, 0, 0, 1.0]])
    l2i = np.tile((intr @ extr)[None, None], (bs, cfg.data.num_cams, 1, 1)).astype(np.float32)
    return torch.from_numpy(l2i).to(device)


def tool_config(name: str, options: Sequence[str] = (), dtype: Optional[str] = None, **fields):
    """`get_config(name)` with `--cfg-options key=val` strings applied, then
    `dtype` (None: the config's own) and `fields`."""
    from bevformer_torch.configs import apply_overrides, get_config

    cfg = get_config(name)
    if options:
        cfg = apply_overrides(cfg, dict(kv.split("=", 1) for kv in options))
    if dtype:
        fields["dtype"] = dtype
    return cfg.replace(**fields) if fields else cfg


_WEIGHTS: Dict[str, dict] = {}
KEPT_WEIGHTS = 2  # configs whose seeded weights a process keeps, the oldest dropped first


def seeded_model(cfg, device, seed: int = 0):
    """`build_model(cfg, init_state_dict(cfg, seed), device)`, in eval mode.
    The seeded weights are kept for the process, by everything of the
    config but its dtype, `use_remat` and `use_grid_mask` (which change no
    weight), for the last `KEPT_WEIGHTS` configs: a tool that builds one
    model several ways draws them once."""
    from bevformer_torch.runtime import build_model, init_state_dict

    key = repr((cfg.replace(dtype="float32", use_remat=False, use_grid_mask=False), seed))
    if key not in _WEIGHTS:
        while len(_WEIGHTS) >= KEPT_WEIGHTS:
            del _WEIGHTS[next(iter(_WEIGHTS))]
        _WEIGHTS[key] = init_state_dict(cfg, seed=seed)
    return build_model(cfg, _WEIGHTS[key], device)


def train_model(cfg, device, seed: int = 0):
    """`seeded_model` made ready to train (`frozen_as_trainer`)."""
    return frozen_as_trainer(seeded_model(cfg, device), seed)


def frozen_as_trainer(model, seed: int = 0):
    """`model` in train mode, its frozen stages frozen as `Trainer` freezes
    them (`runtime.optim.label_params`; no gradient is computed below
    them), dropout and GridMask drawing from `seed`."""
    from bevformer_torch.runtime.optim import FROZEN, label_params

    model.train()
    labels = label_params(model, model.cfg.optim.frozen_stages)
    for name, p in model.named_parameters():
        p.requires_grad_(labels[name] != FROZEN)
    torch.manual_seed(seed)
    model.grid_mask.generator.manual_seed(seed)
    return model


def grad_step(model, loss: Callable[[], torch.Tensor]) -> Callable[[], torch.Tensor]:
    """A call that zeroes `model`'s gradients, evaluates `loss()` and runs
    its backward; it returns the loss, detached."""
    def call():
        model.zero_grad(set_to_none=True)
        value = loss()
        value.backward()
        return value.detach()
    return call


def where(device) -> str:
    """What a metric's name says it ran on: one GPU, or the CPU."""
    return "1 GPU" if torch.device(device).type == "cuda" else "CPU"


@dataclass
class Timing:
    """The times of the timed calls (ms, in order), the clock that took
    them, the kernel launches per timed call (the counters that moved) and
    the TF32 flags in force where the calls ran."""

    ms: List[float]
    clock: str
    launches: Dict[str, float] = field(default_factory=dict)
    tf32: Dict[str, bool] = field(default_factory=dict)

    @property
    def median(self) -> float:
        return float(np.median(self.ms))

    def fields(self) -> dict:
        """The record's fields: median, min and max ms (the spread), each
        call's ms, the clock, launches per call."""
        return dict(ms_median=self.median, ms_min=min(self.ms), ms_max=max(self.ms), ms=self.ms,
                    launches_per_call=self.launches, clock=self.clock)


def tf32_flags() -> Dict[str, bool]:
    return dict(matmul=torch.backends.cuda.matmul.allow_tf32,
                cudnn=torch.backends.cudnn.allow_tf32)


def time_calls(fn: Callable[[], object], reps: int, device, warmup: int = 1) -> Timing:
    """Each of `reps` calls of `fn` after `warmup` untimed ones: on the card
    between a pair of CUDA events, the device idle before each (a frame or
    step's latency: the host's launches and syncs inside it count, no
    earlier work does; a whole frame needs no L2 flush); on the CPU on the
    host clock. The kernel launches are counted over the timed calls."""
    for _ in range(warmup):
        fn()
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    zero_counts()
    flags = tf32_flags()
    ms = []
    for _ in range(reps):
        if cuda:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize(device)
            ms.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            ms.append((time.perf_counter() - t0) * 1e3)
    launches = {k: n / max(reps, 1) for k, n in launch_counts().items() if n}
    return Timing(ms=ms, clock="cuda_events" if cuda else "host", launches=launches, tf32=flags)


def peak_gib(device) -> Optional[float]:
    if torch.device(device).type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2**30


def reset_peak(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def json_line(metric: str, value: float, unit: str, vs_baseline: Optional[float], *,
              device, dtype: str, timing: Optional[Timing] = None, **extra) -> dict:
    """The one JSON record of a measuring tool's run, printed and returned:
    `metric`, `value`, `unit` and `vs_baseline` in `bench.py`'s shape, then
    `extra`, `timing`'s fields, the config's dtype and the TF32 flags in
    force where the timed calls ran, the peak device memory
    (`torch.cuda.max_memory_allocated`, GiB), the kernel launches (per timed
    call where a timing is given; else the counts since the tool zeroed
    them) and the card's `nvidia-smi` name and power limit."""
    rec = dict(metric=metric, value=value, unit=unit, vs_baseline=vs_baseline, **extra)
    if timing is not None:
        rec.update(timing.fields())
    launches = timing.launches if timing is not None else {
        k: n for k, n in launch_counts().items() if n}
    rec.update(dtype=dtype, tf32=timing.tf32 if timing is not None else tf32_flags(),
               peak_gib=peak_gib(device), launches=launches,
               card=card_line() if torch.device(device).type == "cuda" else "cpu")
    print(json.dumps(rec), flush=True)
    return rec


def bench_parser(description: str, config: Optional[str]) -> argparse.ArgumentParser:
    """A model measuring tool's options: the config (positional; optional
    where `config` gives a default), `--dtype` (default the config's own)
    and `--cfg-options`."""
    ap = argparse.ArgumentParser(description=description)
    if config is None:
        ap.add_argument("config")
    else:
        ap.add_argument("config", nargs="?", default=config)
    ap.add_argument("--dtype", default=None, choices=("float32", "bfloat16"),
                    help="default: the config's own")
    ap.add_argument("--cfg-options", nargs="*", default=[])
    return ap
