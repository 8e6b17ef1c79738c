"""What the port's kernel benchmark and probe tools share: their shapes, the
seeded inputs, CUDA-event timing, the card's line and the JSON records.

The default shape is bevformer_base's spatial cross-attention (SCA) as the
JAX tools time it: B = 6 cameras, H = 8 heads, D = 32, P = 8 points, the
four FPN levels (116, 200), (58, 100), (29, 50), (15, 25) (K = 30825) and
Q = 16000 routed queries per camera (`--q 10112` is capacity 0.25).
`--tsa` switches to temporal self-attention's: B = 2, Q = 40000, one
200 x 200 level, P = 4. Inputs are made with numpy from seed 0, as the JAX
tools make theirs, then moved to the card. Nothing here allocates on import,
and nothing falls back to the CPU: a tool without a card raises.
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bevformer_torch.kernels import gather, msda
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
    return dict(msda_fwd=msda.ms_deform_attn, msda_fwd_ho=msda.ms_deform_attn_ho,
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
