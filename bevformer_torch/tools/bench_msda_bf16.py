"""bf16 K1 and K3/K4 (`msda_fwd_bf16`, `msda_bwd_bf16`) at bevformer_base's
and bevformer_tiny_fp16's three call sites, against other builds of their
sources and against the fp32 entries, from the repository root on a card:

    python -m bevformer_torch.tools.bench_msda_bf16 [fwd bwd tiles passes]
        [--against DIR ...] [--variant NAME ...] [--shapes base tiny] [--reps N]

Shapes (`SHAPES`): base's TSA (B 2, Q 40,000, one 200 x 200 level, P 4),
SCA (B 6, Q 10,112, four levels, P 8) and decoder (B 1, Q 900, P 4);
tiny_fp16's TSA, dense SCA and decoder. Inputs as `chip_smoke.py` draws
them (numpy seed 0): value N(0, 1) rounded to bf16, locations uniform on
[-0.1, 1.1], softmaxed weights, grad_out N(0, 1) in bf16.

Cases:
  fwd     bf16 K1 at its tile (`msda.k1_bf16_tile`), fp32 K1 on the same
          value in fp32 (`msda.k1_tile`), and each other build's bf16 and
          fp32 K1 (a variant's at the same tiles, an `--against` build's at
          K1's tile, as the design before bf16 K1's own tile ran);
  bwd     the same for K3/K4, each through the wrapper's work: the fp32
          workspace's zero-fill, the kernel and the rounding pass;
  tiles   the package's bf16 K1 and K3/K4 at each tile from 8 that fits;
  passes  the zero-fill and the rounding pass alone.
An `--against` directory holds a `msda_fwd.cu`, `msda_fwd.cuh` and
`msda_bwd.cu`, built by one `nvcc` with the package's flags into
`build/against/`: the parent commit's files (`git archive`) time the
earlier design in the same process. A `--variant` is the package's sources
with the text edits of `VARIANTS` applied (each must match once), built the
same way: a design choice inside the kernel timed without a second path in
it. Each build's ptxas report (registers, spills) goes to stderr.

Kernels are timed in turns within one process: the package's entry, the
other builds, then the same in reverse; each turn `--reps` launches back
to back (CUDA events, as `chip_smoke.py` times them; the backward half as
many). One JSON line per shape, case and kernel: both turns' ms, the bound
(`tools/roofline.py`) and the share of it, the error against the plain
version (bf16: in ulps at max |plain| and the bitwise-equal share; dLoc and
dAttw: max abs error over max |plain|), the tile, the card's line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bevformer_torch.kernels import build, msda
from bevformer_torch.tools import common, roofline

TOOL = "bench_msda_bf16"
CASES = ("fwd", "bwd", "tiles", "passes")
SOURCES = ("msda_fwd.cu", "msda_bwd.cu")
HEADERS = ("msda_fwd.cuh",)

# name: [(file, text in it, its replacement), ...]
VARIANTS: Dict[str, List[Tuple[str, str, str]]] = {
    # K1's corner loads left to ptxas to order at every SPLIT (the package
    # pins them at SPLIT 1 and 2, where bf16 K1 runs)
    "nopin": [("msda_fwd.cuh", "  const bool pin = SPLIT <= 2;\n",
               "  const bool pin = false;\n")],
    # fp32 K1 as bf16 K1 runs (SPLIT 1, a tile of at least 32): whether the
    # gain is bf16's 64-byte rows' or the plan's alone
    "fp32_bf16_plan": [("msda_fwd.cu", "tile, split_for(L * P), stream);\n}\n\n// msda_fwd on",
                        "tile < 32 ? 32 : tile, 1, stream);\n}\n\n// msda_fwd on")],
}

S = common.Shape
SHAPES = {
    "base": (S("base_tsa", 2, 40000, 8, 32, common.TSA_LEVELS, 4),
             S("base_sca", 6, 10112, 8, 32, common.SCA_LEVELS, 8),
             S("base_decoder", 1, 900, 8, 32, common.TSA_LEVELS, 4)),
    "tiny": (S("tiny_tsa", 2, 2500, 8, 32, ((50, 50),), 4),
             S("tiny_sca", 6, 2500, 8, 32, ((15, 25),), 8),
             S("tiny_decoder", 1, 900, 8, 32, ((50, 50),), 4)),
}


def parser() -> argparse.ArgumentParser:
    ap = common.CaseParser("bf16 msda kernels against other builds and fp32", CASES)
    ap.add_argument("--against", action="append", default=[], metavar="DIR",
                    help="a directory of msda_fwd.cu, msda_fwd.cuh, msda_bwd.cu to time beside "
                         "the package's (repeatable)")
    ap.add_argument("--variant", action="append", default=[], choices=sorted(VARIANTS),
                    help="a variant of the package's sources to time beside it (repeatable)")
    ap.add_argument("--shapes", nargs="+", choices=list(SHAPES), default=list(SHAPES),
                    help="which shape sets (default both)")
    return ap


def _level_hw(shape) -> np.ndarray:
    return np.asarray(shape.levels, np.int32).reshape(-1)


class Build:
    """The msda entries of one library; `bf16_tile` whether its bf16 entries
    run at bf16 K1's tile (the package's sources) or at K1's (an earlier
    design's)."""

    def __init__(self, name: str, lib: ctypes.CDLL, bf16_tile: bool):
        self.name, self.lib, self.bf16_tile = name, lib, bf16_tile
        for entry in ("msda_fwd", "msda_fwd_bf16", "msda_bwd", "msda_bwd_bf16"):
            fn = getattr(lib, entry)
            fn.argtypes = build.SIGNATURES[entry]
            fn.restype = ctypes.c_int

    def tile(self, value, loc) -> int:
        if value.dtype == torch.bfloat16 and self.bf16_tile:
            return msda.k1_bf16_tile_for(value, loc)
        return msda.k1_tile_for(value, loc)

    def fwd(self, value, shape, loc, attw, tile: Optional[int] = None):
        """One forward launch for the value's dtype, at `tile` or its own."""
        b, k, h, d = value.shape
        out = torch.empty((b, shape.q, h * d), dtype=value.dtype, device=value.device)
        entry = "msda_fwd_bf16" if value.dtype == torch.bfloat16 else "msda_fwd"
        rc = getattr(self.lib, entry)(
            value.data_ptr(), loc.data_ptr(), attw.data_ptr(), out.data_ptr(),
            _level_hw(shape).ctypes.data, len(shape.levels), b, k, shape.q, h, d, shape.p,
            tile or self.tile(value, loc), torch.cuda.current_stream().cuda_stream)
        build.check_launch(entry, rc)
        return out

    def bwd(self, value, shape, loc, attw, g, tile: Optional[int] = None):
        """One backward for the value's dtype, at `tile` or its own, with the
        wrapper's work around the launch: the zeroed fp32 workspace and the
        rounding of a bf16 dValue."""
        b, k, h, d = value.shape
        dvalue = torch.zeros(value.shape, dtype=torch.float32, device=value.device)
        dloc, dattw = torch.empty_like(loc), torch.empty_like(attw)
        entry = "msda_bwd_bf16" if value.dtype == torch.bfloat16 else "msda_bwd"
        rc = getattr(self.lib, entry)(
            value.data_ptr(), loc.data_ptr(), attw.data_ptr(), g.data_ptr(), dvalue.data_ptr(),
            dloc.data_ptr(), dattw.data_ptr(), _level_hw(shape).ctypes.data, len(shape.levels),
            b, k, shape.q, h, d, shape.p, tile or self.tile(value, loc),
            torch.cuda.current_stream().cuda_stream)
        build.check_launch(entry, rc)
        return dvalue.to(value.dtype), dloc, dattw


def variant_dir(name: str) -> Path:
    """The package's sources with variant `name`'s edits, in a directory of
    their own under `build/`; raises unless each edit matches once."""
    out = build.BUILD_DIR / "msda_variants" / name
    out.mkdir(parents=True, exist_ok=True)
    texts = {f: (build.SRC_DIR / f).read_text() for f in SOURCES + HEADERS}
    for f, old, new in VARIANTS[name]:
        if texts[f].count(old) != 1:
            raise ValueError(f"variant {name}: an edit of {f} matches {texts[f].count(old)} "
                             f"times, not once:\n{old}")
        texts[f] = texts[f].replace(old, new)
    for f, text in texts.items():
        (out / f).write_text(text)
    return out


def build_dirs(dirs: Dict[str, Path]) -> List[Path]:
    """{name: directory of sources}, compiled at once: one library each."""
    out_dir = build.BUILD_DIR / "against"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, (name, src) in enumerate(dirs.items()):
        src = Path(src).resolve()
        missing = [f for f in SOURCES + HEADERS if not (src / f).exists()]
        if missing:
            raise FileNotFoundError(f"{src}: no {', '.join(missing)}")
        lib = out_dir / f"lib{i}.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-I", str(src), "-o", str(lib),
               *(str(src / f) for f in SOURCES)]
        procs.append((name, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                  stderr=subprocess.STDOUT, text=True)))
    libs = []
    for name, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        print(f"[{TOOL}] {name}:\n{log}", file=sys.stderr, flush=True)
        libs.append(lib)
    return libs


def inputs(shape: common.Shape, device):
    """value (bf16), loc, attw, grad_out (bf16), as chip_smoke.msda_inputs
    draws them, from numpy seed 0."""
    rng = np.random.RandomState(common.SEED)
    b, q, h, d, p, levels = shape.b, shape.q, shape.h, shape.d, shape.p, shape.levels
    value = rng.randn(b, shape.k, h, d).astype(np.float32)
    loc = (rng.rand(b, q, h, len(levels), p, 2) * 1.2 - 0.1).astype(np.float32)
    logits = rng.randn(b, q, h, len(levels) * p).astype(np.float32)
    attw = np.exp(logits - logits.max(-1, keepdims=True))
    attw = (attw / attw.sum(-1, keepdims=True)).reshape(b, q, h, len(levels), p)
    g = rng.randn(b, q, h * d).astype(np.float32)
    value, loc, attw, g = common.to_device([value, loc, attw.astype(np.float32), g], device)
    return value.bfloat16(), loc, attw, g.bfloat16()


def bf16_ulps(a: torch.Tensor, ref: torch.Tensor) -> float:
    """max |a - ref| in bf16 ulps at max |ref|."""
    scale = float(ref.float().abs().max())
    return float((a.float() - ref.float()).abs().max()) / 2.0 ** (np.floor(np.log2(scale)) - 7)


def rel_err(a: torch.Tensor, ref: torch.Tensor) -> float:
    return float((a - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)


def fwd_errors(out, ref) -> dict:
    return dict(ulps=bf16_ulps(out, ref), bitwise_equal_share=float((out == ref).float().mean()))


def bwd_errors(grads, ref) -> dict:
    return dict(dvalue_ulps=bf16_ulps(grads[0], ref[0]),
                dvalue_bitwise_equal_share=float((grads[0] == ref[0]).float().mean()),
                dloc=rel_err(grads[1], ref[1]), dattw=rel_err(grads[2], ref[2]))


def in_turns(fns: Dict[str, Callable], reps: int) -> Dict[str, List[float]]:
    """{name: [ms of the first turn, ms of the second]}: each `fns` entry
    timed over `reps` launches back to back, in order, then in reverse."""
    import chip_smoke as smoke  # the repository root is the working directory

    ms = {name: [] for name in fns}
    for name in list(fns) + list(fns)[::-1]:
        ms[name].append(smoke.time_ms(fns[name], reps))
    return ms


def emit(shape, case, kernel, ms, cost, **extra) -> dict:
    mean = sum(ms) / len(ms)
    rec = dict(tool=TOOL, shape=shape.name, case=case, kernel=kernel, ms=ms,
               bound_ms=cost.bound_ms, bound_by=cost.bound_by, share_of_bound=cost.bound_ms / mean,
               **extra, card=common.card_line())
    print(json.dumps(rec), flush=True)
    return rec


SMEM_LIMIT = 227 * 1024  # shared memory a block may use on sm_90


def tiles(samples: int, d: int):
    """K1's and K3/K4's tiles from 8 whose payload fits shared memory (32
    bytes a sample; K3/K4 also the tile's fp32 grad_out rows)."""
    fit = [t for t in msda.K1_TILES if t >= 8 and t * samples * 32 <= SMEM_LIMIT]
    return fit, [t for t in fit if t * (samples * 32 + d * 4) <= SMEM_LIMIT]


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    args = parser().parse_args(argv)
    device = common.require_cuda()
    others = {d: Path(d) for d in args.against}
    others.update((name, variant_dir(name)) for name in args.variant)
    package = Build("package", build.library(), True)
    builds = [package] + [Build(name, ctypes.CDLL(str(lib)), name in args.variant)
                          for name, lib in zip(others, build_dirs(others))]
    records = []
    for shape in [s for name in args.shapes for s in SHAPES[name]]:
        value, loc, attw, g = inputs(shape, device)
        value32, g32 = value.float(), g.float()
        dims = (shape.b, shape.q, shape.h, shape.d, shape.levels, shape.p)
        costs = dict(bf16=(roofline.msda_fwd(*dims, itemsize=2),
                           roofline.msda_bwd(*dims, itemsize=2)),
                     fp32=(roofline.msda_fwd(*dims), roofline.msda_bwd(*dims)))
        meta = dict(tile=msda.k1_bf16_tile_for(value, loc))
        fwd_tiles, bwd_tiles = tiles(len(shape.levels) * shape.p, shape.d)
        ref = msda.ms_deform_attn_plain(value, shape.levels, loc, attw)
        if "fwd" in args.cases:
            fns, errs = {}, {}
            for bld in builds:
                for v, tag in ((value, "bf16"), (value32, "fp32")):
                    name = f"{bld.name} {tag}"
                    fns[name] = lambda bld=bld, v=v: bld.fwd(v, shape, loc, attw)
                    out = fns[name]()
                    errs[name] = fwd_errors(out, ref) if tag == "bf16" else {}
            for name, ms in in_turns(fns, args.reps).items():
                records.append(emit(shape, "fwd", name, ms, costs[name[-4:]][0], **errs[name],
                                    **meta))
        if "tiles" in args.cases:
            fns = {f"tile {t}": (lambda t=t: package.fwd(value, shape, loc, attw, t))
                   for t in fwd_tiles}
            errs = {name: fwd_errors(fn(), ref) for name, fn in fns.items()}
            for name, ms in in_turns(fns, args.reps).items():
                records.append(emit(shape, "tiles fwd", name, ms, costs["bf16"][0], **errs[name],
                                    **meta))
        del ref
        torch.cuda.empty_cache()
        if {"bwd", "tiles"} & set(args.cases):
            bref = msda.ms_deform_attn_backward_plain(value, shape.levels, loc, attw, g)
        if "bwd" in args.cases:
            fns, errs = {}, {}
            for bld in builds:
                for v, gg, tag in ((value, g, "bf16"), (value32, g32, "fp32")):
                    name = f"{bld.name} {tag}"
                    fns[name] = lambda bld=bld, v=v, gg=gg: bld.bwd(v, shape, loc, attw, gg)
                    grads = fns[name]()
                    errs[name] = bwd_errors(grads, bref) if tag == "bf16" else {}
            for name, ms in in_turns(fns, max(args.reps // 2, 1)).items():
                records.append(emit(shape, "bwd", name, ms, costs[name[-4:]][1], **errs[name],
                                    **meta))
        if "tiles" in args.cases:
            fns = {f"tile {t}": (lambda t=t: package.bwd(value, shape, loc, attw, g, t))
                   for t in bwd_tiles}
            errs = {name: bwd_errors(fn(), bref) for name, fn in fns.items()}
            for name, ms in in_turns(fns, max(args.reps // 2, 1)).items():
                records.append(emit(shape, "tiles bwd", name, ms, costs["bf16"][1], **errs[name],
                                    **meta))
        if "passes" in args.cases:
            n = value.numel()
            work = torch.zeros(n, dtype=torch.float32, device=device)
            fns = {"zero-fill": lambda: torch.zeros(n, dtype=torch.float32, device=device),
                   "rounding": lambda: work.to(torch.bfloat16)}
            # the fill writes 4 bytes an element; the rounding reads 4, writes 2
            pcosts = {"zero-fill": roofline.Cost(bytes=4 * n, flops=0),
                      "rounding": roofline.Cost(bytes=6 * n, flops=0)}
            for name, ms in in_turns(fns, args.reps).items():
                records.append(emit(shape, "passes", name, ms, pcosts[name], elements=n))
            del work
        bref = None
        del value, value32, loc, attw, g, g32
        torch.cuda.empty_cache()
    return records


if __name__ == "__main__":
    main()
