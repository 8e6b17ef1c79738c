"""bf16 K6 (`dcn_col2im_gw`: the sampling half of the bf16 DCN backward,
from the bf16 output gradient and the weight) against the route an earlier
build ran (the fp32 product g W_bf16^T, then its `dcn_col2im_bf16` on that
column gradient) and against fp32 K6, from the repository root on a card:

    python -m bevformer_torch.tools.bench_dcn_bwd_bf16 [stages step]
        [--against DIR] [--variant NAME ...] [--reps N]

Cases:
  stages  bevformer_base's and bevformer_small's DCN stages
          (`chip_smoke.BF16_DCN_CASES`), inputs drawn from numpy seed 0 as
          `chip_smoke.py` draws them: x and g N(0, 1) in bf16, offsets
          N(0, 3) px, mask U(0, 1), weight N(0, 1 / 9C);
  step    the K6 calls of one bf16 bevformer_base training step (seeded
          weights and batch, its first step), recorded
          (`chip_smoke.recorded_col2im`), one line per shape with its calls
          summed and their offsets' rms.

Kernels, timed in turns within one process (each turn `--reps` launches
back to back, CUDA events as `chip_smoke.py` times them, the step's calls
a quarter as many; then the same in reverse):
  gw        the package's `dcn_col2im_gw` with its weight prep, the zeroed
            fp32 dx workspace and its rounding (the wrapper's work);
  pair      an `--against` build's route: the fp32 product g W_bf16^T
            (TF32 off), then its `dcn_col2im_bf16` with the zeroed fp32 dx
            workspace and the rounding;
  product   that fp32 product alone;
  fp32      fp32 K6 (`dcn_col2im`) on the same inputs in fp32 (x widened,
            the column gradient the fp32 product), the package's and the
            `--against` build's;
  NAME      a `--variant`: the package's `csrc/dcn_col2im.cu` with the text
            edits of `VARIANTS` (each must match once), its `dcn_col2im_gw`:
            a design choice inside the kernel timed without a second path
            in it.
An `--against` directory holds a `dcn_col2im.cu` and `dcn_vec4.cuh` with
the entries `dcn_col2im` and `dcn_col2im_bf16` (dcols in): the parent
commit's (`git archive`). Each other build is compiled by one `nvcc` with
the package's flags into `build/against/`, all at once; its ptxas report
goes to stderr. One JSON line per case, shape and kernel: both turns' ms,
the bound (`tools/roofline.py`; the product's on the fp32 SIMT units) and
the share of it, the error against the plain version (dx in bf16 ulps at
max |plain|, d offsets and dmask max abs error over max |plain|), the dx
add bytes through global atomics, the card's line.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from bevformer_torch.kernels import build, dcn
from bevformer_torch.tools import common, roofline
from bevformer_torch.tools.bench_msda_bf16 import bf16_ulps, in_turns, rel_err

TOOL = "bench_dcn_bwd_bf16"
CASES = ("stages", "step")
SOURCE = "dcn_col2im.cu"
AGAINST_FILES = ("dcn_col2im.cu", "dcn_vec4.cuh")
# the C signature of the earlier build's entries: x, off_y, off_x, mask,
# dcols, dx (zeroed), doff_y, doff_x, dmask, B, H, W, C, OH, OW, stride,
# stream
AGAINST_SIGNATURE = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p]

# name: [(text in csrc/dcn_col2im.cu, its replacement), ...]
VARIANTS: Dict[str, List[tuple]] = {
    # the scatter warps' corner loads one row ahead, or four, not two
    "pf1": [("constexpr int PF = 2;\n", "constexpr int PF = 1;\n")],
    "pf4": [("constexpr int PF = 2;\n", "constexpr int PF = 4;\n")],
    # each block walks a contiguous range of units, not every G-th one
    "ranges": [("  const Units units{(int)blockIdx.x, G, (U - (int)blockIdx.x + G - 1) / G};\n",
                "  const int ub = (int)((int64_t)blockIdx.x * U / G);\n"
                "  const Units units{ub, 1, (int)((int64_t)(blockIdx.x + 1) * U / G) - ub};\n")],
    # diagnostics (their outputs are wrong): the scatter alone, the MMA
    # warpgroup handing over staging tiles it never fills; and the product
    # and the hand-over alone, the scatter warps summing no row
    "nomma": [("  for (int i = 0; i < STAGES - 1; ++i) issue(i);\n",
               "  for (; part < units.count * NB; ++part) {\n"
               "    mbar_wait(&s.stg_empty[part & 1], ((part >> 1) & 1) ^ 1);\n"
               "    mbar_arrive(&s.stg_full[part & 1]);\n"
               "  }\n"
               "  if (part >= 0) return;\n"
               "  for (int i = 0; i < STAGES - 1; ++i) issue(i);\n")],
    "noscatter": [("    const int n = lim > 0 ? min(WARP_ROWS, (lim + S_WARPS - 1) / S_WARPS)"
                   " : 0;\n", "    const int n = 0;\n")],
}


def parser():
    ap = common.CaseParser("bf16 K6 from the output gradient against the earlier route", CASES)
    ap.add_argument("--against", default=None, metavar="DIR",
                    help="a directory of dcn_col2im.cu and dcn_vec4.cuh with the entry "
                         "dcn_col2im_bf16 (the earlier route's K6)")
    ap.add_argument("--variant", action="append", default=[], choices=sorted(VARIANTS),
                    help="a variant of the package's K6 source to time beside it (repeatable)")
    return ap


def variant_source(name: str, text: str) -> str:
    """`text` with variant `name`'s edits applied; raises unless each edit
    matches exactly once."""
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise ValueError(f"variant {name}: an edit matches {text.count(old)} times, not once:"
                             f"\n{old}")
        text = text.replace(old, new)
    return text


def build_libs(against: Optional[str], variants: Sequence[str]) -> Dict[str, ctypes.CDLL]:
    """{name: library}: the `--against` build ("against") and each variant,
    compiled at once."""
    out_dir = build.BUILD_DIR / "against"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = []
    if against is not None:
        src = Path(against).resolve()
        missing = [f for f in AGAINST_FILES if not (src / f).exists()]
        if missing:
            raise FileNotFoundError(f"{src}: no {', '.join(missing)}")
        jobs.append(("against", src / SOURCE, src))
    for name in variants:
        path = out_dir / f"{name}.cu"
        path.write_text(variant_source(name, (build.SRC_DIR / SOURCE).read_text()))
        jobs.append((name, path, build.SRC_DIR))
    procs = []
    for name, path, include in jobs:
        lib = out_dir / f"k6_{name}.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-I", str(include), "-o", str(lib),
               str(path)]
        procs.append((name, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                  stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        print(f"[{TOOL}] {name}:\n{log}", file=sys.stderr, flush=True)
        libs[name] = ctypes.CDLL(str(lib))
        entries = (("dcn_col2im", "dcn_col2im_bf16") if name == "against"
                   else ("dcn_col2im_gw",))
        for entry in entries:
            fn = getattr(libs[name], entry)
            fn.argtypes = AGAINST_SIGNATURE if name == "against" else build.SIGNATURES[entry]
            fn.restype = ctypes.c_int
    return libs


def against_col2im(lib, entry, x, off_y, off_x, mask, dcols, stride):
    """The earlier build's K6 (`entry`: dcn_col2im, or dcn_col2im_bf16 on a
    bf16 x) on an fp32 column gradient, with its wrapper's zeroed fp32 dx
    and the rounding."""
    b, h, w, c = x.shape
    oh, ow = off_y.shape[1], off_y.shape[2]
    dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    doff_y, doff_x, dmask = (torch.empty_like(off_y) for _ in range(3))
    rc = getattr(lib, entry)(x.data_ptr(), off_y.data_ptr(), off_x.data_ptr(), mask.data_ptr(),
                             dcols.data_ptr(), dx.data_ptr(), doff_y.data_ptr(),
                             doff_x.data_ptr(), dmask.data_ptr(), b, h, w, c, oh, ow, stride,
                             torch.cuda.current_stream().cuda_stream)
    build.check_launch(entry, rc)
    return dx.to(x.dtype), doff_y, doff_x, dmask


def product_cost(m: int, c: int, cout: int) -> roofline.Cost:
    """The fp32 product g [m, cout] (fp32) W^T [cout, 9c] -> [m, 9c] on the
    SIMT units (TF32 off)."""
    return roofline.Cost(bytes=4 * (m * cout + 9 * c * cout + m * 9 * c),
                         flops=2 * m * cout * 9 * c)


def stage_inputs(b, h, w, c, cout, device):
    """x (bf16), off_y, off_x, mask, g (bf16 [B*H*W, Cout]), weight (fp32),
    from numpy seed 0 (stride 1)."""
    rng = np.random.RandomState(common.SEED)
    x = rng.randn(b, h, w, c).astype(np.float32)
    off_y, off_x = ((rng.randn(b, h, w, 9) * 3).astype(np.float32) for _ in "yx")
    mask = rng.rand(b, h, w, 9).astype(np.float32)
    weight = (rng.randn(9 * c, cout) / np.sqrt(9 * c)).astype(np.float32)
    g = rng.randn(b * h * w, cout).astype(np.float32)
    x, off_y, off_x, mask, weight, g = common.to_device([x, off_y, off_x, mask, weight, g], device)
    return x.bfloat16(), off_y, off_x, mask, g.bfloat16(), weight


def step_calls(device) -> List[tuple]:
    """The (x, off_y, off_x, mask, g, weight, stride) of every bf16 K6 call
    of one bf16 bevformer_base training step, its first, at seeded weights
    and batch."""
    import chip_smoke as smoke  # the repository root is the working directory
    from bevformer_torch.configs import get_config
    from bevformer_torch.data import train_batch
    from bevformer_torch.runtime import Trainer, build_model, init_state_dict

    cfg = get_config("bevformer_base").replace(dtype="bfloat16")
    model = build_model(cfg, init_state_dict(cfg, seed=0), device)
    trainer = Trainer(model, total_steps=smoke.TRAIN_TOTAL_STEPS, seed=0)
    calls = []
    with smoke.recorded_col2im(calls, "dcn_col2im_gw"):
        trainer.step(train_batch(cfg, seed=0, device=device))
    torch.cuda.synchronize()
    del trainer, model
    return calls


def errors(grads, ref) -> dict:
    return dict(dx_ulps=bf16_ulps(grads[0], ref[0]),
                **{k: rel_err(a, r) for k, a, r in zip(("doff_y", "doff_x", "dmask"), grads[1:],
                                                       ref[1:])})


def kernels(libs: Dict[str, ctypes.CDLL], args) -> Dict[str, Callable]:
    """{kernel name: one call on `args` (x, off_y, off_x, mask, g, weight,
    stride)}: the package's K6, each variant's, and with an `--against`
    build its route, the product alone and the two fp32 K6 builds."""
    x, off_y, off_x, mask, g, weight, stride = args
    fns = {"gw": lambda: dcn.dcn_col2im_gw(*args)}
    for name, lib in libs.items():
        if name != "against":
            fns[name] = lambda lib=lib: dcn.launch_col2im_gw(lib, *args)
    if "against" in libs:
        lib = libs["against"]
        gm, wb = g.float(), weight.bfloat16().float()
        dcols = gm @ wb.t()
        x32 = x.float()
        fns["pair"] = lambda: against_col2im(lib, "dcn_col2im_bf16", x, off_y, off_x, mask,
                                             gm @ wb.t(), stride)
        fns["product"] = lambda: gm @ wb.t()
        fns["fp32"] = lambda: dcn.dcn_col2im(x32, off_y, off_x, mask, dcols, stride)
        fns["against fp32"] = lambda: against_col2im(lib, "dcn_col2im", x32, off_y, off_x, mask,
                                                     dcols, stride)
    return fns


def measure(case: str, shape: str, calls: List[tuple], libs, reps: int, **extra) -> List[dict]:
    """Every kernel over all of `calls` (one shape) in turns; one record
    each."""
    import chip_smoke as smoke

    per_call = [kernels(libs, args) for args in calls]
    names = list(per_call[0])
    errs = {name: {} for name in names}
    for args, fns in zip(calls, per_call):
        ref = dcn.dcn_col2im_gw_plain(*args)
        ref32 = None
        for name, fn in fns.items():
            if name == "product":
                continue
            if name.endswith("fp32"):
                x, off_y, off_x, mask, g, weight, stride = args
                if ref32 is None:
                    dcols = g.float() @ weight.bfloat16().float().t()
                    ref32 = dcn.dcn_col2im_plain(x.float(), off_y, off_x, mask, dcols, stride)
                e = {k: rel_err(a, r) for k, a, r in zip(("dx", "doff_y", "doff_x", "dmask"),
                                                          fn(), ref32)}
            else:
                e = errors(fn(), ref)
            for k, v in e.items():
                errs[name][k] = max(errs[name].get(k, 0.0), v)
        del ref, ref32
    ms = in_turns({name: (lambda name=name: [fns[name]() for fns in per_call]) for name in names},
                  reps)
    adds = 0
    cost_gw = cost_k6 = cost_product = 0.0
    for x, off_y, off_x, mask, g, weight, stride in calls:
        b, h, w, c = x.shape
        cout = weight.shape[1]
        adds += smoke.col2im_dx_adds(x.shape, off_y, off_x, stride) * c * 4
        cost_gw += roofline.dcn_col2im_gw(b, h, w, c, cout, stride).bound_ms
        cost_k6 += roofline.dcn_col2im(b, h, w, c, stride).bound_ms
        cost_product += product_cost(g.shape[0], c, cout).bound_ms
    records = []
    for name in names:
        bound = {"product": cost_product, "fp32": cost_k6, "against fp32": cost_k6}.get(
            name, cost_gw)
        mean = sum(ms[name]) / len(ms[name])
        rec = dict(tool=TOOL, case=case, shape=shape, kernel=name, calls=len(calls),
                   ms=ms[name], bound_ms=bound, share_of_bound=bound / mean,
                   dx_add_bytes=adds, **errs[name], **extra, card=common.card_line())
        print(json.dumps(rec), flush=True)
        records.append(rec)
    return records


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    import chip_smoke as smoke

    args = parser().parse_args(argv)
    device = common.require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = build_libs(args.against, args.variant)
    build.library()
    records = []
    if "stages" in args.cases:
        for name, b, h, w, c, cout, _ in smoke.BF16_DCN_CASES:
            x, off_y, off_x, mask, g, weight = stage_inputs(b, h, w, c, cout, device)
            records += measure("stages", name, [(x, off_y, off_x, mask, g, weight, 1)], libs,
                               args.reps)
            del x, off_y, off_x, mask, g, weight
            torch.cuda.empty_cache()
    if "step" in args.cases:
        calls = step_calls(device)
        shapes: Dict[str, List[tuple]] = {}
        for call in calls:
            x, weight, stride = call[0], call[5], call[6]
            key = f"x {list(x.shape)} Cout {weight.shape[1]} stride {stride}"
            shapes.setdefault(key, []).append(call)
        for key, group in shapes.items():
            rms = [float(torch.cat([c[1].reshape(-1), c[2].reshape(-1)]).detach().square().mean()
                         .sqrt()) for c in group]
            records += measure("step", key, group, libs, max(args.reps // 4, 1),
                               offset_rms_px=[min(rms), max(rms)])
        del calls, shapes
    return records


if __name__ == "__main__":
    main()
