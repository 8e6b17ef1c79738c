"""bf16 K2 (`dcn_conv_fwd_bf16`) against variants of its own source, from
the repository root on a card:

    python -m bevformer_torch.tools.bench_dcn_variants [x16] [cfence]

A variant is `csrc/dcn_conv_fwd.cu` with the text edits of `VARIANTS`
applied, each of which must match the source exactly once (so a variant
that no longer fits the kernel raises rather than measuring something
else). Each is compiled by its own `nvcc` with the package's flags into a
library under `build/variants/`, all at once, and timed beside the
package's own kernel at the bf16 DCN stages of bevformer_base and
bevformer_small (`chip_smoke.BF16_DCN_CASES`, offsets N(0, 3) px), in turns
within one process: the package's kernel, then the variants, then the
variants in reverse, then the package's kernel again. Each turn times 20
launches back to back, as `chip_smoke.py` does. One JSON line per shape
and kernel: both turns' ms and the error against the plain version in bf16
ulps at its scale. This is how a design choice inside the kernel is
measured without keeping a second path in it.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from bevformer_torch.kernels import build, dcn
from bevformer_torch.tools import common

TOOL = "bench_dcn_variants"
SOURCE = build.SRC_DIR / "dcn_conv_fwd.cu"
REPS = 20

_FENCE = '    asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");\n'
_WAIT = "        mbar_wait(&s.full[stage], phase);\n"

# name: [(text in the source, its replacement), ...]
VARIANTS: Dict[str, List[Tuple[str, str]]] = {
    # one 16-byte load for 8 channels in place of two 8-byte ones (right
    # only for an x on a 16-byte boundary, as every input here is)
    "x16": [(
        "  const uint2 lo = __ldg(reinterpret_cast<const uint2*>(p));\n"
        "  const uint2 hi = __ldg(reinterpret_cast<const uint2*>(p) + 1);\n"
        "  return make_uint4(lo.x, lo.y, hi.x, hi.y);\n",
        "  return __ldg(reinterpret_cast<const uint4*>(p));\n",
    )],
    # the proxy fence taken by the consumer warpgroup after its full-barrier
    # wait, not by each sampling warp after its column rows
    "cfence": [
        ("    // the writes, seen by the wgmmas' (async proxy) reads\n" + _FENCE, ""),
        (_WAIT, _WAIT + "    " + _FENCE),
    ],
}


def variant_source(name: str, text: str) -> str:
    """`text` with variant `name`'s edits applied; raises unless each edit
    matches exactly once."""
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise ValueError(f"variant {name}: an edit matches {text.count(old)} times, not once:"
                             f"\n{old}")
        text = text.replace(old, new)
    return text


def build_variants(names: Sequence[str]) -> Dict[str, Callable[..., int]]:
    """{name: its `dcn_conv_fwd_bf16`}, every variant compiled at once."""
    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    text = SOURCE.read_text()
    procs = []
    for name in names:
        src = out_dir / f"{name}.cu"
        src.write_text(variant_source(name, text))
        lib = out_dir / f"{name}.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-I", str(build.SRC_DIR),
               "-o", str(lib), str(src)]
        procs.append((name, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                  stderr=subprocess.STDOUT, text=True)))
    fns = {}
    for name, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        fns[name] = _entry(ctypes.CDLL(str(lib)))
    return fns


def _entry(lib: ctypes.CDLL) -> Callable[..., int]:
    fn = lib.dcn_conv_fwd_bf16
    fn.argtypes = build.SIGNATURES["dcn_conv_fwd_bf16"]
    fn.restype = ctypes.c_int
    return fn


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    names = list(sys.argv[1:] if argv is None else argv) or list(VARIANTS)
    device = common.require_cuda()
    import chip_smoke as smoke  # the repository root is the working directory

    kernels = {"package": _entry(build.library()), **build_variants(names)}
    order = list(kernels) + list(kernels)[::-1]
    gen = torch.Generator(device=device).manual_seed(0)
    records = []
    for case, b, h, w, c, cout, _ in smoke.BF16_DCN_CASES:
        x = torch.randn((b, h, w, c), generator=gen, device=device).bfloat16()
        if x.data_ptr() % 16:  # the x16 variant's loads need it
            raise RuntimeError("x is not on a 16-byte boundary")
        off_y = torch.randn((b, h, w, 9), generator=gen, device=device) * 3
        off_x = torch.randn((b, h, w, 9), generator=gen, device=device) * 3
        mask = torch.rand((b, h, w, 9), generator=gen, device=device)
        weight = torch.randn((9 * c, cout), generator=gen, device=device) / (9 * c) ** 0.5
        ref = dcn.dcn_conv_plain(x, off_y, off_x, mask, weight)
        prep = torch.empty(-(-cout // 256) * 256 * 9 * c, dtype=torch.bfloat16, device=device)
        out = torch.empty_like(ref)
        stream = torch.cuda.current_stream().cuda_stream

        def launch(fn):
            build.check_launch("dcn_conv_fwd_bf16", fn(
                x.data_ptr(), off_y.data_ptr(), off_x.data_ptr(), mask.data_ptr(),
                weight.data_ptr(), prep.data_ptr(), out.data_ptr(), b, h, w, c, h, w, cout, 1,
                stream))

        ms: Dict[str, List[float]] = {name: [] for name in kernels}
        errs = {}
        for name in order:
            out.zero_()
            launch(kernels[name])
            torch.cuda.synchronize()
            errs[name] = max(errs.get(name, 0.0), smoke.ulps(out, ref))
            ms[name].append(smoke.time_ms(lambda: launch(kernels[name]), REPS))
        for name in kernels:
            rec = dict(tool=TOOL, case=case, kernel=name, ms=ms[name], ulps=errs[name],
                       card=common.card_line())
            print(json.dumps(rec), flush=True)
            records.append(rec)
        del x, off_y, off_x, mask, weight, ref, prep, out
        torch.cuda.empty_cache()
    return records


if __name__ == "__main__":
    main()
