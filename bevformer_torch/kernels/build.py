"""Build and load the package's CUDA kernels.

Every `csrc/*.cu` file (with the `csrc/*.cuh` headers it includes) is
compiled by its own `nvcc` for `sm_90a` (Hopper), all of them at once, and
linked into one shared library with a plain C interface, which `ctypes`
loads. The library is built at first use into `bevformer_torch/build/`,
keyed by a hash of the sources, headers and flags, so a
fresh checkout builds it on its first kernel call and later processes
reuse it.

The C entry points take no torch headers: pointers and the stream go in as
`c_void_p`, sizes as `c_int`, and each returns `cudaGetLastError()` after
its launch.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",
)
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

_P = ctypes.c_void_p
_I = ctypes.c_int

# C signatures of the entry points, in argument order
SIGNATURES = {
    # value, loc, attw, out, level_hw (host int32 [2L]), L, B, K, Q, H, D, P,
    # queries per block, stream
    "msda_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # msda_fwd's arguments with the probe mode (1 gather, 2 weights, 3 noop)
    # before the queries per block
    "msda_fwd_probe": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # value .. P as msda_fwd, then the mode (0 full, 1-3 as above), the
    # queries per block, the accumulator sets per 8-lane group and the stream
    "msda_fwd_ho": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # src, idx (int32), out, B, M, R, row bytes, stream
    "row_gather": [_P, _P, _P, _I, _I, _I, _I, _P],
    # x, off_y, off_x, mask, weight, the weight's split scratch, out, B, H,
    # W, C, OH, OW, Cout, stride, stream
    "dcn_conv_fwd": [_P, _P, _P, _P, _P, _P, _P,
                     _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # value, loc, attw, grad_out, dvalue (zeroed), dloc, dattw, level_hw,
    # L, B, K, Q, H, D, P, queries per block, stream
    "msda_bwd": [_P, _P, _P, _P, _P, _P, _P, _P,
                 _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # x, off_y, off_x, mask, cols, B, H, W, C, OH, OW, stride, stream
    "dcn_im2col": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # x, off_y, off_x, mask, dcols, dx (zeroed), doff_y, doff_x, dmask,
    # B, H, W, C, OH, OW, stride, stream
    "dcn_col2im": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                   _I, _I, _I, _I, _I, _I, _I, _P],
}


def sources():
    return sorted(SRC_DIR.glob("*.cu"))


def headers():
    return sorted(SRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    # CUDA_HOME as PyTorch resolves it (env var, nvcc on PATH, or the
    # toolkit's default prefix)
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is required")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in sources() + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


class BuildResult:
    def __init__(self, path: Path, seconds: float, log: str, built: bool):
        self.path = path
        self.seconds = seconds
        self.log = log
        self.built = built


def build(force: bool = False) -> BuildResult:
    """Compile `csrc/*.cu` into `build/` unless a library with the same
    source hash is there already."""
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {SRC_DIR}")
    out = BUILD_DIR / f"libbevformer_kernels_{_digest()}.so"
    if out.exists() and not force:
        return BuildResult(out, 0.0, "", built=False)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    # one nvcc per source, all at once, then one link
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in srcs]
    compiles = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for src, obj in zip(srcs, objs)
    ]
    logs, failed = [], []
    for src, proc in zip(srcs, compiles):
        text, _ = proc.communicate()
        logs.append(text)
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode})")
    tmp = out.with_suffix(f".{tag}.tmp")
    if not failed:
        link = subprocess.run(
            [nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True,
        )
        logs.append(link.stdout + link.stderr)
        if link.returncode != 0:
            failed.append(f"link ({link.returncode})")
    for obj in objs:
        obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    log = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed: {', '.join(failed)}:\n{log}")
    os.replace(tmp, out)
    return BuildResult(out, seconds, log, built=True)


def sass(path: Path) -> str:
    """The SASS of a built library, as the toolkit's `cuobjdump -sass`
    prints it (next to nvcc)."""
    cuobjdump = Path(_nvcc()).parent / "cuobjdump"
    return subprocess.run([str(cuobjdump), "-sass", str(path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout


def atomic_ops(path: Path, kernel: str) -> dict:
    """{SASS atomic or reduction opcode: count} over every function of the
    built library `path` whose name contains `kernel` (all instantiations).
    A float add the hardware cannot do in one instruction shows as a
    compare-and-swap loop (an opcode with CAS)."""
    ops, inside = {}, False
    for line in sass(path).splitlines():
        fn = re.search(r"Function : (\S+)", line)
        if fn:
            inside = kernel in fn.group(1)
            continue
        op = re.search(r"\b((?:REDG?|REDS|ATOM[GS]?)\.[\w.]+)", line)
        if inside and op:
            ops[op.group(1)] = ops.get(op.group(1), 0) + 1
    return ops


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed), with the
    argument and return types of every entry point declared."""
    lib = ctypes.CDLL(str(build().path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


CUDA_ERROR_INVALID_VALUE = 1


def check_launch(name: str, rc: int) -> None:
    if rc == CUDA_ERROR_INVALID_VALUE:
        raise RuntimeError(f"{name}: the kernel does not take these arguments "
                           f"(cudaErrorInvalidValue)")
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
