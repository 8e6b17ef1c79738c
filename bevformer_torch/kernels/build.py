"""Build and load the package's CUDA kernels.

Every `csrc/*.cu` file is compiled by `nvcc` for `sm_90a` (Hopper) into one
shared library with a plain C interface, which `ctypes` loads. The library
is built at first use into `bevformer_torch/build/`, keyed by a hash of the
sources and flags, so a fresh checkout builds it on its first kernel call
and later processes reuse it.

The C entry points take no torch headers: pointers and the stream go in as
`c_void_p`, sizes as `c_int`, and each returns `cudaGetLastError()` after
its launch.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int

# C signatures of the entry points, in argument order
SIGNATURES = {
    # value, loc, attw, out, level_hw (host int32 [2L]), L, B, K, Q, H, D, P,
    # stream
    "msda_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # x, off_y, off_x, mask, weight, out, B, H, W, C, OH, OW, Cout, stride,
    # stream
    "dcn_conv_fwd": [_P, _P, _P, _P, _P, _P,
                     _I, _I, _I, _I, _I, _I, _I, _I, _P],
}


def sources():
    return sorted(SRC_DIR.glob("*.cu"))


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
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
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
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return BuildResult(out, seconds, log, built=True)


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


def check_launch(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
