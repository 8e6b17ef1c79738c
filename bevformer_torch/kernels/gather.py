"""Row gather: out[b, r, :] = src[b, idx[b, r], :].

`row_gather` runs the CUDA kernel `csrc/row_gather.cu` on a CUDA tensor (one
warp per output row, 16-byte vector copies) and its plain PyTorch version
`row_gather_plain` (`torch.take_along_dim`) on a CPU tensor. It is the
counterpart of the JAX package's DMA-gather probe
(`tools/bench_dma_gather.py`), whose output it reproduces bitwise.
"""

from __future__ import annotations

import torch

from bevformer_torch.kernels import build

DTYPES = (torch.bfloat16, torch.float32)


def row_gather_plain(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """src [B, M, E], idx [B, R] (integer) -> [B, R, E]."""
    return torch.take_along_dim(src, idx[..., None].long(), 1)


def _check(src, idx):
    if src.dim() != 3 or idx.dim() != 2 or idx.shape[0] != src.shape[0]:
        raise ValueError(f"src must be [B, M, E] and idx [B, R], got {tuple(src.shape)} "
                         f"and {tuple(idx.shape)}")
    if src.dtype not in DTYPES:
        raise TypeError(f"src must be one of {DTYPES}, got {src.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    if idx.device != src.device:
        raise ValueError(f"idx is on {idx.device}, src on {src.device}")
    if not (src.is_contiguous() and idx.is_contiguous()):
        raise ValueError("src and idx must be contiguous")
    row_bytes = src.shape[2] * src.element_size()
    if row_bytes % 16:
        raise ValueError(f"a row of {row_bytes} bytes is not a multiple of 16")
    return row_bytes


def row_gather(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[b, r, :] = src[b, idx[b, r], :] for src [B, M, E] bf16 or fp32 and
    idx [B, R] int32 with 0 <= idx < M. The plain version for a CPU tensor
    (which checks the index range), the kernel for a CUDA tensor (which does
    not: an index out of range reads another row or faults)."""
    row_bytes = _check(src, idx)
    b, m, e = src.shape
    if src.device.type == "cpu":
        if idx.numel() and not (0 <= int(idx.min()) and int(idx.max()) < m):
            raise IndexError(f"idx out of range [0, {m})")
        return row_gather_plain(src, idx)
    if src.device.type != "cuda":
        raise ValueError(f"row_gather: unsupported device {src.device}")
    r = idx.shape[1]
    out = torch.empty((b, r, e), dtype=src.dtype, device=src.device)
    lib = build.library()
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.row_gather(src.data_ptr(), idx.data_ptr(), out.data_ptr(), b, m, r,
                            row_bytes, stream)
    build.check_launch("row_gather", rc)
    row_gather.launches += 1
    return out


row_gather.launches = 0
