"""The device the port's entry points run on: the card unless the caller
asks for another (the CPU tests pass `device="cpu"`), and the precision
they compute in."""

from __future__ import annotations

from contextlib import contextmanager

import torch

DEFAULT = "cuda"


def resolve(device=DEFAULT) -> torch.device:
    """`device` as a torch.device; a CUDA device without a card raises
    (nothing falls back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} asked for, but no CUDA device is available "
                           "(pass device='cpu' to run on the CPU)")
    return device


@contextmanager
def precision(dtype: str):
    """Compute the enclosed calls in the config's `dtype`. "float32" turns
    TF32 off for cuBLAS matmuls and cuDNN convolutions (PyTorch's default
    lets cuDNN convolve fp32 in TF32, about three decimal digits) and gives
    the caller's settings back afterwards, also when the calls raise. Any
    other dtype raises: bf16 is later work (ROADMAP.md §1 item 5)."""
    if dtype != "float32":
        raise NotImplementedError(
            f"dtype {dtype!r}: the port computes in float32 only (bf16 is ROADMAP.md §1 item 5)")
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
