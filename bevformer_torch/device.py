"""The device the port's entry points run on: the card unless the caller
asks for another (the CPU tests pass `device="cpu"`), and the precision
they compute in: fp32, or bf16 around the fp32 islands that `fp32` marks."""

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


DTYPES = ("float32", "bfloat16")


@contextmanager
def precision(dtype: str, device_type: str = DEFAULT):
    """Compute the enclosed calls in the config's `dtype`, on devices of
    `device_type`. Both dtypes turn TF32 off for cuBLAS matmuls and cuDNN
    convolutions (PyTorch's default lets cuDNN convolve fp32 in TF32, about
    three decimal digits) and give the caller's settings back afterwards,
    also when the calls raise. "bfloat16" also runs them under
    `torch.autocast(device_type, torch.bfloat16)`: matmuls and convolutions
    in bf16 on fp32 parameters, as the JAX package's `dtype=bfloat16`
    modules, except in the regions marked `fp32`. bf16 keeps fp32's exponent
    range, so no loss scaling is needed. Any other dtype raises."""
    if dtype not in DTYPES:
        raise NotImplementedError(f"dtype {dtype!r}: the port computes in {' or '.join(DTYPES)}")
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.autocast(device_type, dtype=torch.bfloat16, enabled=dtype == "bfloat16"):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def fp32(device) -> torch.autocast:
    """A region that computes in fp32 inside `precision("bfloat16")`: the
    fp32 islands the JAX package pins (the sampling-offset, attention-weight
    and reference-point projections, `point_sampling`, the prev-BEV
    rotation, the head's last layers, the losses). Autocast is off inside;
    the caller hands the region fp32 inputs."""
    return torch.autocast(torch.device(device).type, enabled=False)
