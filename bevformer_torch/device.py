"""The device the port's entry points run on: the card unless the caller
asks for another (the CPU tests pass `device="cpu"`)."""

from __future__ import annotations

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
