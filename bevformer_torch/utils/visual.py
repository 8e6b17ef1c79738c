"""Feature-map dumping: port of `bevformer_tpu/utils/visual.py` (reference
`models/utils/visual.py:15`, `save_tensor`)."""

from __future__ import annotations

import math

import numpy as np


def save_tensor(tensor, path: str, pad_value: float = 254.0) -> str:
    """A [C, H, W], [N, C, H, W] or [H, W] array or tensor -> an image grid
    written by cv2 (each map min-max scaled to 0-255; a 4-D input shows
    each sample's channel mean)."""
    import cv2

    if hasattr(tensor, "detach"):
        tensor = tensor.detach().float().cpu().numpy()
    t = np.asarray(tensor, np.float32)
    if t.ndim == 2:
        t = t[None]
    if t.ndim == 4:
        t = t.mean(1)
    n, h, w = t.shape
    cols = int(math.ceil(math.sqrt(n)))
    rows = int(math.ceil(n / cols))
    grid = np.full((rows * (h + 2), cols * (w + 2)), pad_value, np.float32)
    for i in range(n):
        r, c = divmod(i, cols)
        img = t[i]
        lo, hi = img.min(), img.max()
        img = (img - lo) / max(hi - lo, 1e-12) * 255.0
        grid[r * (h + 2): r * (h + 2) + h, c * (w + 2): c * (w + 2) + w] = img
    if not cv2.imwrite(path, grid.astype(np.uint8)):
        raise RuntimeError(f"{path}: cv2 could not write it")
    return path
