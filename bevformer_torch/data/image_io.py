"""Camera images on disk: JPEG through cv2, as the JAX data layer reads and
writes them (`cv2.imwrite` of a `.jpg`, `cv2.imread`).

Images go in and come out as uint8 [H, W, 3] arrays in BGR order, as cv2
hands them over. The codec is lossy: a written image decodes close to, not
equal to, the array written, and two cv2 versions may encode one array
differently. What is exact is the decode of one file: the port and the JAX
package read the same `.jpg` to the same array.

cv2 is imported where an image is read or written. On a machine without
cv2 both raise a RuntimeError that names the file.
"""

from __future__ import annotations

import numpy as np


def _cv2(path: str, what: str):
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(f"{path}: cannot {what} it, cv2 does not import ({e})") from e
    return cv2


def write_image(path: str, img: np.ndarray) -> None:
    """Write a uint8 [H, W, 3] BGR image, encoded by the file's extension
    (`.jpg` for the cameras), as `cv2.imwrite` does."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"write_image: need uint8 [H, W, 3], got {img.dtype} {img.shape}")
    if not _cv2(path, "write").imwrite(path, img):
        raise RuntimeError(f"{path}: cv2 could not write it")


def read_image(path: str) -> np.ndarray:
    """uint8 [H, W, 3] BGR image of a file cv2 decodes (the cameras' JPEGs)."""
    img = _cv2(path, "decode").imread(path)  # BGR HWC uint8
    if img is None:
        raise FileNotFoundError(f"{path}: missing, or not an image cv2 decodes")
    return img
