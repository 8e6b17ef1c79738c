"""Camera images on disk, without an image codec library.

`write_png` and `read_image` are the port's counterpart of the JAX data
layer's `cv2.imwrite` / `cv2.imread`: images go in and come out as uint8
[H, W, 3] arrays in BGR order, as cv2 hands them over. The PNG is the
simplest one: 8-bit truecolour (colour type 2), no interlace, filter 0 on
every row, the rows in one zlib stream in one IDAT chunk. The reader reads
exactly that and raises on anything else a PNG may hold.

`read_image` picks the decoder by the file's signature: PNG through the
reader here; JPEG (the real nuScenes cameras) through cv2 where cv2
imports, and otherwise a RuntimeError naming the file. Nothing is read
by a decoder the file was not written for.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SIGNATURE = b"\xff\xd8\xff"
ZLIB_LEVEL = 6  # zlib's default


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def write_png(path: str, img: np.ndarray) -> None:
    """Write a uint8 [H, W, 3] BGR image as an 8-bit RGB PNG."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"write_png: need uint8 [H, W, 3], got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    rows = np.empty((h, 1 + 3 * w), np.uint8)
    rows[:, 0] = 0  # filter type 0 (None) on every row
    rows[:, 1:] = img[:, :, ::-1].reshape(h, 3 * w)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), ZLIB_LEVEL))
                + _chunk(b"IEND", b""))


def _read_png(path: str, data: bytes) -> np.ndarray:
    def bad(why: str):
        return ValueError(f"{path}: {why} (the reader takes the PNGs write_png writes)")

    pos, chunks = len(PNG_SIGNATURE), []
    while pos < len(data):
        if pos + 8 > len(data):
            raise bad("truncated chunk header")
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise bad(f"truncated {kind!r} chunk")
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + body):
            raise bad(f"CRC mismatch in {kind!r}")
        chunks.append((kind, body))
        pos += 12 + length
    kinds = [k for k, _ in chunks]
    if kinds != [b"IHDR", b"IDAT", b"IEND"]:
        raise bad(f"chunks {kinds}, want IHDR, one IDAT, IEND")
    w, h, depth, colour, compression, filt, interlace = struct.unpack(">IIBBBBB", chunks[0][1])
    if (depth, colour, compression, filt, interlace) != (8, 2, 0, 0, 0):
        raise bad(f"bit depth {depth}, colour type {colour}, compression {compression}, "
                  f"filter method {filt}, interlace {interlace}; want 8, 2, 0, 0, 0")
    raw = zlib.decompress(chunks[1][1])
    if len(raw) != h * (1 + 3 * w):
        raise bad(f"{len(raw)} bytes of rows for {w} x {h}")
    rows = np.frombuffer(raw, np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise bad("a row uses a filter other than 0")
    return np.ascontiguousarray(rows[:, 1:].reshape(h, w, 3)[:, :, ::-1])


def _read_jpeg(path: str) -> np.ndarray:
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(
            f"{path}: a JPEG, and no JPEG decoder is available (cv2 does not import: {e})"
        ) from e
    img = cv2.imread(path)  # BGR HWC uint8
    if img is None:
        raise RuntimeError(f"{path}: cv2 could not decode it")
    return img


def read_image(path: str) -> np.ndarray:
    """uint8 [H, W, 3] BGR image of a PNG written by `write_png`, or of a
    JPEG where cv2 is installed."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(PNG_SIGNATURE):
        return _read_png(path, data)
    if data.startswith(JPEG_SIGNATURE):
        return _read_jpeg(path)
    raise ValueError(f"{path}: neither a PNG nor a JPEG (starts {data[:8]!r})")
