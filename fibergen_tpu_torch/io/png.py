"""Minimal dependency-free PNG writer (grayscale / RGB, 8-bit; a copy of
fibergen_tpu/io/png.py).

Equivalent of the reference's libpng-based write_png action output
(fibergen.cpp:25352)."""
from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray):
    """img: (h, w) grayscale or (h, w, 3) RGB, floats in [0,1] or uint8."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.clip(img, 0.0, 1.0)
        img = (img * 255.0 + 0.5).astype(np.uint8)
    if img.ndim == 2:
        color_type = 0
        row_data = img[:, :, None]
    elif img.ndim == 3 and img.shape[2] == 3:
        color_type = 2
        row_data = img
    else:
        raise ValueError("img must be (h,w) or (h,w,3)")
    h, w = img.shape[:2]
    raw = b"".join(b"\x00" + row_data[i].tobytes() for i in range(h))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type,
                                            0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(raw, 9)))
        f.write(_chunk(b"IEND", b""))


def colormap_jet(v: np.ndarray) -> np.ndarray:
    """Simple jet colormap for v in [0,1] -> (..., 3) floats."""
    v = np.clip(np.asarray(v, dtype=np.float64), 0.0, 1.0)
    r = np.clip(1.5 - np.abs(4 * v - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * v - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * v - 1), 0, 1)
    return np.stack([r, g, b], axis=-1)
