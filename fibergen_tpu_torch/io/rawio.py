"""Raw (optionally gzip) voxel data ingestion and export (host numpy; a
copy of fibergen_tpu/io/rawio.py, byte for byte the same layout).

Equivalent of readRawPhase/writeRawPhase (fibergen.cpp:16925-17075):
uint8/16/32/float/double rasters in column (z fastest, matching the
reference's memory order) or row order, with integer scaling, optional
thresholding and a skippable header.
"""
from __future__ import annotations

import gzip

import numpy as np

_DTYPES = {
    "uint8": np.uint8,
    "uint16": np.uint16,
    "uint32": np.uint32,
    "float": np.float32,
    "double": np.float64,
}


def _open(path, mode):
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def read_raw(path: str, shape, dtype="uint8", order="col", scale=None,
             threshold=-1.0, header_bytes=0) -> np.ndarray:
    """Read a raw voxel raster into a (nx, ny, nz) float array in [0, 1]."""
    dt = _DTYPES[dtype]
    n = int(np.prod(shape))
    with _open(path, "rb") as f:
        if header_bytes:
            f.read(header_bytes)
        buf = f.read(n * np.dtype(dt).itemsize)
    data = np.frombuffer(buf, dtype=dt, count=n).astype(np.float64)
    if order == "col":
        # reference memory order: z fastest (x-major), i.e. C order (x,y,z)
        data = data.reshape(shape)
    else:
        data = data.reshape(shape[::-1]).transpose(2, 1, 0)
    if scale is None:
        scale = (1.0 / np.iinfo(dt).max) if np.issubdtype(dt, np.integer) else 1.0
    data = data * scale
    if threshold >= 0:
        data = (data > threshold).astype(np.float64)
    return data


def write_raw(path: str, data: np.ndarray, dtype="uint8", order="col",
              scale=None):
    """Write a (nx, ny, nz) float array as a raw raster."""
    dt = _DTYPES[dtype]
    if scale is None:
        scale = float(np.iinfo(dt).max) if np.issubdtype(dt, np.integer) else 1.0
    arr = np.asarray(data, dtype=np.float64) * scale
    if np.issubdtype(dt, np.integer):
        arr = np.clip(np.round(arr), 0, np.iinfo(dt).max)
    arr = arr.astype(dt)
    if order != "col":
        arr = arr.transpose(2, 1, 0)
    with _open(path, "wb") as f:
        f.write(np.ascontiguousarray(arr).tobytes())
