"""Legacy-VTK structured-points writer (host numpy; a copy of
fibergen_tpu/io/vtk.py, byte for byte the same file).

Equivalent of VTKCubeWriter (fibergen.cpp:5714-6073): writes voxel fields as
legacy VTK STRUCTURED_POINTS with binary (big-endian) or ASCII encoding.
Vector/tensor fields with a leading component axis are written as one
SCALARS record per component named '<field>_<k>' plus a VECTORS record for
3-component fields.  ``dtype`` selects the written scalar type (float32 /
float64 — the reference's <restype>float/double</restype>, fibergen.cpp:
26552, template parameter R of FG<T, R, DIM>).  :func:`read_vtk` reads such
a file back.
"""
from __future__ import annotations

import numpy as np


def write_vtk(path: str, grid, fields: dict, binary: bool = True,
              dtype=np.float32):
    """fields: name -> array of shape (ncomp, nx, ny, nz)."""
    nx, ny, nz = grid.shape
    sx, sy, sz = grid.spacing
    ox, oy, oz = grid.x0
    dtype = np.dtype(dtype)
    vtype = "double" if dtype == np.float64 else "float"

    with open(path, "wb") as f:
        def w(text):
            f.write(text.encode("ascii"))

        w("# vtk DataFile Version 3.0\n")
        w("fibergen_tpu\n")
        w("BINARY\n" if binary else "ASCII\n")
        w("DATASET STRUCTURED_POINTS\n")
        # VTK is column-major (x fastest); our arrays are (c, x, y, z)
        w(f"DIMENSIONS {nx} {ny} {nz}\n")
        w(f"ORIGIN {ox + 0.5 * sx} {oy + 0.5 * sy} {oz + 0.5 * sz}\n")
        w(f"SPACING {sx} {sy} {sz}\n")
        w(f"POINT_DATA {nx * ny * nz}\n")

        for name, arr in fields.items():
            arr = np.asarray(arr, dtype=dtype)
            if arr.ndim == 3:
                arr = arr[None]
            ncomp = arr.shape[0]
            if ncomp == 3:
                w(f"VECTORS {name} {vtype}\n")
                # (3, x, y, z) -> (z, y, x, 3) with x fastest
                data = np.moveaxis(arr, 0, -1).transpose(2, 1, 0, 3)
                _write_block(f, data, binary, dtype)
            for k in range(ncomp):
                cname = name if ncomp == 1 else f"{name}_{k}"
                w(f"SCALARS {cname} {vtype} 1\n")
                w("LOOKUP_TABLE default\n")
                data = arr[k].transpose(2, 1, 0)
                _write_block(f, data, binary, dtype)


def _write_block(f, data, binary, dtype=np.float32):
    be = np.dtype(dtype).newbyteorder(">")
    flat = np.ascontiguousarray(data, dtype=be if binary else dtype)
    if binary:
        f.write(flat.tobytes())
        f.write(b"\n")
    else:
        # round-trip-exact significant digits for the declared scalar type
        fmt = "%.17g" if np.dtype(dtype) == np.float64 else "%.9g"
        np.savetxt(f, flat.reshape(-1, 1), fmt=fmt)


def read_vtk(path: str):
    """Read a file of :func:`write_vtk` back: (header, records), the header
    the eight lines up to POINT_DATA, the records a list of (kind, name,
    array) in file order, kind "VECTORS" or "SCALARS", the array (3, nx,
    ny, nz) or (nx, ny, nz) in the file's scalar type (native byte
    order)."""
    with open(path, "rb") as f:
        data = f.read()
    pos = 0

    def line():
        nonlocal pos
        end = data.index(b"\n", pos)
        text = data[pos:end].decode("ascii")
        pos = end + 1
        return text

    header = [line() for _ in range(8)]
    binary = header[2] == "BINARY"
    nx, ny, nz = (int(v) for v in header[4].split()[1:4])
    n = nx * ny * nz
    records = []
    while pos < len(data):
        words = line().split()
        if not words:
            continue
        kind, name, vtype = words[0], words[1], words[2]
        dt = np.dtype(np.float64 if vtype == "double" else np.float32)
        ncomp = 3 if kind == "VECTORS" else 1
        if kind == "SCALARS":
            line()                              # LOOKUP_TABLE default
        count = n * ncomp
        if binary:
            flat = np.frombuffer(data, dtype=dt.newbyteorder(">"),
                                 count=count, offset=pos).astype(dt)
            pos += count * dt.itemsize + 1      # the block's newline
        else:
            flat = np.array([float(line()) for _ in range(count)], dtype=dt)
        if kind == "VECTORS":
            # (z, y, x, 3) with x fastest -> (3, x, y, z)
            arr = np.moveaxis(flat.reshape(nz, ny, nx, 3).transpose(2, 1, 0, 3),
                              -1, 0)
        else:
            arr = flat.reshape(nz, ny, nx).transpose(2, 1, 0)
        records.append((kind, name, np.ascontiguousarray(arr)))
    return header, records
