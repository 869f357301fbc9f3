"""Mesh readers: STL (ASCII + binary), legacy-VTK tetrahedral meshes, and
Dolfin XML meshes (TetVTKReader/TetDolfinXMLReader/STLReader,
fibergen.cpp:1813-2072); host numpy, a copy of
fibergen_tpu/geometry/mesh.py."""
from __future__ import annotations

import struct
import xml.etree.ElementTree as ET

import numpy as np


def read_stl(path: str):
    """Return (V0, V1, V2) triangle vertex arrays, each (n, 3)."""
    with open(path, "rb") as f:
        head = f.read(5)
    if head == b"solid":
        try:
            return _read_stl_ascii(path)
        except ValueError:
            pass  # some binary files start with 'solid'
    return _read_stl_binary(path)


def _read_stl_ascii(path):
    tris = []
    cur = []
    with open(path, "r", errors="ignore") as f:
        for line in f:
            t = line.split()
            if not t:
                continue
            if t[0] == "vertex":
                cur.append([float(t[1]), float(t[2]), float(t[3])])
            elif t[0] == "endfacet":
                if len(cur) != 3:
                    raise ValueError("malformed ASCII STL facet")
                tris.append(cur)
                cur = []
    if not tris:
        raise ValueError("no facets found in ASCII STL")
    a = np.asarray(tris, dtype=np.float64)
    return a[:, 0], a[:, 1], a[:, 2]


def _read_stl_binary(path):
    with open(path, "rb") as f:
        f.read(80)
        (n,) = struct.unpack("<I", f.read(4))
        data = np.frombuffer(f.read(n * 50), dtype=np.uint8).reshape(n, 50)
    floats = data[:, 0:48].copy().view("<f4").reshape(n, 12).astype(np.float64)
    return floats[:, 3:6], floats[:, 6:9], floats[:, 9:12]


def read_tet_vtk(path: str):
    """ASCII legacy-VTK unstructured tetrahedral mesh ->
    (points (n,3), tets (m,4) int)."""
    points = None
    cells = []
    with open(path, "r", errors="ignore") as f:
        tokens = f.read().split()
    i = 0
    npts = 0
    while i < len(tokens):
        t = tokens[i].upper()
        if t == "POINTS":
            npts = int(tokens[i + 1])
            vals = [float(v) for v in tokens[i + 3:i + 3 + 3 * npts]]
            points = np.asarray(vals).reshape(npts, 3)
            i += 3 + 3 * npts
        elif t == "CELLS":
            ncells = int(tokens[i + 1])
            total = int(tokens[i + 2])
            j = i + 3
            for _ in range(ncells):
                cnt = int(tokens[j])
                if cnt == 4:
                    cells.append([int(tokens[j + k]) for k in range(1, 5)])
                j += cnt + 1
            i = j
        else:
            i += 1
    if points is None:
        raise ValueError("no POINTS in VTK file")
    return points, np.asarray(cells, dtype=np.int64)


def read_tet_dolfin(path: str):
    """Dolfin XML tetrahedral mesh -> (points (n,3), tets (m,4) int)."""
    root = ET.parse(path).getroot()
    mesh = root.find("mesh") if root.tag != "mesh" else root
    verts = mesh.find("vertices")
    cells = mesh.find("cells")
    n = int(verts.get("size"))
    points = np.zeros((n, 3))
    for v in verts:
        i = int(v.get("index"))
        points[i] = [float(v.get("x", 0)), float(v.get("y", 0)),
                     float(v.get("z", 0))]
    tets = []
    for c in cells:
        if c.tag == "tetrahedron":
            tets.append([int(c.get(f"v{k}")) for k in range(4)])
    return points, np.asarray(tets, dtype=np.int64)
