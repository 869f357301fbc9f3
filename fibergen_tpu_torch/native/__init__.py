"""ctypes bindings of the host-side geometry kernels (fibergen_native.cpp).

The library builds with ``g++`` at first use into the git-ignored
``fibergen_tpu_torch/_build/native-<hash>/``, the hash covering the source
and the flags, and loads from there.  Without ``g++`` (or with
``FIBERGEN_TPU_NATIVE=0``) every function returns None and its callers take
the numpy twins (``geometry.primitives.segment_segment_distance``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "fibergen_native.cpp"
BUILD = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]

_lib = None
_tried = False


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SRC.read_bytes())
    return BUILD / f"native-{h.hexdigest()[:16]}" / "libfibergen_native.so"


def _build(so: Path):
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SRC)], check=True,
                   capture_output=True)
    os.replace(tmp, so)


def get_lib():
    """The loaded library (built first if needed); None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if os.environ.get("FIBERGEN_TPU_NATIVE", "1") == "0":
        return None
    so = library_path()
    try:
        if not so.exists():
            _build(so)
        lib = ctypes.CDLL(str(so))
    except (OSError, subprocess.CalledProcessError):
        return None
    dptr = ctypes.POINTER(ctypes.c_double)
    lib.segseg_distance_batch.argtypes = [dptr, dptr, dptr, dptr,
                                          ctypes.c_int64, dptr]
    lib.segseg_distance_batch.restype = None
    lib.halfspace_box_cut_fraction.argtypes = [ctypes.c_double] * 7
    lib.halfspace_box_cut_fraction.restype = ctypes.c_double
    _lib = lib
    return _lib


def _f64(a):
    return np.ascontiguousarray(a, dtype=np.float64)


def _ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def segseg_distance_batch(p1, q1, P2, Q2):
    """Distances between the segment (p1, q1) and each (P2[i], Q2[i]);
    None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    p1, q1, P2, Q2 = (_f64(a) for a in (p1, q1, P2, Q2))
    out = np.empty(P2.shape[0], dtype=np.float64)
    lib.segseg_distance_batch(_ptr(p1), _ptr(q1), _ptr(P2), _ptr(Q2),
                              P2.shape[0], _ptr(out))
    return out


def halfspace_box_cut_fraction(n, d, h):
    """The long-double volume fraction of a box of edges ``h`` behind the
    plane at signed distance ``d`` from its centre with unit normal ``n``
    (the oracle of ``discretize.plane_cut_fraction``); None without the
    library."""
    lib = get_lib()
    if lib is None:
        return None
    return float(lib.halfspace_box_cut_fraction(
        float(n[0]), float(n[1]), float(n[2]), float(d),
        float(h[0]), float(h[1]), float(h[2])))
