"""Build the CUDA sources in ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, ``_build/<hash>/lib<name>.so``, where the
hash covers every source and the flags: an edited source builds anew, an
unchanged one is loaded as built.  All sources compile at once, one
``nvcc`` process each.  Nothing here runs until a CUDA tensor first reaches
a kernel wrapper, so the package imports without ``nvcc`` or a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict = {}
ptxas_log: dict = {}   # per source compiled here: the compiler's output


def nvcc_path() -> str:
    for cand in (os.environ.get("NVCC"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or NVCC, or put nvcc "
                       "on PATH")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> Path:
    """Compile every source not yet built for this digest; returns the
    build directory.  Raises with the compiler's output on failure."""
    out = BUILD / _digest()
    todo = [s for s in _sources() if not (out / f"lib{s.stem}.so").exists()]
    if not todo:
        return out
    out.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = []
    for s in todo:
        tmp = out / f"lib{s.stem}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(s)]
        procs.append((s, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for s, tmp, p in procs:
        log, _ = p.communicate()
        ptxas_log[s.name] = log
        if p.returncode != 0:
            failed.append(f"{s.name}:\n{log}")
        else:
            os.replace(tmp, out / f"lib{s.stem}.so")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu``."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            out = build_all()
            lib = ctypes.CDLL(str(out / f"lib{name}.so"))
            lib.fg_error_string.restype = ctypes.c_char_p
            lib.fg_error_string.argtypes = [ctypes.c_int]
            _libs[name] = lib
        return lib


_fns: dict = {}


def function(lib_name: str, fn_name: str, restype, argtypes):
    """C entry point ``fn_name`` of ``lib<lib_name>.so`` with its ctypes
    signature set (pointers and the stream as ``c_void_p``)."""
    key = (lib_name, fn_name)
    fn = _fns.get(key)
    if fn is None:
        fn = getattr(load(lib_name), fn_name)
        fn.restype = restype
        fn.argtypes = argtypes
        _fns[key] = fn
    return fn


def check(err: int, lib_name: str):
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point of
    ``lib<lib_name>.so``."""
    if err != 0:
        msg = load(lib_name).fg_error_string(err).decode()
        raise RuntimeError(f"{lib_name}: CUDA error {err} ({msg})")
