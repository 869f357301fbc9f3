"""Staggered G0 chains u = irfftn(G0 rfftn(f)), with their plain twins.

Counterpart of fibergen_tpu/ops/pallas_chain.py (``_middle`` with
``_g0_apply`` or ``_g0_heat_apply`` and the z stages around it).  Both
chains are instantiations of one templated CUDA chain
(``csrc/g0_staggered_chain.cu``) that computes hand-written transforms
around a G0 apply on the rfft half-spectrum:

* K3 :func:`g0_staggered_chain`, a real 3-component force field f of shape
  (3, nx, ny, nz):  eta = c1 f - c2 (f . k+) conj(k+),  c1 = c10/|k|^2,
  c2 = c20/|k|^4;
* K4 :func:`g0_staggered_heat_chain`, a real 1-component source field of
  shape (1, nx, ny, nz):  eta = c10 f / |k|^2;

with k+ = sin(xi)/h e^{i xi} per axis and the DC bin zeroed.  The tables
come from :func:`staggered_tables` in natural rfft bin order; transforms
are norm="forward" like ``ops/fft.py``.

A wrapper given CPU tensors computes the plain twin (``torch.fft`` and
:func:`g0_staggered_apply_plain`); given CUDA tensors it launches the kernel
or raises.  ``launches`` counts kernel launches only.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build, fft

launches = {"g0_staggered_chain": 0, "g0_staggered_heat_chain": 0}

_COMPLEX = {torch.float32: torch.complex64, torch.float64: torch.complex128}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_tables: dict = {}
_twiddles: dict = {}


def staggered_tables(grid, dtype, device):
    """Per-axis tables (3, n_a) with rows (Re k+, Im k+, |k+|^2) for the x,
    y and half-spectrum z axes (fibergen.cpp:19838-19877), built in float64
    and cast to the real ``dtype``; cached per grid, dtype and device."""
    key = (grid, dtype, torch.device(device))
    t = _tables.get(key)
    if t is None:
        xis = grid.xi_staggered()
        hs = grid.staggered_h()
        t = []
        for xi, h in zip(xis, hs):
            xi = np.reshape(np.asarray(xi, np.float64), (-1,))
            s = np.sin(xi) / h
            kp = s * np.exp(1j * xi)
            rows = np.stack([kp.real, kp.imag, s * s])
            t.append(torch.as_tensor(rows, dtype=dtype, device=device)
                     .contiguous())
        t = tuple(t)
        _tables[key] = t
    return t


def _twiddle(n, dtype, device):
    """exp(-2 pi i t / n), t = 0..n-1, built in float64, complex ``dtype``."""
    key = (n, dtype, torch.device(device))
    t = _twiddles.get(key)
    if t is None:
        w = np.exp(-2j * np.pi * np.arange(n) / n)
        t = torch.as_tensor(w, dtype=dtype, device=device)
        _twiddles[key] = t
    return t


def _n2_dc(tables):
    """|k+|^2 on the half-spectrum and the DC-bin indicator."""
    tx, ty, tz = tables
    n2 = tx[2].reshape(-1, 1, 1) + ty[2].reshape(-1, 1) + tz[2]
    dc = torch.zeros_like(n2)
    dc[0, 0, 0] = 1.0
    return n2, dc


def g0_staggered_apply_plain(f_hat, tables, c10, c20):
    """Plain PyTorch G0 apply on the half-spectrum (out of place)."""
    tx, ty, tz = tables
    kp = (torch.complex(tx[0], tx[1]).reshape(-1, 1, 1),
          torch.complex(ty[0], ty[1]).reshape(-1, 1),
          torch.complex(tz[0], tz[1]))
    n2, dc = _n2_dc(tables)
    n2s = n2 + dc          # regularizes the n2 = 0 DC bin
    ndc = 1.0 - dc         # zeroes the output there
    c1 = c10 * ndc / n2s
    c2 = c20 * ndc / (n2s * n2s)
    c2_fkp = c2 * (f_hat[0] * kp[0] + f_hat[1] * kp[1] + f_hat[2] * kp[2])
    return torch.stack([c1 * f_hat[j] - c2_fkp * torch.conj(kp[j])
                        for j in range(3)])


def g0_staggered_heat_apply_plain(f_hat, tables, c10):
    """Plain PyTorch scalar G0 apply c10 f / |k+|^2, DC zeroed, on a
    (1, nx, ny, nz//2+1) half-spectrum (out of place)."""
    n2, dc = _n2_dc(tables)
    return (c10 * (1.0 - dc) / (n2 + dc)) * f_hat


def g0_staggered_chain_plain(grid, f, c10, c20):
    """Plain PyTorch K3: irfftn(G0 apply(rfftn f))."""
    tables = staggered_tables(grid, f.dtype, f.device)
    return fft.ifftn(g0_staggered_apply_plain(fft.fftn(f), tables, c10, c20),
                     grid.shape)


def g0_staggered_heat_chain_plain(grid, f, c10):
    """Plain PyTorch K4: irfftn(scalar G0 apply(rfftn f))."""
    tables = staggered_tables(grid, f.dtype, f.device)
    return fft.ifftn(g0_staggered_heat_apply_plain(fft.fftn(f), tables, c10),
                     grid.shape)


def _chain(name, grid, f, ncomp, consts):
    """Launch the CUDA chain ``name`` on a real (ncomp, nx, ny, nz)
    contiguous ``f`` with the G0 constants ``consts``; returns u."""
    if f.device.type != "cuda":
        raise ValueError(f"unsupported device {f.device}")
    if f.dtype not in _SUFFIX:
        raise TypeError(f"{name} takes float32/float64, got {f.dtype}")
    shape = (ncomp,) + grid.shape
    if tuple(f.shape) != shape:
        raise ValueError(f"f has shape {tuple(f.shape)}, expected {shape}")
    if not f.is_contiguous():
        raise ValueError("f must be contiguous")
    cdt = _COMPLEX[f.dtype]
    tx, ty, tz = staggered_tables(grid, f.dtype, f.device)
    twx, twy, twz = (_twiddle(n, cdt, f.device) for n in grid.shape)
    spec = torch.empty((ncomp,) + grid.rshape, dtype=cdt, device=f.device)
    out = torch.empty_like(f)
    vp = ctypes.c_void_p
    fn = _build.function(
        "g0_staggered_chain", f"{name}_{_SUFFIX[f.dtype]}", ctypes.c_int,
        [vp] * 9 + [ctypes.c_double] * len(consts) + [ctypes.c_int] * 3
        + [vp])
    err = fn(f.data_ptr(), spec.data_ptr(), out.data_ptr(), tx.data_ptr(),
             ty.data_ptr(), tz.data_ptr(), twx.data_ptr(), twy.data_ptr(),
             twz.data_ptr(), *(float(c) for c in consts), grid.nx, grid.ny,
             grid.nz, torch.cuda.current_stream(f.device).cuda_stream)
    _build.check(err, "g0_staggered_chain")
    launches[name] += 1
    return out


def g0_staggered_chain(grid, f, c10, c20):
    """K3: u = irfftn(G0 rfftn f) for a real (3, nx, ny, nz) contiguous
    ``f``; returns a new field.  ``c10``/``c20`` are numbers."""
    if f.device.type == "cpu":
        return g0_staggered_chain_plain(grid, f, c10, c20)
    return _chain("g0_staggered_chain", grid, f, 3, (c10, c20))


def g0_staggered_heat_chain(grid, f, c10):
    """K4: u = irfftn(c10/|k+|^2 rfftn f) for a real (1, nx, ny, nz)
    contiguous ``f``; returns a new field.  ``c10`` is a number."""
    if f.device.type == "cpu":
        return g0_staggered_heat_chain_plain(grid, f, c10)
    return _chain("g0_staggered_heat_chain", grid, f, 1, (c10,))
