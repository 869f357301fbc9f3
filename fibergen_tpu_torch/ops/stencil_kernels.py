"""Staggered-grid stencil kernels of the CG hot path, with their plain twins.

Counterpart of fibergen_tpu/ops/pallas_kernels.py and pallas_sweep.py:

* K1 :func:`stress_div_beta` (``csrc/stress_div_beta.cu``):
  ``p = r + beta p_prev``; ``f = div_staggered((C(x) - C0) : p)``.  With
  ``p_prev=None`` (init mode) ``f = div_staggered((C(x) - C0) : r)``.
  ``want_tau_sum`` (tau-sum mode) also returns the per-component grid sum
  of ``tau = (C(x) - C0) : p``, the viscosity Delta scheme's mean.
* K2 :func:`eps_from_u_dot` (``csrc/eps_from_u_dot.cu``):
  ``w = E + sym grad_staggered(u)``, with ``p`` also the raw Voigt-weighted
  sum ``sum p : (p - w)`` (the CG denominator times nxyz).  With ``mu_x``
  (Delta mode) ``w += 2 tau2c (mu(x) - mu0) p`` before the sum.

A wrapper given CPU tensors computes the plain twin (``*_plain``); given
CUDA tensors it launches the kernel or raises.  ``launches`` counts kernel
launches only.
"""
from __future__ import annotations

import ctypes

import torch

from ..core import voigt
from ..materials.mixing import stress_diff_iso
from . import _build, staggered

launches = {"stress_div_beta": 0, "eps_from_u_dot": 0}

_VP = ctypes.c_void_p
_D = ctypes.c_double
_I = ctypes.c_int
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _beta_value(beta):
    """beta as a tensor: a 0-d tensor, or (gamma, gamma_prev) -> ratio."""
    if isinstance(beta, tuple):
        return beta[0] / beta[1]
    return beta


# ----------------------------------------------------------- plain twins

def stress_div_beta_plain(grid, r, p_prev, beta, mu_x, lam_x, mu0, lam0,
                          want_tau_sum=False):
    """Plain PyTorch K1.  Returns (f, p), plus the (6,) tau sum (added in
    float64) with ``want_tau_sum``; p is None in init mode."""
    p = r if p_prev is None else r + _beta_value(beta) * p_prev
    tau = stress_diff_iso(p, mu_x, lam_x, mu0, lam0)
    out = (staggered.div_staggered(grid, tau),
           None if p_prev is None else p)
    if want_tau_sum:
        out += (tau.sum(dim=(-3, -2, -1), dtype=torch.float64).to(r.dtype),)
    return out


def eps_from_u_dot_plain(grid, E, u, p=None, mu_x=None, tau2c=0.0, mu0=0.0):
    """Plain PyTorch K2.  Returns (w, dot_raw); dot_raw is None without p."""
    w = staggered.eps_staggered(grid, E, u)
    if mu_x is not None:
        if p is None:
            raise ValueError("the Delta term reads p: pass p with mu_x")
        w = w + (2.0 * tau2c) * (mu_x - mu0) * p
    if p is None:
        return w, None
    wv = torch.as_tensor(voigt.weights(6), dtype=p.dtype,
                         device=p.device).reshape(6, 1, 1, 1)
    return w, (p * wv * (p - w)).sum()


# ------------------------------------------------------------- launchers

def _check(name, t, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _hs(grid):
    return tuple(float(h) for h in staggered.hs(grid))


def stress_div_beta(grid, r, p_prev, beta, mu_x, lam_x, mu0, lam0,
                    want_tau_sum=False):
    """K1.  ``beta`` is a 0-d tensor or a ``(gamma, gamma_prev)`` pair of
    0-d tensors on the fields' device; ``mu0``/``lam0`` are numbers.
    Returns (f, p) with p None in init mode (``p_prev=None``), plus the (6,)
    grid sum of tau with ``want_tau_sum``."""
    if r.device.type == "cpu":
        return stress_div_beta_plain(grid, r, p_prev, beta, mu_x, lam_x,
                                     mu0, lam0, want_tau_sum)
    if r.device.type != "cuda":
        raise ValueError(f"unsupported device {r.device}")
    dt, dev = r.dtype, r.device
    if dt not in _SUFFIX:
        raise TypeError(f"stress_div_beta takes float32/float64, got {dt}")
    shape = (6,) + grid.shape
    _check("r", r, shape, dt, dev)
    _check("mu_x", mu_x, grid.shape, dt, dev)
    _check("lam_x", lam_x, grid.shape, dt, dev)
    f = torch.empty((3,) + grid.shape, dtype=dt, device=dev)
    if p_prev is None:
        p = None
        ptrs = (None, None, None, None)
    else:
        _check("p_prev", p_prev, shape, dt, dev)
        if isinstance(beta, tuple):
            bnum, bden = beta
            _check("gamma", bnum, (), dt, dev)
            _check("gamma_prev", bden, (), dt, dev)
        else:
            bnum, bden = beta, None
            _check("beta", bnum, (), dt, dev)
        p = torch.empty(shape, dtype=dt, device=dev)
        ptrs = (p_prev.data_ptr(), bnum.data_ptr(),
                None if bden is None else bden.data_ptr(), p.data_ptr())
    part = ts = None
    if want_tau_sum:
        npart = _build.function("stress_div_beta", "stress_div_beta_partials",
                                ctypes.c_longlong, [_I, _I, _I])(
            grid.nx, grid.ny, grid.nz)
        part = torch.empty(6 * npart, dtype=torch.float64, device=dev)
        ts = torch.empty(6, dtype=dt, device=dev)
    fn = _build.function("stress_div_beta", "stress_div_beta_" + _SUFFIX[dt],
                         ctypes.c_int,
                         [_VP, _VP, _VP, _VP, _VP, _VP, _D, _D, _D, _D, _D,
                          _I, _I, _I, _VP, _VP, _VP, _VP, _VP])
    hx, hy, hz = _hs(grid)
    err = fn(r.data_ptr(), ptrs[0], ptrs[1], ptrs[2], mu_x.data_ptr(),
             lam_x.data_ptr(), float(mu0), float(lam0), hx, hy, hz,
             grid.nx, grid.ny, grid.nz, f.data_ptr(), ptrs[3],
             None if part is None else part.data_ptr(),
             None if ts is None else ts.data_ptr(), _stream(dev))
    _build.check(err, "stress_div_beta")
    launches["stress_div_beta"] += 1
    return (f, p, ts) if want_tau_sum else (f, p)


def eps_from_u_dot(grid, E, u, p=None, mu_x=None, tau2c=0.0, mu0=0.0):
    """K2.  ``E`` is a (6,) tensor on the fields' device.  Returns
    (w, dot_raw) with dot_raw a 0-d tensor, or None without ``p``.  With
    ``mu_x`` (Delta mode; ``p`` required) ``w`` gains
    ``2 tau2c (mu_x - mu0) p``; ``tau2c``/``mu0`` are numbers."""
    if u.device.type == "cpu":
        return eps_from_u_dot_plain(grid, E, u, p, mu_x, tau2c, mu0)
    if u.device.type != "cuda":
        raise ValueError(f"unsupported device {u.device}")
    dt, dev = u.dtype, u.device
    if dt not in _SUFFIX:
        raise TypeError(f"eps_from_u_dot takes float32/float64, got {dt}")
    _check("u", u, (3,) + grid.shape, dt, dev)
    _check("E", E, (6,), dt, dev)
    w = torch.empty((6,) + grid.shape, dtype=dt, device=dev)
    if mu_x is not None:
        if p is None:
            raise ValueError("the Delta term reads p: pass p with mu_x")
        _check("mu_x", mu_x, grid.shape, dt, dev)
    if p is None:
        pp = part = dot = None
    else:
        _check("p", p, (6,) + grid.shape, dt, dev)
        npart = _build.function("eps_from_u_dot", "eps_from_u_dot_partials",
                                ctypes.c_longlong, [_I, _I, _I])(
            grid.nx, grid.ny, grid.nz)
        part = torch.empty(npart, dtype=torch.float64, device=dev)
        dot = torch.empty((), dtype=dt, device=dev)
        pp = p.data_ptr()
    fn = _build.function("eps_from_u_dot", "eps_from_u_dot_" + _SUFFIX[dt],
                         ctypes.c_int, [_VP, _VP, _VP, _VP, _D, _D, _D, _D, _D,
                                        _I, _I, _I, _VP, _VP, _VP, _VP])
    hx, hy, hz = _hs(grid)
    err = fn(u.data_ptr(), E.data_ptr(), pp,
             None if mu_x is None else mu_x.data_ptr(), float(tau2c),
             float(mu0), hx, hy, hz, grid.nx, grid.ny, grid.nz, w.data_ptr(),
             None if part is None else part.data_ptr(),
             None if dot is None else dot.data_ptr(), _stream(dev))
    _build.check(err, "eps_from_u_dot")
    launches["eps_from_u_dot"] += 1
    return w, dot
