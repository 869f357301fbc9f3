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

Halo mode (``halo=``): the kernel runs on one x-slab of a sharded field
(``parallel/``; the JAX package's ``axis_name`` variants) and reads the x
neighbours of its first and last plane from the neighbouring slabs' planes
(``comm.halo_x``); ``grid`` stays the whole grid.  K1 takes
``halo=((r, p_prev, mu, lam) minus planes, (...) plus planes)`` (p_prev
planes None in init mode), K2 ``halo=(u minus plane, u plus plane)``.

A wrapper given CPU tensors computes the plain twin (``*_plain``); given
CUDA tensors it launches the kernel or raises, with the tensors' device
current.  ``launches`` counts kernel launches only.  ``out=`` hands K1 the
tensor for its f and K2 the one for its w (a contiguous field, such as row
b of a batch: the batched CG writes each case's force straight into the
batched chain's input); the plain twins copy their result there.
"""
from __future__ import annotations

import ctypes

import torch

from ..core import voigt
from ..materials.mixing import stress_diff_iso
from ..parallel import comm
from . import _build, staggered

launches = {"stress_div_beta": 0, "eps_from_u_dot": 0,
            "stress_div_beta_halo": 0, "eps_from_u_dot_halo": 0}

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
                          want_tau_sum=False, halo=None):
    """Plain PyTorch K1.  Returns (f, p), plus the (6,) tau sum (added in
    float64) with ``want_tau_sum``; p is None in init mode.  With ``halo``
    the stencil runs on the slab with its halo planes attached."""
    if halo is not None:
        (rm, pm, mum, lm), (rq, pq, muq, lq) = halo
        cat = lambda m, a, q: torch.cat([m, a, q], dim=-3)
        nxl = r.shape[-3]
        r, mu_x, lam_x = cat(rm, r, rq), cat(mum, mu_x, muq), cat(lm, lam_x, lq)
        if p_prev is not None:
            p_prev = cat(pm, p_prev, pq)
    p = r if p_prev is None else r + _beta_value(beta) * p_prev
    tau = stress_diff_iso(p, mu_x, lam_x, mu0, lam0)
    f = staggered.div_staggered(grid, tau)
    if halo is not None:
        f, p, tau = (t.narrow(-3, 1, nxl).contiguous() for t in (f, p, tau))
    out = (f, None if p_prev is None else p)
    if want_tau_sum:
        out += (tau.sum(dim=(-3, -2, -1), dtype=torch.float64).to(r.dtype),)
    return out


def eps_from_u_dot_plain(grid, E, u, p=None, mu_x=None, tau2c=0.0, mu0=0.0,
                         halo=None):
    """Plain PyTorch K2.  Returns (w, dot_raw); dot_raw is None without p.
    With ``halo`` the gradient runs on the slab with its halo planes
    attached."""
    w = staggered.eps_staggered(grid, E, u, halo=halo)
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


def _slab_shape(grid, t, halo):
    """(nx, ny, nz) of the voxels a kernel runs on: the grid's, or an
    x-slab's (any number of planes) in halo mode."""
    nx = t.shape[-3] if halo is not None else grid.nx
    return (nx, grid.ny, grid.nz)


def _halo_ptrs(planes, shapes, dt, dev):
    """A host array of the halo planes' device pointers, each checked
    against its shape; a shape of None takes no plane (a null pointer)."""
    ptrs = []
    half = len(planes) // 2
    for name, t, shape in zip(["minus"] * half + ["plus"] * half, planes,
                              shapes):
        if shape is None:
            ptrs.append(None)
            continue
        if t is None:
            raise ValueError(f"halo mode needs the {name} halo plane of "
                             f"shape {shape}")
        _check(f"{name} halo plane", t, shape, dt, dev)
        ptrs.append(t.data_ptr())
    return (_VP * len(ptrs))(*ptrs)


def _into(res, out):
    """A plain twin's result tuple with its first entry copied into
    ``out`` (as it is without one)."""
    if out is None:
        return res
    return (out.copy_(res[0]),) + tuple(res[1:])


def stress_div_beta(grid, r, p_prev, beta, mu_x, lam_x, mu0, lam0,
                    want_tau_sum=False, halo=None, out=None):
    """K1.  ``beta`` is a 0-d tensor or a ``(gamma, gamma_prev)`` pair of
    0-d tensors on the fields' device; ``mu0``/``lam0`` are numbers.
    Returns (f, p) with p None in init mode (``p_prev=None``), plus the (6,)
    grid sum of tau with ``want_tau_sum``; f is written into ``out`` when
    given.  ``halo``: see the module."""
    if r.device.type == "cpu":
        return _into(stress_div_beta_plain(grid, r, p_prev, beta, mu_x,
                                           lam_x, mu0, lam0, want_tau_sum,
                                           halo), out)
    if r.device.type != "cuda":
        raise ValueError(f"unsupported device {r.device}")
    dt, dev = r.dtype, r.device
    if dt not in _SUFFIX:
        raise TypeError(f"stress_div_beta takes float32/float64, got {dt}")
    vox = _slab_shape(grid, r, halo)
    shape = (6,) + vox
    _check("r", r, shape, dt, dev)
    _check("mu_x", mu_x, vox, dt, dev)
    _check("lam_x", lam_x, vox, dt, dev)
    hptr = None
    if halo is not None:
        (rm, pm, mum, lm), (rq, pq, muq, lq) = halo
        plane6, plane1 = (6, 1) + vox[1:], (1,) + vox[1:]
        pshape = None if p_prev is None else plane6
        hptr = _halo_ptrs((rm, pm, mum, lm, rq, pq, muq, lq),
                          (plane6, pshape, plane1, plane1) * 2, dt, dev)
    if out is None:
        f = torch.empty((3,) + vox, dtype=dt, device=dev)
    else:
        _check("out", out, (3,) + vox, dt, dev)
        f = out
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
                                ctypes.c_longlong, [_I, _I, _I])(*vox)
        part = torch.empty(6 * npart, dtype=torch.float64, device=dev)
        ts = torch.empty(6, dtype=dt, device=dev)
    fn = _build.function("stress_div_beta", "stress_div_beta_" + _SUFFIX[dt],
                         ctypes.c_int,
                         [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _D, _D, _D, _D,
                          _D, _I, _I, _I, _VP, _VP, _VP, _VP, _VP])
    hx, hy, hz = _hs(grid)
    with torch.cuda.device(dev):
        err = fn(r.data_ptr(), ptrs[0], ptrs[1], ptrs[2], mu_x.data_ptr(),
                 lam_x.data_ptr(), hptr, float(mu0), float(lam0), hx, hy, hz,
                 *vox, f.data_ptr(), ptrs[3],
                 None if part is None else part.data_ptr(),
                 None if ts is None else ts.data_ptr(), _stream(dev))
    _build.check(err, "stress_div_beta")
    launches["stress_div_beta" if halo is None else "stress_div_beta_halo"] \
        += 1
    return (f, p, ts) if want_tau_sum else (f, p)


def eps_from_u_dot(grid, E, u, p=None, mu_x=None, tau2c=0.0, mu0=0.0,
                   halo=None, out=None):
    """K2.  ``E`` is a (6,) tensor on the fields' device.  Returns
    (w, dot_raw) with dot_raw a 0-d tensor, or None without ``p``; w is
    written into ``out`` when given.  With ``mu_x`` (Delta mode; ``p``
    required) ``w`` gains ``2 tau2c (mu_x - mu0) p``; ``tau2c``/``mu0`` are
    numbers.  ``halo``: see the module (the dot is then this slab's
    sum)."""
    if u.device.type == "cpu":
        return _into(eps_from_u_dot_plain(grid, E, u, p, mu_x, tau2c, mu0,
                                          halo), out)
    if u.device.type != "cuda":
        raise ValueError(f"unsupported device {u.device}")
    dt, dev = u.dtype, u.device
    if dt not in _SUFFIX:
        raise TypeError(f"eps_from_u_dot takes float32/float64, got {dt}")
    vox = _slab_shape(grid, u, halo)
    _check("u", u, (3,) + vox, dt, dev)
    _check("E", E, (6,), dt, dev)
    hptr = None
    if halo is not None:
        plane3 = (3, 1) + vox[1:]
        hptr = _halo_ptrs(tuple(halo), (plane3, plane3), dt, dev)
    if out is None:
        w = torch.empty((6,) + vox, dtype=dt, device=dev)
    else:
        _check("out", out, (6,) + vox, dt, dev)
        w = out
    if mu_x is not None:
        if p is None:
            raise ValueError("the Delta term reads p: pass p with mu_x")
        _check("mu_x", mu_x, vox, dt, dev)
    if p is None:
        pp = part = dot = None
    else:
        _check("p", p, (6,) + vox, dt, dev)
        npart = _build.function("eps_from_u_dot", "eps_from_u_dot_partials",
                                ctypes.c_longlong, [_I, _I, _I])(*vox)
        part = torch.empty(npart, dtype=torch.float64, device=dev)
        dot = torch.empty((), dtype=dt, device=dev)
        pp = p.data_ptr()
    fn = _build.function("eps_from_u_dot", "eps_from_u_dot_" + _SUFFIX[dt],
                         ctypes.c_int, [_VP, _VP, _VP, _VP, _VP, _D, _D, _D,
                                        _D, _D, _I, _I, _I, _VP, _VP, _VP,
                                        _VP])
    hx, hy, hz = _hs(grid)
    with torch.cuda.device(dev):
        err = fn(u.data_ptr(), E.data_ptr(), pp,
                 None if mu_x is None else mu_x.data_ptr(), hptr,
                 float(tau2c), float(mu0), hx, hy, hz, *vox, w.data_ptr(),
                 None if part is None else part.data_ptr(),
                 None if dot is None else dot.data_ptr(), _stream(dev))
    _build.check(err, "eps_from_u_dot")
    launches["eps_from_u_dot" if halo is None else "eps_from_u_dot_halo"] \
        += 1
    return w, dot


# ------------------------------------------------- on the x-slabs (#11)

def stress_div_beta_slabs(grid, r, p_prev, beta, mu_x, lam_x, mu0, lam0,
                          mod_halo=None, want_tau_sum=False):
    """K1 in halo mode on every x-slab of a sharded field (lists of slabs;
    the JAX package's stress_div_beta_staggered / stress_div_staggered with
    ``axis_name``).  The halo planes of r and p_prev are exchanged here;
    ``mod_halo`` holds those of mu_x and lam_x (``comm.halo_x`` of each,
    exchanged once per solve; here when None).  ``beta``: one entry per slab
    (a 0-d tensor or a (gamma, gamma_prev) pair), None in init mode.
    Returns (f slabs, p slabs or None), plus with ``want_tau_sum`` the (6,)
    grid sum of tau: the slabs' sums added in slab order (``comm.psum``),
    on every slab's device."""
    d = len(r)
    rm, rq = comm.halo_x(r)
    pm, pq = ([None] * d, [None] * d) if p_prev is None else \
        comm.halo_x(p_prev)
    (mum, muq), (lm, lq) = mod_halo or (comm.halo_x(mu_x),
                                        comm.halo_x(lam_x))
    out = [stress_div_beta(grid, r[i], None if p_prev is None else p_prev[i],
                           None if beta is None else beta[i], mu_x[i],
                           lam_x[i], mu0, lam0, want_tau_sum=want_tau_sum,
                           halo=((rm[i], pm[i], mum[i], lm[i]),
                                 (rq[i], pq[i], muq[i], lq[i])))
           for i in range(d)]
    res = ([o[0] for o in out],
           None if p_prev is None else [o[1] for o in out])
    if want_tau_sum:
        res += (comm.psum([o[2] for o in out]),)
    return res


def eps_from_u_dot_slabs(grid, E, u, p=None, mu_x=None, tau2c=0.0, mu0=0.0):
    """K2 in halo mode on every x-slab of a sharded field (the JAX package's
    eps_from_u_staggered / eps_from_u_dot_staggered with ``axis_name``):
    the halo planes of u are exchanged here; ``E`` is a list with one (6,)
    tensor per slab; ``mu_x`` (Delta mode) the slabs of mu(x), which the
    voxel-local Delta term reads without halo planes.  Returns (w slabs,
    the dot as ``comm.psum`` of the slabs' sums, or None without ``p``)."""
    um, uq = comm.halo_x(u)
    out = [eps_from_u_dot(grid, E[i], u[i], None if p is None else p[i],
                          mu_x=None if mu_x is None else mu_x[i],
                          tau2c=tau2c, mu0=mu0, halo=(um[i], uq[i]))
           for i in range(len(u))]
    w = [o[0] for o in out]
    return w, None if p is None else comm.psum([o[1] for o in out])
