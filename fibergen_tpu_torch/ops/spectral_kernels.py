"""Spectral chains u = irfftn(apply(rfftn(f))), with their plain twins.

Counterpart of fibergen_tpu/ops/pallas_chain.py (``_middle`` with an apply
and the z stages around it).  Every chain is an instantiation of one
templated CUDA chain (``csrc/g0_staggered_chain.cu``) that computes
hand-written transforms around an apply on the rfft half-spectrum:

* K3 :func:`g0_staggered_chain`, a real 3-component force field f of shape
  (3, nx, ny, nz):  eta = c1 f - c2 (f . k+) conj(k+),  c1 = c10/|k|^2,
  c2 = c20/|k|^4;
* K4 :func:`g0_staggered_heat_chain`, a real 1-component source field of
  shape (1, nx, ny, nz):  eta = c10 f / |k|^2;

with k+ = sin(xi)/h e^{i xi} per axis and the DC bin zeroed (tables from
:func:`staggered_tables`);

* K5 :func:`gamma_collocated_chain`, the collocated Gamma on a 6-component
  strain field (A/|xi|^2 and B/|xi|^4 terms) or a 3-component gradient
  field (A/|xi|^2 term), plus beta tau, with the DC bin set to E; and
  :func:`gamma_collocated_hyper_chain`, its nonsymmetric finite-strain form
  on a 9-component deformation-gradient field;
* K6 :func:`gamma_collocated_zt_chain`, the zero-trace form on a traceless
  6-component field: components 1..5 are transformed, component 0 is
  -(c1 + c2) in the spectrum and in real space;

with real xi = f/d per axis (tables from :func:`collocated_tables`).
Tables are in natural rfft bin order; transforms are norm="forward" like
``ops/fft.py``.

The ``*_chain_batched`` forms run a chain on B right-hand sides at once, a
real contiguous (B, C, nx, ny, nz) batch (the JAX package's ``_middle``
under ``jax.vmap``, whose batching rule adds B to its grid): one launch of
each of the five passes for the whole batch, each case with its own DC
vector E (a (B, C) table, or one C-vector for all), bitwise the B single
chains on the card; the single chains are the batch of one.  Their plain
twins (``*_batched_plain``) transform the batch in one ``torch.fft`` call
each way around the single twins' applies.

The ``*_chain_slab`` forms run a chain on the x-slabs of a sharded field
(``parallel/``; the kz-slab chain of pallas_chain._run_middle_slab): each
x-slab's lines are z-transformed, the spectrum moves to kz-slabs
(``comm.to_kz``), the y and x passes and the apply run there on whole (x, y)
planes (the apply reads the global kz bin, so only the slab holding kz = 0
sets the DC bin), the spectrum moves back (``comm.from_kz``) and each
x-slab's lines are z-inverted.

A wrapper given CPU tensors computes the plain twin (``torch.fft`` around
the plain apply, ``*_apply_plain``); given CUDA tensors it launches the
kernel or raises, with the tensors' device current.  ``launches`` counts
kernel launches only (a slab chain counts each of its per-slab z, middle
and z-inverse launches, a batched chain one launch for the batch); K5
counts every component count (6, 3 and 9) under one name, and its slab and
batched forms under others.  ``calls`` counts the applications of each
chain wrapper, by (wrapper, components), on any device
(LSSolver.get_fft_time reads it); a batched wrapper's call counts once.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..parallel import comm, slabs
from ..parallel.fft import slab_irfftn, slab_rfftn
from . import _build, fft

launches = {"g0_staggered_chain": 0, "g0_staggered_heat_chain": 0,
            "gamma_collocated_chain": 0, "gamma_collocated_zt_chain": 0,
            "g0_staggered_chain_batched": 0,
            "g0_staggered_heat_chain_batched": 0,
            "gamma_collocated_chain_batched": 0,
            "gamma_collocated_zt_chain_batched": 0,
            "g0_staggered_chain_slab": 0, "g0_staggered_heat_chain_slab": 0,
            "gamma_collocated_chain_slab": 0,
            "gamma_collocated_zt_chain_slab": 0}

# applications of each chain (a kernel launch or a plain twin's call), by
# (wrapper name, components)
calls: dict = {}

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


def collocated_tables(grid, dtype, device):
    """Per-axis real wavenumbers xi_a = f_a / d_a of the x, y and
    half-spectrum z axes (Grid.xi), built in float64 and cast to the real
    ``dtype``; cached per grid, dtype and device."""
    key = ("collocated", grid, dtype, torch.device(device))
    t = _tables.get(key)
    if t is None:
        t = tuple(torch.as_tensor(np.reshape(np.asarray(x, np.float64), (-1,)),
                                  dtype=dtype, device=device).contiguous()
                  for x in grid.xi())
        _tables[key] = t
    return t


# The register-resident line FFT of the chain passes (csrc/
# g0_staggered_chain.cu, plan_v / plan_radix): a line of power-of-two
# length n, 16 <= n <= 512, is held by n / V threads of V values each and
# transformed in Stockham stages of the given radices (each dividing V),
# one exchange through shared memory between two stages.  Other lengths
# take the shared-memory radix-4 FFT or the direct DFT.
LINE_PLANS = {16: (4, (4, 4)), 32: (8, (8, 4)), 64: (8, (8, 8)),
              128: (16, (16, 8)), 256: (16, (16, 16)), 512: (8, (8, 8, 8))}


def plan_twiddles(n):
    """The twiddles of the register FFT of length ``n`` (a key of
    LINE_PLANS), complex128: for each stage s >= 1, with Ns the product of
    the earlier radices and R its own, W_{Ns R}^{r k} = exp(-2 pi i r k /
    (Ns R)) at (r - 1) Ns + k for r = 1..R-1, k = 0..Ns-1; the stages one
    after another."""
    radices = LINE_PLANS[n][1]
    parts, ns = [], radices[0]
    for r in radices[1:]:
        rk = np.arange(1, r)[:, None] * np.arange(ns)[None, :]
        parts.append(np.exp(-2j * np.pi * rk / (ns * r)).reshape(-1))
        ns *= r
    return np.concatenate(parts)


def _twiddle(n, dtype, device):
    """The twiddle table of a length-``n`` axis, built in float64, complex
    ``dtype``: :func:`plan_twiddles` for a length of LINE_PLANS (the
    register FFT), else exp(-2 pi i t / n), t = 0..n-1."""
    key = (n, dtype, torch.device(device))
    t = _twiddles.get(key)
    if t is None:
        w = plan_twiddles(n) if n in LINE_PLANS else \
            np.exp(-2j * np.pi * np.arange(n) / n)
        t = torch.as_tensor(w, dtype=dtype, device=device)
        _twiddles[key] = t
    return t


def _n2_dc(tables, dc=True):
    """|k+|^2 on the half-spectrum and the DC-bin indicator (zero where the
    columns do not hold kz = 0: ``dc=False``)."""
    tx, ty, tz = tables
    n2 = tx[2].reshape(-1, 1, 1) + ty[2].reshape(-1, 1) + tz[2]
    ind = torch.zeros_like(n2)
    if dc:
        ind[0, 0, 0] = 1.0
    return n2, ind


def g0_staggered_apply_plain(f_hat, tables, c10, c20, dc=True):
    """Plain PyTorch G0 apply on the half-spectrum (out of place); on a
    kz-slab the z table holds its columns and ``dc`` says whether kz = 0 is
    among them."""
    tx, ty, tz = tables
    kp = (torch.complex(tx[0], tx[1]).reshape(-1, 1, 1),
          torch.complex(ty[0], ty[1]).reshape(-1, 1),
          torch.complex(tz[0], tz[1]))
    n2, ind = _n2_dc(tables, dc)
    n2s = n2 + ind         # regularizes the n2 = 0 DC bin
    ndc = 1.0 - ind        # zeroes the output there
    c1 = c10 * ndc / n2s
    c2 = c20 * ndc / (n2s * n2s)
    c2_fkp = c2 * (f_hat[0] * kp[0] + f_hat[1] * kp[1] + f_hat[2] * kp[2])
    return torch.stack([c1 * f_hat[j] - c2_fkp * torch.conj(kp[j])
                        for j in range(3)])


def g0_staggered_heat_apply_plain(f_hat, tables, c10, dc=True):
    """Plain PyTorch scalar G0 apply c10 f / |k+|^2, DC zeroed, on a
    (1, nx, ny, nz//2+1) half-spectrum (out of place); ``dc`` as
    :func:`g0_staggered_apply_plain`."""
    n2, ind = _n2_dc(tables, dc)
    return (c10 * (1.0 - ind) / (n2 + ind)) * f_hat


def _gamma_part(p, xis, k2, A, B):
    """Real-coefficient collocated Gamma on a list of 6 (Voigt xx yy zz yz xz
    xy), 3 or 9 (xx yy zz yz xz xy zy zx yx, the finite-strain form)
    spectrum components (green.py part functions)."""
    x0, x1, x2 = xis
    a = A / k2
    if len(p) == 3:
        c = a * (p[0] * x0 + p[1] * x1 + p[2] * x2)
        return [c * x0, c * x1, c * x2]
    if len(p) == 9:
        # rows of tau: (xx, xy, xz), (yx, yy, yz), (zx, zy, zz)
        t0 = p[0] * x0 + p[5] * x1 + p[4] * x2
        t1 = p[8] * x0 + p[1] * x1 + p[3] * x2
        t2 = p[7] * x0 + p[6] * x1 + p[2] * x2
        b = (B / (k2 * k2)) * (x0 * t0 + x1 * t1 + x2 * t2)
        return [a * x0 * t0 + b * x0 * x0, a * x1 * t1 + b * x1 * x1,
                a * x2 * t2 + b * x2 * x2, a * x2 * t1 + b * x1 * x2,
                a * x2 * t0 + b * x0 * x2, a * x1 * t0 + b * x0 * x1,
                a * x1 * t2 + b * x2 * x1, a * x0 * t2 + b * x2 * x0,
                a * x0 * t1 + b * x1 * x0]
    t0 = p[0] * x0 + p[5] * x1 + p[4] * x2
    t1 = p[5] * x0 + p[1] * x1 + p[3] * x2
    t2 = p[4] * x0 + p[3] * x1 + p[2] * x2
    b = (B / (k2 * k2)) * (x0 * t0 + x1 * t1 + x2 * t2)
    return [a * (2.0 * x0 * t0) + b * (x0 * x0),
            a * (2.0 * x1 * t1) + b * (x1 * x1),
            a * (2.0 * x2 * t2) + b * (x2 * x2),
            a * (x1 * t2 + x2 * t1) + b * (x1 * x2),
            a * (x0 * t2 + x2 * t0) + b * (x0 * x2),
            a * (x0 * t1 + x1 * t0) + b * (x0 * x1)]


def gamma_collocated_apply_plain(tau_hat, tables, A, B, E, beta, dc=True):
    """Plain PyTorch collocated Gamma on a (C, nx, ny, nz//2+1)
    half-spectrum, C = 6, 3 or 9 (out of place): eta = Gamma tau + beta tau
    with the DC bin set to E (C values); ``dc`` as
    :func:`g0_staggered_apply_plain`."""
    tx, ty, tz = tables
    E = _vector(E, tx, tau_hat.shape[0])
    xis = (tx.reshape(-1, 1, 1), ty.reshape(-1, 1), tz)
    ind = torch.zeros(tau_hat.shape[1:], dtype=tx.dtype, device=tx.device)
    if dc:
        ind[0, 0, 0] = 1.0
    k2 = xis[0] * xis[0] + xis[1] * xis[1] + xis[2] * xis[2] + ind
    eta = torch.stack(_gamma_part(list(tau_hat), xis, k2, A, B))
    eta = eta + beta * tau_hat
    return eta * (1.0 - ind) + E.reshape(-1, 1, 1, 1) * ind


def _real_z_planes(y, nz, koff=0):
    """The kz = 0 plane (and the kz = nz/2 plane of an even nz) made
    Hermitian in (kx, ky): the part of it that a c2r transform keeps when it
    drops the imaginary parts of those z bins.  A spectrum that is not
    Hermitian there (the collocated Gamma at Nyquist bins) then inverts the
    same whatever library transforms it.  On a kz-slab (columns koff..)
    only the planes it holds."""
    y = y.clone()
    for k in (0, nz // 2) if nz % 2 == 0 else (0,):
        if not 0 <= k - koff < y.shape[-1]:
            continue
        k -= koff
        p = y[..., k]
        q = torch.roll(torch.flip(p, dims=(-2, -1)), shifts=(1, 1),
                       dims=(-2, -1))
        y[..., k] = 0.5 * (p + q.conj())
    return y


def gamma_collocated_chain_plain(grid, tau, A, B, E, beta):
    """Plain PyTorch K5: irfftn(collocated Gamma apply(rfftn tau))."""
    tables = collocated_tables(grid, tau.dtype, tau.device)
    y = gamma_collocated_apply_plain(fft.fftn(tau), tables, A, B, E, beta)
    return fft.ifftn(_real_z_planes(y, grid.nz), grid.shape)


def gamma_collocated_hyper_chain_plain(grid, tau, A, B, E, beta):
    """Plain PyTorch K5 at C = 9: irfftn(finite-strain collocated Gamma
    apply(rfftn tau))."""
    return gamma_collocated_chain_plain(grid, tau, A, B, E, beta)


def gamma_collocated_zt_chain_plain(grid, tau, A, B, E, beta):
    """Plain PyTorch K6: the zero-trace transforms (components 1.. are
    transformed, component 0 is -(c1 + c2) in the spectrum and in real
    space) around the 6-component apply."""
    tables = collocated_tables(grid, tau.dtype, tau.device)
    y = gamma_collocated_apply_plain(fft.fftn_zero_trace(tau), tables, A, B,
                                     E, beta)
    return fft.ifftn_zero_trace(_real_z_planes(y, grid.nz), grid.shape)


def _vector(E, like, n):
    """E as a contiguous (n,) tensor of ``like``'s dtype and device; a
    tensor already so is returned as it is."""
    E = torch.as_tensor(E, dtype=like.dtype, device=like.device)
    E = E.reshape(-1).contiguous()
    if E.numel() != n:
        raise ValueError(f"E has {E.numel()} values, expected {n}")
    return E


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


def _applied(fn):
    """Count each call of the chain wrapper ``fn`` in ``calls`` under its
    components; the field is its second argument (its third on x-slabs; a
    batch's components its second axis)."""
    slab = fn.__name__.endswith("_slab")
    axis = 1 if fn.__name__.endswith("_batched") else 0

    @functools.wraps(fn)
    def wrapper(*args):
        f = args[2][0] if slab else args[1]
        key = (fn.__name__, int(f.shape[axis]))
        calls[key] = calls.get(key, 0) + 1
        return fn(*args)
    return wrapper


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _chain(fn_name, counter, grid, f, ncomp, tables, consts, ptrs=(),
           out=None):
    """Launch the CUDA chain entry ``fn_name`` on a real (ncomp, nx, ny, nz)
    contiguous ``f``, or its batched entry ``<fn_name>_batched`` on a (B,
    ncomp, nx, ny, nz) ``f`` whose cases are each contiguous (a case's
    stride may be larger: K6 takes components 1.. of a 6-component batch),
    with the per-axis ``tables``, the device pointers ``ptrs`` and the
    constants ``consts``; writes ``out`` (laid out as ``f``; a new
    contiguous field if None) and returns it."""
    if f.device.type != "cuda":
        raise ValueError(f"unsupported device {f.device}")
    if f.dtype not in _SUFFIX:
        raise TypeError(f"{fn_name} takes float32/float64, got {f.dtype}")
    batched = f.dim() == 5
    shape = (ncomp,) + grid.shape
    lead = tuple(f.shape[:1]) if batched else ()
    if tuple(f.shape) != lead + shape:
        raise ValueError(f"f has shape {tuple(f.shape)}, expected "
                         f"{lead + shape}")
    if out is None:
        out = torch.empty(f.shape, dtype=f.dtype, device=f.device)
    for name, t in (("f", f), ("out", out)):
        if not _cases_contiguous(t):
            raise ValueError(f"{name} must be contiguous within each case")
    cdt = _COMPLEX[f.dtype]
    tx, ty, tz = tables
    twx, twy, twz = (_twiddle(n, cdt, f.device) for n in grid.shape)
    spec = torch.empty(lead + (ncomp,) + grid.rshape, dtype=cdt,
                       device=f.device)
    vp = ctypes.c_void_p
    tail = [ctypes.c_int] * 3
    if batched:
        fn_name += "_batched"
        tail += [ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong]
    fn = _build.function(
        "g0_staggered_chain", f"{fn_name}_{_SUFFIX[f.dtype]}", ctypes.c_int,
        [vp] * (9 + len(ptrs)) + [ctypes.c_double] * len(consts) + tail
        + [vp])
    sizes = (grid.nx, grid.ny, grid.nz)
    if batched:
        sizes += (f.shape[0], f.stride(0), out.stride(0))
    with torch.cuda.device(f.device):
        err = fn(f.data_ptr(), spec.data_ptr(), out.data_ptr(),
                 tx.data_ptr(), ty.data_ptr(), tz.data_ptr(), twx.data_ptr(),
                 twy.data_ptr(), twz.data_ptr(),
                 *(p.data_ptr() for p in ptrs), *(float(c) for c in consts),
                 *sizes, _stream(f.device))
    _build.check(err, "g0_staggered_chain")
    launches[counter] += 1
    return out


def _cases_contiguous(t):
    """Whether each case of a (B, C, nx, ny, nz) batch is contiguous and
    the cases do not overlap (a field: whether it is contiguous)."""
    if t.dim() != 5:
        return t.is_contiguous()
    per = t[0].numel()
    return t[0].is_contiguous() and (t.shape[0] == 1 or t.stride(0) >= per)


@_applied
def g0_staggered_chain(grid, f, c10, c20):
    """K3: u = irfftn(G0 rfftn f) for a real (3, nx, ny, nz) contiguous
    ``f``; returns a new field.  ``c10``/``c20`` are numbers."""
    if f.device.type == "cpu":
        return g0_staggered_chain_plain(grid, f, c10, c20)
    return _chain("g0_staggered_chain", "g0_staggered_chain", grid, f, 3,
                  staggered_tables(grid, f.dtype, f.device), (c10, c20))


@_applied
def g0_staggered_heat_chain(grid, f, c10):
    """K4: u = irfftn(c10/|k+|^2 rfftn f) for a real (1, nx, ny, nz)
    contiguous ``f``; returns a new field.  ``c10`` is a number."""
    if f.device.type == "cpu":
        return g0_staggered_heat_chain_plain(grid, f, c10)
    return _chain("g0_staggered_heat_chain", "g0_staggered_heat_chain", grid,
                  f, 1, staggered_tables(grid, f.dtype, f.device), (c10,))


@_applied
def gamma_collocated_chain(grid, tau, A, B, E, beta):
    """K5: eta = irfftn(Gamma rfftn tau + beta rfftn tau), DC bin = E, for a
    real contiguous ``tau`` of shape (6, nx, ny, nz) (elasticity: A and B
    terms) or (3, nx, ny, nz) (heat, porous flow: A term; B is not read).
    ``A``, ``B``, ``beta`` are numbers, ``E`` C values (a tensor stays on
    its device: the card reads it there).  Returns a new field."""
    if tau.device.type == "cpu":
        return gamma_collocated_chain_plain(grid, tau, A, B, E, beta)
    ncomp = tau.shape[0]
    if ncomp not in (6, 3):
        raise ValueError(f"tau has {ncomp} components, expected 6 or 3")
    name = "gamma_collocated_chain" if ncomp == 6 else \
        "gamma_collocated_heat_chain"
    return _chain(name, "gamma_collocated_chain", grid, tau, ncomp,
                  collocated_tables(grid, tau.dtype, tau.device),
                  (A, B, beta), ptrs=(_vector(E, tau, ncomp),))


@_applied
def gamma_collocated_hyper_chain(grid, tau, A, B, E, beta):
    """K5 at C = 9: eta = irfftn(Gamma rfftn tau + beta rfftn tau), DC bin =
    E (9 values), for a real contiguous (9, nx, ny, nz) deformation-gradient
    field with the finite-strain (nonsymmetric) collocated Gamma.  Counts
    under K5's ``gamma_collocated_chain``.  Returns a new field."""
    if tau.device.type == "cpu":
        return gamma_collocated_hyper_chain_plain(grid, tau, A, B, E, beta)
    if tau.shape[0] != 9:
        raise ValueError(f"tau has {tau.shape[0]} components, expected 9")
    return _chain("gamma_collocated_hyper_chain", "gamma_collocated_chain",
                  grid, tau, 9, collocated_tables(grid, tau.dtype, tau.device),
                  (A, B, beta), ptrs=(_vector(E, tau, 9),))


@_applied
def gamma_collocated_zt_chain(grid, tau, A, B, E, beta):
    """K6: the zero-trace collocated Gamma of a real contiguous traceless
    ``tau`` of shape (6, nx, ny, nz): components 1..5 go through the chain
    (component 0 rebuilt as -(c1 + c2) inside the apply), the DC bin takes
    E (6 values), and out[0] = -(out[1] + out[2]).  Returns a new field."""
    if tau.device.type == "cpu":
        return gamma_collocated_zt_chain_plain(grid, tau, A, B, E, beta)
    if tau.shape[0] != 6:
        raise ValueError(f"tau has {tau.shape[0]} components, expected 6")
    if not tau.is_contiguous():
        raise ValueError("tau must be contiguous")
    out = torch.empty_like(tau)
    _chain("gamma_collocated_zt_chain", "gamma_collocated_zt_chain", grid,
           tau[1:], 5, collocated_tables(grid, tau.dtype, tau.device),
           (A, B, beta), ptrs=(_vector(E, tau, 6),), out=out[1:])
    torch.add(out[1], out[2], out=out[0]).neg_()
    return out


# ------------------------------------------- batched chains (#7 vmapped)

def _check_batch(name, f, grid, ncomp):
    """Refuse a batch the batched chains do not take: ``f`` must be a real
    contiguous (B, ncomp, nx, ny, nz) float32/float64 tensor, B >= 1."""
    if f.dtype not in _SUFFIX:
        raise TypeError(f"{name} must be float32/float64, got {f.dtype}")
    shape = (ncomp,) + grid.shape
    if f.dim() != 5 or tuple(f.shape[1:]) != shape or f.shape[0] < 1:
        raise ValueError(f"{name} has shape {tuple(f.shape)}, expected "
                         f"(B,) + {shape}")
    if not f.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _batch_vectors(E, like, n):
    """E as a contiguous (B, n) tensor of ``like``'s dtype and device (B =
    like.shape[0]): a (B, n) table, or one n-vector for every case."""
    B = like.shape[0]
    E = torch.as_tensor(E, dtype=like.dtype, device=like.device)
    if E.dim() <= 1:
        return _vector(E, like, n).expand(B, n).contiguous()
    if tuple(E.shape) != (B, n):
        raise ValueError(f"E has shape {tuple(E.shape)}, expected ({B}, {n})"
                         f" or ({n},)")
    return E.contiguous()


def _applied_each(y, apply):
    """``apply(y[b], b)`` of each case of a batched spectrum, stacked."""
    return torch.stack([apply(yb, b) for b, yb in enumerate(y)])


def g0_staggered_chain_batched_plain(grid, f, c10, c20):
    """Plain twin of :func:`g0_staggered_chain_batched`: ``torch.fft`` over
    the batch around the single twin's apply."""
    tables = staggered_tables(grid, f.dtype, f.device)
    y = _applied_each(fft.fftn(f), lambda yb, b: g0_staggered_apply_plain(
        yb, tables, c10, c20))
    return fft.ifftn(y, grid.shape)


def g0_staggered_heat_chain_batched_plain(grid, f, c10):
    """Plain twin of :func:`g0_staggered_heat_chain_batched`."""
    tables = staggered_tables(grid, f.dtype, f.device)
    y = _applied_each(fft.fftn(f), lambda yb, b: (
        g0_staggered_heat_apply_plain(yb, tables, c10)))
    return fft.ifftn(y, grid.shape)


def gamma_collocated_chain_batched_plain(grid, tau, A, B, E, beta):
    """Plain twin of :func:`gamma_collocated_chain_batched`: case b's DC
    bin takes E[b]."""
    tables = collocated_tables(grid, tau.dtype, tau.device)
    E = _batch_vectors(E, tau, tau.shape[1])
    y = _applied_each(fft.fftn(tau), lambda yb, b: (
        gamma_collocated_apply_plain(yb, tables, A, B, E[b], beta)))
    return fft.ifftn(_real_z_planes(y, grid.nz), grid.shape)


def gamma_collocated_zt_chain_batched_plain(grid, tau, A, B, E, beta):
    """Plain twin of :func:`gamma_collocated_zt_chain_batched`: the
    zero-trace transforms of each case (components 1.. transformed,
    component 0 -(c1 + c2) in the spectrum and in real space)."""
    tables = collocated_tables(grid, tau.dtype, tau.device)
    E = _batch_vectors(E, tau, 6)
    y = fft.fftn(tau[:, 1:])
    y = torch.cat([-(y[:, 0] + y[:, 1])[:, None], y], dim=1)
    y = _applied_each(y, lambda yb, b: gamma_collocated_apply_plain(
        yb, tables, A, B, E[b], beta))
    x = fft.ifftn(_real_z_planes(y, grid.nz)[:, 1:], grid.shape)
    return torch.cat([-(x[:, 0] + x[:, 1])[:, None], x], dim=1)


@_applied
def g0_staggered_chain_batched(grid, f, c10, c20):
    """K3 on B right-hand sides in one launch of each pass: u[b] =
    irfftn(G0 rfftn f[b]) for a real contiguous (B, 3, nx, ny, nz) ``f``;
    returns a new batch."""
    _check_batch("f", f, grid, 3)
    if f.device.type == "cpu":
        return g0_staggered_chain_batched_plain(grid, f, c10, c20)
    return _chain("g0_staggered_chain", "g0_staggered_chain_batched", grid,
                  f, 3, staggered_tables(grid, f.dtype, f.device), (c10, c20))


@_applied
def g0_staggered_heat_chain_batched(grid, f, c10):
    """K4 on B right-hand sides in one launch of each pass, a real
    contiguous (B, 1, nx, ny, nz) ``f``; returns a new batch."""
    _check_batch("f", f, grid, 1)
    if f.device.type == "cpu":
        return g0_staggered_heat_chain_batched_plain(grid, f, c10)
    return _chain("g0_staggered_heat_chain",
                  "g0_staggered_heat_chain_batched", grid, f, 1,
                  staggered_tables(grid, f.dtype, f.device), (c10,))


@_applied
def gamma_collocated_chain_batched(grid, tau, A, B, E, beta):
    """K5 on B right-hand sides in one launch of each pass, a real
    contiguous (B, 6, nx, ny, nz) (elasticity) or (B, 3, nx, ny, nz) (heat,
    porous flow) ``tau``; ``E`` a (B, C) table of the cases' DC values, or
    one C-vector for every case.  Returns a new batch."""
    ncomp = tau.shape[1] if tau.dim() == 5 else -1
    if ncomp not in (6, 3):
        raise ValueError(f"tau has shape {tuple(tau.shape)}, expected (B, 6,"
                         " nx, ny, nz) or (B, 3, nx, ny, nz)")
    _check_batch("tau", tau, grid, ncomp)
    Eb = _batch_vectors(E, tau, ncomp)
    if tau.device.type == "cpu":
        return gamma_collocated_chain_batched_plain(grid, tau, A, B, Eb, beta)
    name = "gamma_collocated_chain" if ncomp == 6 else \
        "gamma_collocated_heat_chain"
    return _chain(name, "gamma_collocated_chain_batched", grid, tau, ncomp,
                  collocated_tables(grid, tau.dtype, tau.device),
                  (A, B, beta), ptrs=(Eb,))


@_applied
def gamma_collocated_zt_chain_batched(grid, tau, A, B, E, beta):
    """K6 on B right-hand sides in one launch of each pass: a real
    contiguous traceless (B, 6, nx, ny, nz) ``tau``, whose components 1..5
    the chain reads in place (case stride 6 nx ny nz); ``E`` a (B, 6)
    table, or one 6-vector for every case; out[:, 0] = -(out[:, 1] +
    out[:, 2]).  Returns a new batch."""
    _check_batch("tau", tau, grid, 6)
    Eb = _batch_vectors(E, tau, 6)
    if tau.device.type == "cpu":
        return gamma_collocated_zt_chain_batched_plain(grid, tau, A, B, Eb,
                                                       beta)
    out = torch.empty_like(tau)
    _chain("gamma_collocated_zt_chain", "gamma_collocated_zt_chain_batched",
           grid, tau[:, 1:], 5, collocated_tables(grid, tau.dtype, tau.device),
           (A, B, beta), ptrs=(Eb,), out=out[:, 1:])
    torch.add(out[:, 1], out[:, 2], out=out[:, 0]).neg_()
    return out


# ------------------------------------------------ chains on x-slabs (#11)

def _kz_cols(tables, off, w):
    """The tables with the z table cut to the kz columns off..off+w-1."""
    tx, ty, tz = tables
    return tx, ty, tz[..., off:off + w]


def _slab_chain_plain(par, grid, f, apply, real_planes=False):
    """Plain twin of a slab chain: ``rfft`` along z on each x-slab, the
    exchange to kz-slabs, ``fft`` along y and x, ``apply(y, j, off, w)`` on
    kz-slab j of columns off..off+w-1 (and
    the Hermitian kz planes with ``real_planes``), the inverses, the
    exchange back, ``irfft`` along z (all norm="forward")."""
    split = par.kz_split(grid.nzc)
    kzs = slab_rfftn(par, f)
    for j, (y, (off, w)) in enumerate(zip(kzs, split)):
        if y is None:
            continue
        y = apply(y, j, off, w)
        kzs[j] = _real_z_planes(y, grid.nz, off) if real_planes else y
    return slab_irfftn(par, kzs, grid.nz)


def _slab_vector(E, j, like, n):
    """Slab j's copy of E (a list replicated over the slabs, or one
    value), as :func:`_vector` on ``like``'s device."""
    return _vector(slabs.part(E, j), like, n)


def g0_staggered_chain_slab_plain(par, grid, f, c10, c20):
    """Plain twin of :func:`g0_staggered_chain_slab`."""
    def apply(y, j, off, w):
        t = _kz_cols(staggered_tables(grid, y.real.dtype, y.device), off, w)
        return g0_staggered_apply_plain(y, t, c10, c20, dc=off == 0)
    return _slab_chain_plain(par, grid, f, apply)


def g0_staggered_heat_chain_slab_plain(par, grid, f, c10):
    """Plain twin of :func:`g0_staggered_heat_chain_slab`."""
    def apply(y, j, off, w):
        t = _kz_cols(staggered_tables(grid, y.real.dtype, y.device), off, w)
        return g0_staggered_heat_apply_plain(y, t, c10, dc=off == 0)
    return _slab_chain_plain(par, grid, f, apply)


def gamma_collocated_chain_slab_plain(par, grid, tau, A, B, E, beta):
    """Plain twin of :func:`gamma_collocated_chain_slab`."""
    def apply(y, j, off, w):
        t = _kz_cols(collocated_tables(grid, y.real.dtype, y.device), off, w)
        return gamma_collocated_apply_plain(
            y, t, A, B, _slab_vector(E, j, t[0], y.shape[0]), beta,
            dc=off == 0)
    return _slab_chain_plain(par, grid, tau, apply, real_planes=True)


def gamma_collocated_hyper_chain_slab_plain(par, grid, tau, A, B, E, beta):
    """Plain twin of :func:`gamma_collocated_hyper_chain_slab`."""
    return gamma_collocated_chain_slab_plain(par, grid, tau, A, B, E, beta)


def gamma_collocated_zt_chain_slab_plain(par, grid, tau, A, B, E, beta):
    """Plain twin of :func:`gamma_collocated_zt_chain_slab`: components
    1..5 go through the slab chain, component 0 is -(c1 + c2) in the
    spectrum and in real space."""
    def apply(y, j, off, w):
        t = _kz_cols(collocated_tables(grid, y.real.dtype, y.device), off, w)
        y6 = torch.cat([-(y[0] + y[1])[None], y])
        return gamma_collocated_apply_plain(
            y6, t, A, B, _slab_vector(E, j, t[0], 6), beta,
            dc=off == 0)[1:]
    rest = _slab_chain_plain(par, grid, [t[1:] for t in tau], apply,
                             real_planes=True)
    return [torch.cat([-(r[0] + r[1])[None], r]) for r in rest]


def _chain_slab(fn_name, counter, par, grid, f, ncomp, tables_on, consts,
                vector=None, out=None):
    """Launch a chain on x-slabs ``f`` (each a contiguous (ncomp, nx/D, ny,
    nz) tensor on its mesh device): ``chain_z_fwd`` per x-slab, the
    exchange, ``<fn_name>_middle`` per kz-slab with ``tables_on(device)``,
    the constants and, with ``vector``, slab j's E (``vector(j, like)``),
    the exchange back, ``chain_z_inv`` per x-slab into ``out`` (new slabs if
    None).  Returns the output slabs."""
    dt = f[0].dtype
    if dt not in _SUFFIX:
        raise TypeError(f"{fn_name} takes float32/float64, got {dt}")
    d = par.n_devices
    nxl = grid.nx // d
    shape = (ncomp, nxl, grid.ny, grid.nz)
    if len(f) != d:
        raise ValueError(f"{len(f)} slabs for a {d}-device mesh")
    for x, dev in zip(f, par.devices):
        if x.device != dev or x.dtype != dt:
            raise ValueError(f"a slab is {x.dtype} on {x.device}, expected "
                             f"{dt} on {dev}")
        if tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"a slab has shape {tuple(x.shape)} (contiguous:"
                             f" {x.is_contiguous()}), expected a contiguous "
                             f"{shape}")
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
    cdt, suf, vp = _COMPLEX[dt], _SUFFIX[dt], ctypes.c_void_p
    zsig = [vp, vp, vp, ctypes.c_longlong, ctypes.c_int, vp]
    zfwd = _build.function("g0_staggered_chain", f"chain_z_fwd_{suf}",
                           ctypes.c_int, zsig)
    zinv = _build.function("g0_staggered_chain", f"chain_z_inv_{suf}",
                           ctypes.c_int, zsig)
    mid = _build.function(
        "g0_staggered_chain", f"{fn_name}_middle_{suf}", ctypes.c_int,
        [vp] * (6 + (vector is not None)) + [ctypes.c_double] * len(consts)
        + [ctypes.c_int] * 5 + [vp])
    nlines = ncomp * nxl * grid.ny
    # per distinct device: its stream and the twiddle tables (the host side
    # of a slab chain is a dozen launches, and on a small field it, not the
    # card, sets the pace)
    per_dev = {dev: (_stream(dev), *(_twiddle(n, cdt, dev).data_ptr()
                                      for n in grid.shape))
               for dev in dict.fromkeys(par.devices)}

    spec = []
    for x, dev in zip(f, par.devices):
        st, _, _, twz = per_dev[dev]
        y = torch.empty((ncomp, nxl, grid.ny, grid.nzc), dtype=cdt,
                        device=dev)
        with torch.cuda.device(dev):
            err = zfwd(x.data_ptr(), y.data_ptr(), twz, nlines, grid.nz, st)
        _build.check(err, "g0_staggered_chain")
        launches[counter] += 1
        spec.append(y)
    split = par.kz_split(grid.nzc)
    kzs = comm.to_kz(spec, split, par.devices)
    del spec
    for j, (y, (off, w), dev) in enumerate(zip(kzs, split, par.devices)):
        if y is None:
            continue
        tx, ty, tz = tables_on(dev)
        ptrs = () if vector is None else (vector(j, tx).data_ptr(),)
        st, twx, twy, _ = per_dev[dev]
        with torch.cuda.device(dev):
            err = mid(y.data_ptr(), tx.data_ptr(), ty.data_ptr(),
                      tz.data_ptr(), twx, twy, *ptrs,
                      *(float(c) for c in consts), grid.nx, grid.ny, grid.nz,
                      w, off, st)
        _build.check(err, "g0_staggered_chain")
        launches[counter] += 1
    spec = comm.from_kz(kzs, nxl, par.devices)
    del kzs
    outs = []
    for i, (y, dev) in enumerate(zip(spec, par.devices)):
        o = torch.empty(shape, dtype=dt, device=dev) if out is None \
            else out[i]
        st, _, _, twz = per_dev[dev]
        with torch.cuda.device(dev):
            err = zinv(y.data_ptr(), o.data_ptr(), twz, nlines, grid.nz, st)
        _build.check(err, "g0_staggered_chain")
        launches[counter] += 1
        outs.append(o)
    return outs


def _on_cpu(f):
    return f[0].device.type == "cpu"


@_applied
def g0_staggered_chain_slab(par, grid, f, c10, c20):
    """K3 on the x-slabs of a sharded 3-component force field (parallel.
    fft.SlabPar ``par``); returns new slabs."""
    if _on_cpu(f):
        return g0_staggered_chain_slab_plain(par, grid, f, c10, c20)
    return _chain_slab("g0_staggered_chain", "g0_staggered_chain_slab", par,
                       grid, f, 3,
                       lambda dev: staggered_tables(grid, f[0].dtype, dev),
                       (c10, c20))


@_applied
def g0_staggered_heat_chain_slab(par, grid, f, c10):
    """K4 on the x-slabs of a sharded 1-component source field."""
    if _on_cpu(f):
        return g0_staggered_heat_chain_slab_plain(par, grid, f, c10)
    return _chain_slab("g0_staggered_heat_chain",
                       "g0_staggered_heat_chain_slab", par, grid, f, 1,
                       lambda dev: staggered_tables(grid, f[0].dtype, dev),
                       (c10,))


@_applied
def gamma_collocated_chain_slab(par, grid, tau, A, B, E, beta):
    """K5 (C = 6 or 3) on the x-slabs of a sharded field; ``E`` is C values
    or a list of them replicated over the slabs (each on its device)."""
    if _on_cpu(tau):
        return gamma_collocated_chain_slab_plain(par, grid, tau, A, B, E,
                                                 beta)
    ncomp = tau[0].shape[0]
    if ncomp not in (6, 3):
        raise ValueError(f"tau has {ncomp} components, expected 6 or 3")
    name = "gamma_collocated_chain" if ncomp == 6 else \
        "gamma_collocated_heat_chain"
    return _chain_slab(name, "gamma_collocated_chain_slab", par, grid, tau,
                       ncomp,
                       lambda dev: collocated_tables(grid, tau[0].dtype, dev),
                       (A, B, beta),
                       vector=lambda j, like: _slab_vector(E, j, like, ncomp))


@_applied
def gamma_collocated_hyper_chain_slab(par, grid, tau, A, B, E, beta):
    """K5 at C = 9 (the finite-strain collocated Gamma) on the x-slabs of a
    sharded deformation-gradient field; ``E`` is 9 values or a list of them
    replicated over the slabs.  Counts under ``gamma_collocated_chain_slab``."""
    if _on_cpu(tau):
        return gamma_collocated_hyper_chain_slab_plain(par, grid, tau, A, B,
                                                       E, beta)
    if tau[0].shape[0] != 9:
        raise ValueError(f"tau has {tau[0].shape[0]} components, expected 9")
    return _chain_slab("gamma_collocated_hyper_chain",
                       "gamma_collocated_chain_slab", par, grid, tau, 9,
                       lambda dev: collocated_tables(grid, tau[0].dtype, dev),
                       (A, B, beta),
                       vector=lambda j, like: _slab_vector(E, j, like, 9))


@_applied
def gamma_collocated_zt_chain_slab(par, grid, tau, A, B, E, beta):
    """K6 on the x-slabs of a sharded traceless 6-component field: each
    slab's components 1..5 go through the slab chain, then out[0] =
    -(out[1] + out[2]) per slab."""
    if _on_cpu(tau):
        return gamma_collocated_zt_chain_slab_plain(par, grid, tau, A, B, E,
                                                    beta)
    if tau[0].shape[0] != 6:
        raise ValueError(f"tau has {tau[0].shape[0]} components, expected 6")
    out = [torch.empty_like(t) for t in tau]
    _chain_slab("gamma_collocated_zt_chain", "gamma_collocated_zt_chain_slab",
                par, grid, [t[1:] for t in tau], 5,
                lambda dev: collocated_tables(grid, tau[0].dtype, dev),
                (A, B, beta),
                vector=lambda j, like: _slab_vector(E, j, like, 6),
                out=[o[1:] for o in out])
    for o in out:
        torch.add(o[1], o[2], out=o[0]).neg_()
    return out
