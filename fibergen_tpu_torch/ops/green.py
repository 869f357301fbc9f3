"""Green operators: the staggered-grid G0 (G0OperatorFourierStaggered +
General, fibergen.cpp:19749-19927, its full-gradient constants for finite
strain, fibergen.cpp:19768-19774, and the scalar heat form,
fibergen.cpp:19778-19830) with the modified wavenumbers k+, and the
collocated Gamma (GammaOperatorFourierCollocated, its heat form and its
finite-strain form, fibergen.cpp:19302-19745) with the continuous
wavenumbers xi, and the periodic Poisson solve of the viscosity pressure.

The hat-space operators are plain PyTorch; the ``*_fused`` entry points
take real-space fields and dispatch to the chain kernels of
``spectral_kernels`` (their plain twins on the CPU).  Two operators run no
chain, as in the JAX package, which takes XLA's FFT for them outside its
Pallas kernels: Willot's rotated Gamma (:func:`gamma_willot`) and the
collocated Gamma with the even-grid Nyquist symmetrization
(``freq_hack``); both go through ``torch.fft`` on any device, on x-slabs
through the plain slab transforms (:func:`slab_transformed`) with each
kz-slab's own wavenumbers.  With ``par`` (a parallel.fft.SlabPar) the field
is a list of x-slabs and the chain runs on them (``*_chain_slab``;
green.py:217-236, :336-345, :499-590 of the JAX package pass ``par`` the
same way).  The ``*_fused_batched`` forms take a (B, C, nx, ny, nz) batch of
right-hand sides through one batched chain (``*_chain_batched``), as the
JAX package's batched CG vmaps its fused operators (ls.py:944-986)."""
from __future__ import annotations

import itertools

import numpy as np
import torch

from ..parallel import slabs
from . import fft, spectral_kernels


def g0_constants(mu_0, lambda_0, alpha=-1.0):
    """(c10, c20) of eta = alpha G0 tau:  c1 = c10/|k|^2 = -alpha/(mu0 |k|^2),
    c2 = c20/|k|^4 = -alpha (lam0+mu0) / (mu0 (lam0+2mu0) |k|^4).  The
    viscosity Delta scheme's dual constants (-mu0, inf) give c20 = c10."""
    c10 = -alpha / mu_0
    c20 = float(-alpha / (mu_0 * (1.0 + mu_0 / (np.float64(lambda_0) + mu_0))))
    return c10, c20


def g0_staggered(grid, mu_0, lambda_0, tau_hat, alpha=-1.0):
    """eta_hat = alpha * G0_hat(tau_hat) on 3-component (force) hat fields,
    out of place (plain PyTorch)."""
    c10, c20 = g0_constants(mu_0, lambda_0, alpha)
    tables = spectral_kernels.staggered_tables(grid, tau_hat.real.dtype,
                                               tau_hat.device)
    return spectral_kernels.g0_staggered_apply_plain(tau_hat, tables, c10, c20)


def g0_staggered_fused(grid, mu_0, lambda_0, f, alpha=-1.0, par=None):
    """u = ifftn(G0_staggered(fftn(f))) in one dispatch: the K3 chain on the
    card, its plain twin on the CPU."""
    c10, c20 = g0_constants(mu_0, lambda_0, alpha)
    if par is not None:
        return spectral_kernels.g0_staggered_chain_slab(par, grid, f, c10,
                                                        c20)
    return spectral_kernels.g0_staggered_chain(grid, f, c10, c20)


def g0_staggered_fused_batched(grid, mu_0, lambda_0, f, alpha=-1.0):
    """:func:`g0_staggered_fused` of each case of a (B, 3, nx, ny, nz)
    batch in one batched K3 chain."""
    c10, c20 = g0_constants(mu_0, lambda_0, alpha)
    return spectral_kernels.g0_staggered_chain_batched(grid, f, c10, c20)


def g0_staggered_heat(grid, mu_0, lambda_0, tau_hat, alpha=-1.0):
    """Scalar staggered G0 (G0OperatorFourierStaggeredGeneralHeat,
    fibergen.cpp:19778-19830): eta = -alpha/(2 mu0 |k|^2) * tau on a
    (1, ...) hat field, DC zeroed (plain PyTorch)."""
    tables = spectral_kernels.staggered_tables(grid, tau_hat.real.dtype,
                                               tau_hat.device)
    return spectral_kernels.g0_staggered_heat_apply_plain(
        tau_hat, tables, -alpha / (2.0 * mu_0))


def g0_staggered_heat_fused(grid, mu_0, lambda_0, f, alpha=-1.0, par=None):
    """u = ifftn(G0_staggered_heat(fftn(f))) in one dispatch: the K4 chain
    on the card, its plain twin on the CPU."""
    if par is not None:
        return spectral_kernels.g0_staggered_heat_chain_slab(
            par, grid, f, -alpha / (2.0 * mu_0))
    return spectral_kernels.g0_staggered_heat_chain(grid, f,
                                                    -alpha / (2.0 * mu_0))


def g0_staggered_heat_fused_batched(grid, mu_0, lambda_0, f, alpha=-1.0):
    """:func:`g0_staggered_heat_fused` of each case of a (B, 1, nx, ny, nz)
    batch in one batched K4 chain."""
    return spectral_kernels.g0_staggered_heat_chain_batched(
        grid, f, -alpha / (2.0 * mu_0))


def hyper_constants(mu_0, lambda_0, alpha=-1.0):
    """(A, B) of the finite-strain (full-gradient) operators, in float64 on
    the host: A = alpha/(2 mu0), B = -alpha/(2 mu0 (1 + 2 mu0/lam0)).  B is
    0 at lambda_0 = 0 (IEEE inf, fibergen.cpp:19627), the reference
    material of the hyperelastic path.  The staggered G0 takes c10 = -A
    and c20 = B."""
    A = alpha / (2.0 * mu_0)
    with np.errstate(divide="ignore"):
        B = float(-alpha / (2.0 * mu_0
                            * (1.0 + 2.0 * mu_0 / np.float64(lambda_0))))
    return A, B


def g0_staggered_hyper(grid, mu_0, lambda_0, tau_hat, alpha=-1.0):
    """Staggered G0 of the full-gradient scheme on 3-component hat fields
    (fibergen.cpp:19768-19774), plain PyTorch: the elasticity G0 with
    c10 = -alpha/(2 mu0), c20 = -alpha/(2 mu0 (1 + 2 mu0/lam0))."""
    A, B = hyper_constants(mu_0, lambda_0, alpha)
    tables = spectral_kernels.staggered_tables(grid, tau_hat.real.dtype,
                                               tau_hat.device)
    return spectral_kernels.g0_staggered_apply_plain(tau_hat, tables, -A, B)


def g0_staggered_hyper_fused(grid, mu_0, lambda_0, f, alpha=-1.0, par=None):
    """u = ifftn(g0_staggered_hyper(fftn(f))) in one dispatch: the K3 chain
    with the full-gradient constants on the card, its plain twin on the
    CPU."""
    A, B = hyper_constants(mu_0, lambda_0, alpha)
    if par is not None:
        return spectral_kernels.g0_staggered_chain_slab(par, grid, f, -A, B)
    return spectral_kernels.g0_staggered_chain(grid, f, -A, B)


def collocated_constants(mu_0, lambda_0, alpha=-1.0):
    """(A, B) of the collocated Gamma, in float64 on the host:
    A = alpha/(2 mu0) and B = -alpha/(mu0 (1 + mu0/(lam0 + mu0))), finite
    for lambda_0 -> inf (fibergen.cpp:19388) and for the viscosity Delta
    scheme's dual constants (-mu0, inf)."""
    A = alpha / (2.0 * mu_0)
    B = float(-alpha / (mu_0 * (1.0 + mu_0 / (np.float64(lambda_0) + mu_0))))
    return A, B


def _tables_of(grid, tau_hat):
    return spectral_kernels.collocated_tables(grid, tau_hat.real.dtype,
                                              tau_hat.device)


def gamma_collocated(grid, E, mu_0, lambda_0, tau_hat, alpha=-1.0, beta=0.0,
                     freq_hack=False, cols=None):
    """eta_hat = alpha Gamma_hat : tau_hat + beta tau_hat with the DC bin =
    E on 6-component hat fields (GammaOperatorFourierCollocated,
    fibergen.cpp:19381-19608), plain PyTorch:
        t_i = tau_ij xi_j,  s = xi . t
        (Gamma tau)_ij = (xi_i t_j + xi_j t_i) / (2 mu0 |xi|^2)
                         - (lam0+mu0)/(mu0(lam0+2mu0)) xi_i xi_j s / |xi|^4

    ``freq_hack`` is the reference's even-grid Nyquist fix
    (fibergen.cpp:19396-19398, 19459-19472): at a bin where axes sit on
    their sign-ambiguous Nyquist frequency, Gamma is the average of the
    applications over the 2^m sign choices of those components.

    ``cols=(off, w)``: ``tau_hat`` is the kz-slab of columns off..off+w-1
    (parallel/), which holds the DC bin when off == 0."""
    A, B = collocated_constants(mu_0, lambda_0, alpha)
    tables = _tables_of(grid, tau_hat)
    off, w = (0, grid.nzc) if cols is None else cols
    tables = spectral_kernels._kz_cols(tables, off, w)
    if not freq_hack:
        return spectral_kernels.gamma_collocated_apply_plain(
            tau_hat, tables, A, B, E, beta, dc=off == 0)
    tx, ty, tz = tables
    xis = (tx.reshape(-1, 1, 1), ty.reshape(-1, 1), tz)
    ind = torch.zeros(tau_hat.shape[1:], dtype=tx.dtype, device=tx.device)
    if off == 0:
        ind[0, 0, 0] = 1.0
    eta = None
    combos = _nyquist_sign_combos(grid, xis, (off, w))
    for x in combos:
        k2 = x[0] * x[0] + x[1] * x[1] + x[2] * x[2] + ind
        part = torch.stack(spectral_kernels._gamma_part(list(tau_hat), x, k2,
                                                        A, B))
        eta = part if eta is None else eta + part
    eta = eta / float(len(combos))
    if beta != 0.0:
        eta = eta + beta * tau_hat
    E = spectral_kernels._vector(E, tx, tau_hat.shape[0])
    return eta * (1.0 - ind) + E.reshape(-1, 1, 1, 1) * ind


def _nyquist_sign_combos(grid, xis, cols):
    """The sign-flip variants of the wavenumbers ``xis`` over the Nyquist
    bins of the even axes (the JAX package's ``_nyquist_sign_combos``):
    2^m tuples for m even axes, ``[xis]`` when no axis is even.  Off the
    Nyquist bins every variant equals ``xis``.  ``cols=(off, w)``: the kz
    columns ``xis`` holds."""
    flips = []
    off, w = cols
    for axis, (f, n) in enumerate(zip(grid.freq_index, grid.shape)):
        if axis == 2:
            f = f[off:off + w]
        if n % 2 == 0:
            m = torch.as_tensor(np.abs(f) == n // 2, device=xis[0].device)
            flips.append((axis, m))
    combos = []
    for signs in itertools.product((1.0, -1.0), repeat=len(flips)):
        var = list(xis)
        for (axis, m), sgn in zip(flips, signs):
            if sgn < 0:
                var[axis] = torch.where(m, -var[axis], var[axis])
        combos.append(tuple(var))
    return combos


def gamma_collocated_heat(grid, E, mu_0, lambda_0, tau_hat, alpha=-1.0,
                          beta=0.0):
    """Scalar (heat/porous) collocated Gamma on 3-component hat fields with
    reference conductivity 2 mu_0 (GammaOperatorFourierCollocatedHeat,
    fibergen.cpp:19302-19377):  (Gamma tau)_i = xi_i (xi . tau) /
    (2 mu0 |xi|^2); DC bin = E."""
    return spectral_kernels.gamma_collocated_apply_plain(
        tau_hat, _tables_of(grid, tau_hat), alpha / (2.0 * mu_0), 0.0, E,
        beta)


def gamma_collocated_fused(grid, E, mu_0, lambda_0, tau, alpha=-1.0,
                           beta=0.0, freq_hack=False, par=None):
    """eta = ifftn(gamma_collocated(fftn(tau))) on a real 6-component
    ``tau`` in one dispatch: the K5 chain on the card, its plain twin on the
    CPU.  ``E`` may be a device tensor (it is not read on the host), on
    x-slabs a list of them, one per slab.  ``freq_hack`` takes the separate
    transforms (``torch.fft``) around the symmetrized apply, as the JAX
    package does; on x-slabs the plain slab transforms
    (:func:`slab_transformed`) around the apply on each kz-slab."""
    if freq_hack:
        if par is not None:
            return slab_transformed(par, grid, tau, lambda y, j, cols: (
                gamma_collocated(grid, slabs.part(E, j), mu_0, lambda_0, y,
                                 alpha, beta, freq_hack=True, cols=cols)))
        return fft.ifftn(gamma_collocated(grid, E, mu_0, lambda_0,
                                          fft.fftn(tau), alpha, beta,
                                          freq_hack=True), grid.shape)
    A, B = collocated_constants(mu_0, lambda_0, alpha)
    if par is not None:
        return spectral_kernels.gamma_collocated_chain_slab(par, grid, tau, A,
                                                            B, E, beta)
    return spectral_kernels.gamma_collocated_chain(grid, tau, A, B, E, beta)


def gamma_collocated_fused_batched(grid, E, mu_0, lambda_0, tau,
                                   alpha=-1.0, beta=0.0):
    """:func:`gamma_collocated_fused` (without ``freq_hack``) of each case
    of a (B, 6, nx, ny, nz) batch in one batched K5 chain; ``E`` a (B, 6)
    table of the cases' means, or one for all."""
    A, B = collocated_constants(mu_0, lambda_0, alpha)
    return spectral_kernels.gamma_collocated_chain_batched(grid, tau, A, B,
                                                           E, beta)


def gamma_collocated_heat_fused(grid, E, mu_0, lambda_0, tau, alpha=-1.0,
                                beta=0.0, par=None):
    """eta = ifftn(gamma_collocated_heat(fftn(tau))) on a real 3-component
    ``tau``: the K5 chain (C = 3) on the card, its plain twin on the CPU."""
    if par is not None:
        return spectral_kernels.gamma_collocated_chain_slab(
            par, grid, tau, alpha / (2.0 * mu_0), 0.0, E, beta)
    return spectral_kernels.gamma_collocated_chain(
        grid, tau, alpha / (2.0 * mu_0), 0.0, E, beta)


def gamma_collocated_heat_fused_batched(grid, E, mu_0, lambda_0, tau,
                                        alpha=-1.0, beta=0.0):
    """:func:`gamma_collocated_heat_fused` of each case of a (B, 3, nx, ny,
    nz) batch in one batched K5 chain (C = 3)."""
    return spectral_kernels.gamma_collocated_chain_batched(
        grid, tau, alpha / (2.0 * mu_0), 0.0, E, beta)


def gamma_collocated_zt_fused(grid, E, mu_0, lambda_0, tau, alpha=-1.0,
                              beta=0.0, par=None):
    """Zero-trace collocated Gamma (the viscosity Delta scheme's spectral
    core, fibergen.cpp:19075-19080 + 20464-20471) on a traceless real
    6-component ``tau``: components 1.. are transformed, component 0 is
    -(c1 + c2) in the spectrum and in real space; DC bin = E (6 values).
    The K6 chain on the card, its plain twin on the CPU."""
    A, B = collocated_constants(mu_0, lambda_0, alpha)
    if par is not None:
        return spectral_kernels.gamma_collocated_zt_chain_slab(par, grid, tau,
                                                               A, B, E, beta)
    return spectral_kernels.gamma_collocated_zt_chain(grid, tau, A, B, E,
                                                      beta)


def gamma_collocated_zt_fused_batched(grid, E, mu_0, lambda_0, tau,
                                      alpha=-1.0, beta=0.0):
    """:func:`gamma_collocated_zt_fused` of each case of a traceless (B, 6,
    nx, ny, nz) batch in one batched K6 chain; ``E`` a (B, 6) table, or one
    for all."""
    A, B = collocated_constants(mu_0, lambda_0, alpha)
    return spectral_kernels.gamma_collocated_zt_chain_batched(grid, tau, A, B,
                                                              E, beta)


def gamma_collocated_hyper(grid, E, mu_0, lambda_0, tau_hat, alpha=-1.0,
                           beta=0.0):
    """Nonsymmetrized (finite-strain) collocated Gamma on 9-component hat
    fields (GammaOperatorFourierCollocatedHyper, fibergen.cpp:19619-19745),
    plain PyTorch, with the DC bin = E:
        t_i = tau_il xi_l (tau full, not symmetrized),  s = xi . t
        (Gamma tau)_ij = xi_j t_i / (2 mu0 |xi|^2)
                         - lam0/(2 mu0 (lam0 + 2 mu0)) xi_i xi_j s / |xi|^4
    """
    A, B = hyper_constants(mu_0, lambda_0, alpha)
    return spectral_kernels.gamma_collocated_apply_plain(
        tau_hat, _tables_of(grid, tau_hat), A, B, E, beta)


def gamma_collocated_hyper_fused(grid, E, mu_0, lambda_0, tau, alpha=-1.0,
                                 beta=0.0, par=None):
    """eta = ifftn(gamma_collocated_hyper(fftn(tau))) on a real 9-component
    ``tau`` in one dispatch: the K5 chain at C = 9 on the card, its plain
    twin on the CPU.  ``E`` may be a device tensor, on x-slabs a list of
    them, one per slab."""
    A, B = hyper_constants(mu_0, lambda_0, alpha)
    if par is not None:
        return spectral_kernels.gamma_collocated_hyper_chain_slab(
            par, grid, tau, A, B, E, beta)
    return spectral_kernels.gamma_collocated_hyper_chain(grid, tau, A, B, E,
                                                         beta)


# ------------------------------------------------------------- Willot
_willot_cache: dict = {}


def _willot_entries(grid, mu_0, lambda_0, dtype, device, cols=None):
    """The 21 upper-triangle entries g(iv, jv), iv <= jv, of Willot's
    rotated Gamma on the half-spectrum (GammaOperatorFourierWillotR,
    fibergen.cpp:19083-19299; the JAX package's green.gamma_willot), in
    the complex type of ``dtype`` on ``device``; with ``cols=(off, w)`` on
    the kz columns off..off+w-1 of a kz-slab, from its own wavenumbers.
    Built in float64 and kept for the last (grid, mu_0, lambda_0, dtype),
    per device and columns: a solve applies the same operator at every
    iteration, on every kz-slab."""
    base = (grid, float(mu_0), None if lambda_0 is None else float(lambda_0),
            dtype)
    key = (torch.device(device), cols)
    if _willot_cache.get("base") != base:
        _willot_cache.clear()
        _willot_cache["base"] = base
    hit = _willot_cache.get(key)
    if hit is not None:
        return hit
    f64, c128 = torch.float64, torch.complex128
    fx, fy, fz = grid.freq_index
    if cols is not None:
        fz = fz[cols[0]:cols[0] + cols[1]]
    qs = [torch.as_tensor(f * (2.0 * np.pi / n), dtype=f64, device=device)
          for f, n in zip((fx, fy, fz), grid.shape)]
    w = grid.spacing
    e012 = 1.0
    for q in qs:
        e012 = e012 * (1.0 + torch.exp(1j * q.to(c128)))
    kv = [(1j * 0.25 / w[a]) * torch.tan(0.5 * qs[a]) * e012
          for a in range(3)]
    tiny = float(np.finfo(np.float64).tiny)
    mag = torch.sqrt(sum(k.abs() ** 2 for k in kv)) + tiny
    r = [k / mag for k in kv]
    rc = [x.conj() for x in r]
    r2 = (r[0] * r[0] + r[1] * r[1] + r[2] * r[2]).abs() ** 2
    # lambda_0-scaled coefficients (fibergen.cpp:19242-19250); the
    # lambda_0 -> inf limit (fibergen.cpp:19231-19240)
    if lambda_0 is None or np.isinf(lambda_0):
        a1, a2, a3, b1, b2 = 1.0, 1.0, 0.0, 2.0, 1.0
    else:
        a1, a2, a3 = lambda_0 + 2.0 * mu_0, lambda_0, -mu_0
        b1, b2 = 2.0 * (lambda_0 + mu_0), lambda_0
    den = mu_0 * (b1 - b2 * r2)
    vi, vj = [0, 1, 2, 1, 0, 0], [0, 1, 2, 2, 2, 1]

    def im(a, b):
        return (a * b.conj()).imag

    def s_term(i, j, k):
        # s_jk with row indices (i, j) (fibergen.cpp:19181-19214)
        if k == j:
            v = im(r[i], r[k])
            return 4.0 * v * v
        return -4.0 * im(r[k], r[j]) * im(r[k], r[i])

    def d(a, b):
        return 1.0 if a == b else 0.0

    out = {}
    for iv in range(6):
        for jv in range(iv, 6):
            i, j, k, l = vi[iv], vj[iv], vi[jv], vj[jv]
            A = 0.25 * (r[i] * rc[l] * d(j, k) + r[j] * rc[l] * d(i, k)
                        + r[i] * rc[k] * d(j, l) + r[j] * rc[k] * d(i, l))
            B = 0.25 * (r[i] * rc[l] * s_term(i, j, k)
                        + r[j] * rc[l] * s_term(j, i, k)
                        + r[i] * rc[k] * s_term(i, j, l)
                        + r[j] * rc[k] * s_term(j, i, l)) \
                - (r[i] * rc[j]).real * (r[k] * rc[l]).real
            C = r[i] * r[j] * rc[k] * rc[l]
            out[iv, jv] = ((a1 * A + a2 * B + a3 * C) / den).to(
                spectral_kernels._COMPLEX[dtype])
    _willot_cache[key] = out
    return out


def gamma_willot(grid, E, mu_0, lambda_0, tau_hat, alpha=-1.0, beta=0.0,
                 cols=None):
    """eta_hat = alpha Gamma_W : tau_hat + beta tau_hat with the DC bin = E
    on 6-component hat fields: Willot's rotated discrete Green operator
    (GammaOperatorFourierWillotR, fibergen.cpp:19083-19299), plain
    PyTorch.  The discrete wavevector is
        kvec_a = i/4 tan(q_a/2) prod_b (1 + e^{i q_b}) / w_a,
        q_a = 2 pi f_a / n_a,  w_a = d_a / n_a,
    normalized to r = kvec/|kvec|; ``lambda_0=None`` (or inf) is the
    lambda_0 -> infinity limit of the viscosity Delta scheme.  The lower
    triangle of the 6x6 map is the conjugate of the upper one; shear
    columns weigh 2.  ``cols=(off, w)``: ``tau_hat`` is the kz-slab of
    columns off..off+w-1, which holds the DC bin when off == 0."""
    g = _willot_entries(grid, mu_0, lambda_0, tau_hat.real.dtype,
                        tau_hat.device, cols)
    outs = []
    for iv in range(6):
        acc = 0.0
        for jv in range(6):
            gij = g[iv, jv] if iv <= jv else g[jv, iv].conj()
            acc = acc + (2.0 if jv >= 3 else 1.0) * gij * tau_hat[jv]
        outs.append(alpha * acc + (beta * tau_hat[iv] if beta != 0.0
                                   else 0.0))
    eta = torch.stack(outs)
    if cols is None or cols[0] == 0:
        E = spectral_kernels._vector(E, tau_hat.real, 6)
        eta[:, 0, 0, 0] = E.to(eta.dtype)
    return eta


def slab_transformed(par, grid, f, apply):
    """``ifftn(apply(fftn f))`` on the x-slabs of a sharded field through
    the plain slab transforms (``torch.fft``): the z transform on each
    x-slab, the exchange to kz-slabs (``comm.to_kz``), the y and x
    transforms there, ``apply(y, j, (off, w))`` on kz-slab j of columns
    off..off+w-1, and back.  The operators that run no chain (Willot's
    Gamma, ``freq_hack``) take it on slabs, as the JAX package takes its
    slab FFT for them (fibergen_tpu/ops/gamma.py:58-59)."""
    return spectral_kernels._slab_chain_plain(
        par, grid, f, lambda y, j, off, w: apply(y, j, (off, w)))


def poisson_solve(grid, f):
    """p with Laplace(p) = f and zero mean on the periodic grid
    (LSSolver::poisson_solve, fibergen.cpp:23454-23500), ``f`` a real (1,
    nx, ny, nz) field: the 7-point Laplacian's symbol is
    sum_a 2 (cos(2 pi f_a / n_a) - 1) (n_a / d_a)^2 = -|k+|^2 of the
    staggered tables, so p = ifftn(-fftn(f) / |k+|^2), the DC bin zeroed:
    the K4 chain with c10 = -1 on the card, its plain twin on the CPU."""
    return spectral_kernels.g0_staggered_heat_chain(grid, f.contiguous(),
                                                    -1.0)
