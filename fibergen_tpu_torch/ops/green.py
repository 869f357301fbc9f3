"""Green operators: the staggered-grid G0 (G0OperatorFourierStaggered +
General, fibergen.cpp:19749-19927, its full-gradient constants for finite
strain, fibergen.cpp:19768-19774, and the scalar heat form,
fibergen.cpp:19778-19830) with the modified wavenumbers k+, and the
collocated Gamma (GammaOperatorFourierCollocated, its heat form and its
finite-strain form, fibergen.cpp:19302-19745) with the continuous
wavenumbers xi, and the periodic Poisson solve of the viscosity pressure.

The hat-space operators are plain PyTorch; the ``*_fused`` entry points
take real-space fields and dispatch to the chain kernels of
``spectral_kernels`` (their plain twins on the CPU).  With ``par`` (a
parallel.fft.SlabPar) the field is a list of x-slabs and the chain runs on
them (``*_chain_slab``; green.py:217-236, :336-345, :499-590 of the JAX
package pass ``par`` the same way)."""
from __future__ import annotations

import numpy as np

from . import spectral_kernels

_FREQ_HACK = ("freq_hack (the even-grid Nyquist symmetrization of the "
              "collocated Gamma) is not ported yet")


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
                     freq_hack=False):
    """eta_hat = alpha Gamma_hat : tau_hat + beta tau_hat with the DC bin =
    E on 6-component hat fields (GammaOperatorFourierCollocated,
    fibergen.cpp:19381-19608), plain PyTorch:
        t_i = tau_ij xi_j,  s = xi . t
        (Gamma tau)_ij = (xi_i t_j + xi_j t_i) / (2 mu0 |xi|^2)
                         - (lam0+mu0)/(mu0(lam0+2mu0)) xi_i xi_j s / |xi|^4
    """
    if freq_hack:
        raise NotImplementedError(_FREQ_HACK)
    A, B = collocated_constants(mu_0, lambda_0, alpha)
    return spectral_kernels.gamma_collocated_apply_plain(
        tau_hat, _tables_of(grid, tau_hat), A, B, E, beta)


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
    x-slabs a list of them, one per slab."""
    if freq_hack:
        raise NotImplementedError(_FREQ_HACK)
    A, B = collocated_constants(mu_0, lambda_0, alpha)
    if par is not None:
        return spectral_kernels.gamma_collocated_chain_slab(par, grid, tau, A,
                                                            B, E, beta)
    return spectral_kernels.gamma_collocated_chain(grid, tau, A, B, E, beta)


def gamma_collocated_heat_fused(grid, E, mu_0, lambda_0, tau, alpha=-1.0,
                                beta=0.0, par=None):
    """eta = ifftn(gamma_collocated_heat(fftn(tau))) on a real 3-component
    ``tau``: the K5 chain (C = 3) on the card, its plain twin on the CPU."""
    if par is not None:
        return spectral_kernels.gamma_collocated_chain_slab(
            par, grid, tau, alpha / (2.0 * mu_0), 0.0, E, beta)
    return spectral_kernels.gamma_collocated_chain(
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


def poisson_solve(grid, f):
    """p with Laplace(p) = f and zero mean on the periodic grid
    (LSSolver::poisson_solve, fibergen.cpp:23454-23500), ``f`` a real (1,
    nx, ny, nz) field: the 7-point Laplacian's symbol is
    sum_a 2 (cos(2 pi f_a / n_a) - 1) (n_a / d_a)^2 = -|k+|^2 of the
    staggered tables, so p = ifftn(-fftn(f) / |k+|^2), the DC bin zeroed:
    the K4 chain with c10 = -1 on the card, its plain twin on the CPU."""
    return spectral_kernels.g0_staggered_heat_chain(grid, f.contiguous(),
                                                    -1.0)
