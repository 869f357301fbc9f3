"""Staggered-grid Green operators G0 (G0OperatorFourierStaggered + General,
fibergen.cpp:19749-19927, and the scalar heat form, fibergen.cpp:19778-19830)
with the modified wavenumbers k+."""
from __future__ import annotations

import numpy as np

from . import spectral_kernels


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


def g0_staggered_fused(grid, mu_0, lambda_0, f, alpha=-1.0):
    """u = ifftn(G0_staggered(fftn(f))) in one dispatch: the K3 chain on the
    card, its plain twin on the CPU."""
    c10, c20 = g0_constants(mu_0, lambda_0, alpha)
    return spectral_kernels.g0_staggered_chain(grid, f, c10, c20)


def g0_staggered_heat(grid, mu_0, lambda_0, tau_hat, alpha=-1.0):
    """Scalar staggered G0 (G0OperatorFourierStaggeredGeneralHeat,
    fibergen.cpp:19778-19830): eta = -alpha/(2 mu0 |k|^2) * tau on a
    (1, ...) hat field, DC zeroed (plain PyTorch)."""
    tables = spectral_kernels.staggered_tables(grid, tau_hat.real.dtype,
                                               tau_hat.device)
    return spectral_kernels.g0_staggered_heat_apply_plain(
        tau_hat, tables, -alpha / (2.0 * mu_0))


def g0_staggered_heat_fused(grid, mu_0, lambda_0, f, alpha=-1.0):
    """u = ifftn(G0_staggered_heat(fftn(f))) in one dispatch: the K4 chain
    on the card, its plain twin on the CPU."""
    return spectral_kernels.g0_staggered_heat_chain(grid, f,
                                                    -alpha / (2.0 * mu_0))
