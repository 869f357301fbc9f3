"""Composite Gamma operators of the staggered modes beside elasticity.

Counterpart of fibergen_tpu/ops/gamma.py (GammaOperator*,
fibergen.cpp:20288-20531) for the two staggered branches the port runs
besides the elasticity CG step (which calls K1, K3 and K2 directly):

* :func:`gamma_heat_staggered`: the heat/porous branch of
  ``gamma_operator``, div_staggered_heat -> K4 -> eps_staggered_heat;
* :func:`fused_visc`: the viscosity Delta scheme's staggered branch of
  ``delta_operator`` on one direction build, as the JAX solver's
  ``fused_visc`` runs it: K1 tau-sum mode -> K3 with the dual constants
  -> K2 Delta mode.
"""
from __future__ import annotations

from . import green, staggered
from .stencil_kernels import eps_from_u_dot, stress_div_beta


def gamma_heat_staggered(grid, E, mu_0, tau):
    """eta = -Gamma tau with mean E on (3, nx, ny, nz) fields
    (gamma_operator, mode heat/porous, staggered scheme, alpha = -1)."""
    f = staggered.div_staggered_heat(grid, tau)
    u = green.g0_staggered_heat_fused(grid, mu_0, 0.0, f)
    return staggered.eps_staggered_heat(grid, E, u)


def fused_visc(grid, r, p_prev, beta, E, mu_x, lam_x, mu0, lam0):
    """Viscosity Delta staggered application on one direction build:
    p = r + beta p_prev (p = r with ``p_prev=None``); tau = (C(x) - C0) : p;
    u = G0'(div tau) with the dual constants (mu_0' = -mu0, lambda' -> inf,
    fibergen.cpp:20446-20458); eta = adj + grad(u) + 2 alpha mu0v tau with
    alpha = -1, mu0v = 1/(4 mu0) and adj = E - 2 alpha mu0v mean(tau), formed
    on the device.  Returns (eta, p, dot_raw) with dot_raw = nxyz <p, p -
    eta> (the CG denominator); p is None with ``p_prev=None``."""
    f, p, tau_sum = stress_div_beta(grid, r, p_prev, beta, mu_x, lam_x, mu0,
                                    lam0, want_tau_sum=True)
    u = green.g0_staggered_fused(grid, -mu0, float("inf"), f)
    bdelta = 2.0 * (-1.0) * (1.0 / (4.0 * mu0))    # 2 alpha mu0v
    adj = E - (bdelta / grid.nxyz) * tau_sum
    w, dot_raw = eps_from_u_dot(grid, adj, u, r if p is None else p,
                                mu_x=mu_x, tau2c=bdelta, mu0=mu0)
    return w, p, dot_raw
