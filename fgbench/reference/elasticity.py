"""Plain reference of linear elasticity on the staggered grid.

Unknown: the periodic displacement u (3 components).  Strain, in Voigt
order xx yy zz yz xz xy with tensor shear components,

    eps = E + (D+x ux, D+y uy, D+z uz, (D-y uz + D-z uy) / 2,
               (D-x uz + D-z ux) / 2, (D-x uy + D-y ux) / 2),

stress sigma = 2 mu eps + lam tr(eps) I per voxel, and its divergence

    (D-x s0 + D+y s5 + D+z s4, D+x s5 + D-y s1 + D+z s3,
     D+x s4 + D+y s3 + D-z s2),

the negative adjoint of the strain under the Voigt-weighted product.  The
conjugate gradient solves -div(C : grad u) = div(C : E), preconditioned by
the inverse of the same operator for an isotropic (mu0, lam0), which on
the modes q of D+ is

    (mu0 |q|^2 I + (mu0 + lam0) conj(q) q^T)^-1
        = (I - (mu0 + lam0) / (2 mu0 + lam0) conj(q) q^T / |q|^2)
          / (mu0 |q|^2).
"""
from __future__ import annotations

import torch

from fgbench.reference import _plain as pl

DIM = 6


def strain(u, E, h):
    hx, hy, hz = h
    ux, uy, uz = u[0], u[1], u[2]
    return torch.stack([
        E[0] + pl.dp(ux, 0, hx),
        E[1] + pl.dp(uy, 1, hy),
        E[2] + pl.dp(uz, 2, hz),
        E[3] + 0.5 * (pl.dm(uz, 1, hy) + pl.dm(uy, 2, hz)),
        E[4] + 0.5 * (pl.dm(uz, 0, hx) + pl.dm(ux, 2, hz)),
        E[5] + 0.5 * (pl.dm(uy, 0, hx) + pl.dm(ux, 1, hy)),
    ])


def stress(eps, mu, lam):
    tr = lam * (eps[0] + eps[1] + eps[2])
    two_mu = 2.0 * mu
    return torch.stack([two_mu * eps[0] + tr, two_mu * eps[1] + tr,
                        two_mu * eps[2] + tr, two_mu * eps[3],
                        two_mu * eps[4], two_mu * eps[5]])


def div(s, h):
    hx, hy, hz = h
    return torch.stack([
        pl.dm(s[0], 0, hx) + pl.dp(s[5], 1, hy) + pl.dp(s[4], 2, hz),
        pl.dp(s[5], 0, hx) + pl.dm(s[1], 1, hy) + pl.dp(s[3], 2, hz),
        pl.dp(s[4], 0, hx) + pl.dp(s[3], 1, hy) + pl.dm(s[2], 2, hz),
    ])


def solve(config, phi, load, *, tol=1e-10, maxiter=1000,
          store=torch.float64) -> pl.Solution:
    """The strain field and mean stress of the unit cell under the mean
    strain ``load`` (6 Voigt values), the phases' moduli mixed over
    ``phi``."""
    work = pl.work_dtype(store)
    q = pl.rounder(store, work)
    shape = tuple(phi.shape)
    cell = config.get("cell", (1.0, 1.0, 1.0))
    h = pl.inv_h(shape, cell)
    mu, lam = (q(m) for m in pl.phase_moduli(config, phi, ("mu", "lam"),
                                              work))
    E = torch.as_tensor(load, dtype=work, device=phi.device)
    zero = torch.zeros(DIM, dtype=work, device=phi.device)
    mu0 = pl.contrast_mean(config, "mu")
    lam0 = pl.contrast_mean(config, "lam")
    c = (mu0 + lam0) / (2.0 * mu0 + lam0)
    qs, q2 = pl.wavenumbers(shape, cell, phi.device, work)

    def apply_a(u):
        return -div(stress(strain(u, zero, h), mu, lam), h)

    def precond(r):
        rh = pl.spectrum(r, shape)
        qr = sum(qa * rh[a] for a, qa in enumerate(qs))
        uh = torch.stack([(rh[a] - c * torch.conj(qa) * qr / q2) / (mu0 * q2)
                          for a, qa in enumerate(qs)])
        uh[:, 0, 0, 0] = 0.0
        return pl.real(uh, shape).to(work)

    b = q(div(stress(E.reshape(-1, 1, 1, 1).expand((DIM,) + shape), mu, lam),
              h))
    u, it, rel = pl.pcg(apply_a, precond, b, q, tol, maxiter)
    eps = q(strain(u, E, h))
    mean = stress(eps, mu, lam).mean(dim=(1, 2, 3)).to(torch.float64)
    return pl.Solution(eps, mean, it, rel)
