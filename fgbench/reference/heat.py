"""Plain reference of heat conduction on the staggered grid.

Unknown: the periodic temperature T.  Gradient g = E + (D+x T, D+y T,
D+z T), flux k g per voxel, divergence D-x f0 + D-y f1 + D-z f2 (the
negative adjoint of the gradient).  The conjugate gradient solves
-div(k grad T) = div(k E), preconditioned by 1 / (k0 |q|^2) on the modes q
of D+.
"""
from __future__ import annotations

import torch

from fgbench.reference import _plain as pl

DIM = 3


def gradient(t, E, h):
    return torch.stack([E[a] + pl.dp(t[0], a, h[a]) for a in range(3)])


def div(f, h):
    return (pl.dm(f[0], 0, h[0]) + pl.dm(f[1], 1, h[1])
            + pl.dm(f[2], 2, h[2]))[None]


def solve(config, phi, load, *, tol=1e-10, maxiter=1000,
          store=torch.float64) -> pl.Solution:
    """The gradient field and mean flux of the unit cell under the mean
    gradient ``load`` (3 values), the phases' conductivities (``mu``)
    mixed over ``phi``."""
    work = pl.work_dtype(store)
    q = pl.rounder(store, work)
    shape = tuple(phi.shape)
    cell = config.get("cell", (1.0, 1.0, 1.0))
    h = pl.inv_h(shape, cell)
    (k,) = (q(m) for m in pl.phase_moduli(config, phi, ("mu",), work))
    E = torch.as_tensor(load, dtype=work, device=phi.device)
    zero = torch.zeros(DIM, dtype=work, device=phi.device)
    k0 = pl.contrast_mean(config, "mu")
    _, q2 = pl.wavenumbers(shape, cell, phi.device, work)

    def apply_a(t):
        return -div(k * gradient(t, zero, h), h)

    def precond(r):
        th = pl.spectrum(r, shape) / (k0 * q2)
        th[:, 0, 0, 0] = 0.0
        return pl.real(th, shape).to(work)

    b = q(div(k * E.reshape(-1, 1, 1, 1), h))
    t, it, rel = pl.pcg(apply_a, precond, b, q, tol, maxiter)
    g = q(gradient(t, E, h))
    mean = (k * g).mean(dim=(1, 2, 3)).to(torch.float64)
    return pl.Solution(g, mean, it, rel)
