"""Plain reference of heat conduction on the staggered grid with the
rank-1 laminate rule on the interface voxels.

Unknown: the periodic temperature T.  Gradient g = E + (D+x T, D+y T,
D+z T); the flux of voxel i is K_i g_i with

    K = k_a I + (k_h - k_a) n n^T,   k_a = c1 k1 + c2 k2,
    k_h = (c1 / k1 + c2 / k2)^-1

on the interface (both fractions above 1e-7: the laminate of the two
phases normal to n, arithmetic along the interface and harmonic across
it) and K = k_a I elsewhere (the phase's own k, to 1e-7).  c2 is the
geometry's fibre fraction ``phi`` (``inside``), c1 = 1 - c2, and n its
normal field (e_x where it has none: a voxel that no fibre reaches).
The conjugate gradient solves -div(K grad T) = div(K E), preconditioned
by 1 / (k0 |q|^2) on the modes q of D+, k0 the mean of the smallest and
largest k.  A formulation of its own: the program mixes by solving each
interface voxel's jump of the gradient along n.  Plain PyTorch only.
"""
from __future__ import annotations

import torch

from fgbench.reference import _plain as pl

DIM = 3
THRESHOLD = 1e-7


def _k(config, region):
    return next(float(p["mu"]) for p in config["phases"]
                if p["region"] == region)


def tensor(config, geom, work):
    """(k_a, k_h - k_a on the interface and 0 elsewhere, n) in ``work``."""
    c2 = geom.phi.to(work)
    c1 = 1.0 - c2
    k1, k2 = _k(config, "outside"), _k(config, "inside")
    ka = c1 * k1 + c2 * k2
    kh = 1.0 / (c1 / k1 + c2 / k2)
    dk = torch.where((c1 > THRESHOLD) & (c2 > THRESHOLD), kh - ka,
                     torch.zeros_like(ka))
    n = geom.normals.to(work)
    ex = torch.zeros_like(n)
    ex[0] = 1.0
    n = torch.where((n * n).sum(0, keepdim=True) > 1e-12, n, ex)
    return ka, dk, n


def solve(config, geom, load, *, tol=1e-10, maxiter=2000,
          store=torch.float64) -> pl.Solution:
    """The gradient field and mean flux of the cell under the mean
    gradient ``load`` (3 values)."""
    work = pl.work_dtype(store)
    q = pl.rounder(store, work)
    shape = tuple(geom.phi.shape)
    dev = geom.phi.device
    cell = config.get("cell", (1.0, 1.0, 1.0))
    h = pl.inv_h(shape, cell)
    ka, dk, n = (q(x) for x in tensor(config, geom, work))
    E = torch.as_tensor(load, dtype=work, device=dev)
    zero = torch.zeros(DIM, dtype=work, device=dev)
    k0 = 0.5 * (min(_k(config, "outside"), _k(config, "inside"))
                + max(_k(config, "outside"), _k(config, "inside")))
    _, q2 = pl.wavenumbers(shape, cell, dev, work)

    def flux(g):
        return ka * g + (dk * (n * g).sum(0)) * n

    def gradient(t, E):
        return torch.stack([E[a] + pl.dp(t[0], a, h[a]) for a in range(3)])

    def div(f):
        return (pl.dm(f[0], 0, h[0]) + pl.dm(f[1], 1, h[1])
                + pl.dm(f[2], 2, h[2]))[None]

    def apply_a(t):
        return -div(flux(gradient(t, zero)))

    def precond(r):
        th = pl.spectrum(r, shape) / (k0 * q2)
        th[:, 0, 0, 0] = 0.0
        return pl.real(th, shape).to(work)

    b = q(div(flux(E.reshape(-1, 1, 1, 1).expand((DIM,) + shape))))
    t, it, rel = pl.pcg(apply_a, precond, b, q, tol, maxiter)
    g = q(gradient(t, E))
    mean = flux(g).mean(dim=(1, 2, 3)).to(torch.float64)
    return pl.Solution(g, mean, it, rel)
