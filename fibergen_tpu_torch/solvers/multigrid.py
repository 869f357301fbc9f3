"""Geometric multigrid Poisson solver, the alternative G0 applicator.

Port of fibergen_tpu/solvers/multigrid.py (MultiGridLevel and
G0OperatorMultigridStaggered, fibergen.cpp:7489-8917, 20007-20100): the
staggered G0 is applied by four periodic Poisson solves (one for a
pressure-like potential, three for the displacement components) instead of
one spectral chain.  The cycle is red-black Gauss-Seidel smoothing,
full-weighting restriction, piecewise-constant prolongation and an FFT
solve on the coarsest level; ``scheme="direct"`` runs ``maxiter`` V-cycles,
``"pcg"`` runs CG preconditioned by one V-cycle (its post-smoothing in the
reverse colour order, so the preconditioner is symmetric) until the
residual falls below ``tol`` of the right-hand side, and ``"fft"`` solves
by FFT outright.

Plain PyTorch on any device, as the JAX package computes it in ``jnp``
with no Pallas kernel: it launches no kernel of the port.  The FFT G0 (the
K3 chain) is faster; this exists for the ``<G0_solver>multigrid`` option.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from ..core.grid import Grid

_AX = (-3, -2, -1)


@dataclasses.dataclass
class MGOptions:
    n_pre_smooth: int = 2
    n_post_smooth: int = 2
    coarse_size: int = 4
    tol: float = 1e-12
    maxiter: int = 16
    scheme: str = "direct"   # direct (V-cycles) | pcg | fft
    smooth_relax: float = 1.0


def _roll(u, shift, axis):
    return torch.roll(u, shift, dims=_AX[axis])


def _laplacian(u, h2):
    """Periodic 7-point Laplacian, ``h2`` the (n/d)^2 per axis."""
    out = None
    for a in range(3):
        t = (_roll(u, -1, a) - 2 * u + _roll(u, 1, a)) * h2[a]
        out = t if out is None else out + t
    return out


def _rb_masks(shape, device):
    """The red (i + j + k even) and black voxels."""
    idx = [torch.arange(n, device=device) for n in shape]
    red = (idx[0][:, None, None] + idx[1][None, :, None]
           + idx[2][None, None, :]) % 2 == 0
    return red, ~red


def _smooth_rb(u, b, h2, masks, relax):
    """One red-black Gauss-Seidel sweep, the colours in the order of
    ``masks``, each colour's voxels updated together."""
    diag = -2.0 * (h2[0] + h2[1] + h2[2])
    for m in masks:
        nb = None
        for a in range(3):
            t = (_roll(u, -1, a) + _roll(u, 1, a)) * h2[a]
            nb = t if nb is None else nb + t
        u_new = (b - nb) / diag
        u = torch.where(m, u * (1 - relax) + relax * u_new, u)
    return u


def _restrict(r):
    """Full-weighting restriction to the half grid (the mean of each 2x2x2
    block)."""
    acc = None
    for a in range(2):
        for b in range(2):
            for c in range(2):
                s = r[a::2, b::2, c::2]
                acc = s if acc is None else acc + s
    return acc / 8.0


def _prolong(e):
    """Piecewise-constant prolongation."""
    return e.repeat_interleave(2, 0).repeat_interleave(2, 1) \
        .repeat_interleave(2, 2)


def _coarse_solve_fft(b, grid: Grid):
    """The periodic Poisson problem solved by FFT (mg coarse_solver='fft',
    fibergen.cpp:14858), with the symbol of the 7-point Laplacian and a
    zero mean."""
    bh = torch.fft.rfftn(b, dim=_AX)
    kx = 2 * np.pi * np.fft.fftfreq(grid.nx)
    ky = 2 * np.pi * np.fft.fftfreq(grid.ny)
    kz = 2 * np.pi * np.fft.rfftfreq(grid.nz)
    hx2 = (grid.nx / grid.dx) ** 2
    hy2 = (grid.ny / grid.dy) ** 2
    hz2 = (grid.nz / grid.dz) ** 2
    sym = (2 * (np.cos(kx) - 1)[:, None, None] * hx2
           + 2 * (np.cos(ky) - 1)[None, :, None] * hy2
           + 2 * (np.cos(kz) - 1)[None, None, :] * hz2)
    sym[0, 0, 0] = 1.0
    uh = bh / torch.as_tensor(sym, dtype=b.dtype, device=b.device)
    uh[0, 0, 0] = 0.0
    return torch.fft.irfftn(uh, s=b.shape, dim=_AX)


def _build_levels(grid: Grid, coarse_size: int) -> List[Grid]:
    levels = [grid]
    g = grid
    while (min(g.nx, g.ny, g.nz) > coarse_size
           and g.nx % 2 == 0 and g.ny % 2 == 0 and g.nz % 2 == 0):
        g = Grid(g.nx // 2, g.ny // 2, g.nz // 2, g.dx, g.dy, g.dz, g.x0)
        levels.append(g)
    return levels


class _Hierarchy:
    """The levels of a grid with their red-black masks and (n/d)^2."""

    def __init__(self, grid, opt, device):
        self.levels = _build_levels(grid, opt.coarse_size)
        self.masks = [_rb_masks(g.shape, device) for g in self.levels]
        self.h2 = [((g.nx / g.dx) ** 2, (g.ny / g.dy) ** 2,
                    (g.nz / g.dz) ** 2) for g in self.levels]
        self.opt = opt

    def vcycle(self, level, u, b, symmetric=False):
        """One V-cycle from ``u`` on ``level``; ``symmetric`` smooths after
        the coarse correction in the reverse colour order."""
        opt = self.opt
        if level == len(self.levels) - 1:
            return _coarse_solve_fft(b, self.levels[level])
        h2, masks = self.h2[level], self.masks[level]
        for _ in range(opt.n_pre_smooth):
            u = _smooth_rb(u, b, h2, masks, opt.smooth_relax)
        rc = _restrict(b - _laplacian(u, h2))
        u = u + _prolong(self.vcycle(level + 1, torch.zeros_like(rc), rc,
                                     symmetric))
        post = masks[::-1] if symmetric else masks
        for _ in range(opt.n_post_smooth):
            u = _smooth_rb(u, b, h2, post, opt.smooth_relax)
        return u


def _pcg(hier, b):
    """CG on -Lap u = -b preconditioned by one symmetric V-cycle; stops at
    ``tol`` of |b| or after ``maxiter`` iterations."""
    opt, h2 = hier.opt, hier.h2[0]
    u = torch.zeros_like(b)
    r = b.clone()
    bnorm = float(torch.linalg.vector_norm(b))
    if bnorm == 0.0:
        return u
    z = hier.vcycle(0, torch.zeros_like(r), r, symmetric=True)
    z = z - z.mean()
    p = z
    rz = float((r * z).sum())
    for _ in range(opt.maxiter):
        q = _laplacian(p, h2)
        alpha = rz / float((p * q).sum())
        u = u + alpha * p
        r = r - alpha * q
        if float(torch.linalg.vector_norm(r)) <= opt.tol * bnorm:
            break
        z = hier.vcycle(0, torch.zeros_like(r), r, symmetric=True)
        z = z - z.mean()
        rz_new = float((r * z).sum())
        p = z + (rz_new / rz) * p
        rz = rz_new
    return u


def poisson_multigrid(grid: Grid, b, opt: MGOptions = None):
    """Solve the periodic 7-point Poisson problem Lap(u) = b (b's mean
    taken out) with a zero-mean u (MultiGridLevel::run_direct,
    fibergen.cpp:7489-8917)."""
    opt = opt or MGOptions()
    if opt.scheme == "fft":
        return _coarse_solve_fft(b, grid)
    if opt.scheme not in ("direct", "pcg"):
        raise ValueError(f"Unknown multigrid scheme '{opt.scheme}' (expected "
                         f"direct, pcg or fft)")
    hier = _Hierarchy(grid, opt, b.device)
    b = b - b.mean()
    if opt.scheme == "pcg":
        u = _pcg(hier, b)
    else:
        u = torch.zeros_like(b)
        for _ in range(opt.maxiter):
            u = hier.vcycle(0, u, b)
    return u - u.mean()


def g0_multigrid_staggered(grid: Grid, mu_0, lambda_0, tau, alpha=-1.0,
                           opt: MGOptions = None):
    """The staggered G0 applied by Poisson solves instead of FFTs
    (G0OperatorMultigridStaggered, fibergen.cpp:20007-20100):

        solve Lap p = alpha * (-D+ . f)
        solve Lap u_i = alpha/mu0 f_i + c2 (p[k-1] - p[k]),
        c2 = -(1/mu0)(1 - mu0/(2 mu0 + lam0)) * n_i/d_i

    tau: the (3, nx, ny, nz) force field; returns u (3, nx, ny, nz)."""
    opt = opt or MGOptions()
    f = tau
    hs = (grid.nx / grid.dx, grid.ny / grid.dy, grid.nz / grid.dz)
    # negative forward divergence (divVector, fibergen.cpp:19983-20003)
    b = alpha * ((f[0] - _roll(f[0], -1, 0)) * hs[0]
                 + (f[1] - _roll(f[1], -1, 1)) * hs[1]
                 + (f[2] - _roll(f[2], -1, 2)) * hs[2])
    p = poisson_multigrid(grid, b, opt)
    c1 = alpha / mu_0
    lam0 = np.float64(lambda_0)
    with np.errstate(divide="ignore", invalid="ignore"):
        fac = float(1.0 - mu_0 / (2.0 * mu_0 + lam0))
    us = []
    for i in range(3):
        c2 = -(1.0 / mu_0) * fac * hs[i]
        # p[k-1] - p[k] (fibergen.cpp:20042: p[k + _bfd] - p[k])
        dp = _roll(p, 1, i) - p
        us.append(poisson_multigrid(grid, c1 * f[i] + c2 * dp, opt))
    return torch.stack(us)

