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

On the x-slabs of a mesh (a list of slabs, ``parallel/slabs.py``) the
leading levels stay split: level l while nx_l % D == 0 and nx_l / D is
even, so that restriction and prolongation stay inside each slab.  The
smoother and the Laplacian take one x-plane from each neighbour
(``comm.halo_x``) in place of ``torch.roll`` along x, before each colour,
and the red-black masks take their parity from the slab's global x
offset.  The first level that cannot be split is gathered onto the first
slab's device, where the rest of the V-cycle and the FFT coarse solve run
unsharded; its correction is scattered back.  Means and ``pcg``'s inner
products are the slabs' partial sums added in slab order.  With
``"direct"`` the slab V-cycle gives the unsharded result up to the
rounding of those means.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from ..core.grid import Grid
from ..parallel import comm, slabs

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
        u = torch.where(m, _blend(u, u_new, relax), u)
    return u


def _blend(u, u_new, relax):
    """u (1 - relax) + relax u_new; u_new itself for relax == 1 (the same
    values for a finite u)."""
    return u_new if relax == 1.0 else u * (1 - relax) + relax * u_new


def _restrict(r):
    """Full-weighting restriction to the half grid (the mean of each 2x2x2
    block) over the last three axes."""
    acc = None
    for a in range(2):
        for b in range(2):
            for c in range(2):
                s = r[..., a::2, b::2, c::2]
                acc = s if acc is None else acc + s
    return acc / 8.0


def _prolong(e):
    """Piecewise-constant prolongation over the last three axes."""
    return e.repeat_interleave(2, -3).repeat_interleave(2, -2) \
        .repeat_interleave(2, -1)


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
    uh[..., 0, 0, 0] = 0.0
    return torch.fft.irfftn(uh, s=b.shape[-3:], dim=_AX)


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


# ------------------------------------------------------------- x-slabs
def _padded(u):
    """Each slab between its neighbours' x-planes, nx/D + 2 planes along
    axis -3: ``p[..., 2:, :, :]`` and ``p[..., :-2, :, :]`` are
    ``torch.roll(u, -1)`` and ``torch.roll(u, 1)`` of the whole field
    along x."""
    minus, plus = comm.halo_x(u)
    return [torch.cat([m, x, p], dim=-3) for m, x, p in zip(minus, u, plus)]


def _laplacian_slabs(u, h2):
    out = []
    for x, xp in zip(u, _padded(u)):
        t = (xp[..., 2:, :, :] - 2 * x + xp[..., :-2, :, :]) * h2[0]
        for a in (1, 2):
            t = t + (_roll(x, -1, a) - 2 * x + _roll(x, 1, a)) * h2[a]
        out.append(t)
    return out


def _smooth_rb_slabs(u, b, h2, masks, relax, reverse=False):
    """:func:`_smooth_rb` on slabs: each colour takes fresh halo planes.
    ``masks[j]`` is slab j's (red, black)."""
    diag = -2.0 * (h2[0] + h2[1] + h2[2])
    for c in ((1, 0) if reverse else (0, 1)):
        new = []
        for x, xp, bs, m in zip(u, _padded(u), b, masks):
            nb = (xp[..., 2:, :, :] + xp[..., :-2, :, :]) * h2[0]
            for a in (1, 2):
                nb = nb + (_roll(x, -1, a) + _roll(x, 1, a)) * h2[a]
            u_new = (bs - nb) / diag
            new.append(torch.where(m[c], _blend(x, u_new, relax), x))
        u = new
    return u


def _slab_masks(shape, d, devices):
    """Each slab's (red, black) of a level of ``shape`` split into ``d``
    slabs: parity from the slab's global x offset."""
    nxl = shape[0] // d
    out = []
    for j, dev in enumerate(devices):
        idx = [torch.arange(j * nxl, (j + 1) * nxl, device=dev),
               torch.arange(shape[1], device=dev),
               torch.arange(shape[2], device=dev)]
        red = (idx[0][:, None, None] + idx[1][None, :, None]
               + idx[2][None, None, :]) % 2 == 0
        out.append((red, ~red))
    return out


def _scatter(x, devices):
    """A whole field cut into x-slabs on ``devices``."""
    return [c.to(dev, memory_format=torch.contiguous_format, copy=True)
            for c, dev in zip(torch.chunk(x, len(devices), dim=-3), devices)]


def _slab_sum(fn, *parts):
    """sum over slabs of ``fn`` (a per-slab scalar), added in slab order
    on the first slab's device."""
    return slabs.fold(torch.add, [fn(*p) for p in zip(*parts)])


def _slab_mean(x):
    """The field's mean over its last three axes (one per leading index)
    on the first slab's device (the slabs are of equal size)."""
    return _slab_sum(lambda s: s.mean(dim=_AX, keepdim=True), x) / len(x)


def _minus_mean(x):
    """The slabs with the field's mean taken out."""
    m = _slab_mean(x)
    return [s - m.to(s.device) for s in x]


class _SlabHierarchy:
    """The unsharded hierarchy (on the first slab's device) and the split
    levels' per-slab masks."""

    def __init__(self, grid, opt, devices):
        self.whole = _Hierarchy(grid, opt, devices[0])
        self.devices = list(devices)
        d = len(devices)
        levels = self.whole.levels
        n = 0
        while n < len(levels) - 1 and levels[n].nx % d == 0 \
                and (levels[n].nx // d) % 2 == 0:
            n += 1
        self.n_split = n
        self.masks = [_slab_masks(g.shape, d, self.devices)
                      for g in levels[:n]]

    def vcycle(self, level, u, b, symmetric=False):
        """:meth:`_Hierarchy.vcycle` on the slabs of a split level."""
        opt, h2 = self.whole.opt, self.whole.h2[level]
        masks = self.masks[level]
        for _ in range(opt.n_pre_smooth):
            u = _smooth_rb_slabs(u, b, h2, masks, opt.smooth_relax)
        rc = [_restrict(bs - lap) for bs, lap in
              zip(b, _laplacian_slabs(u, h2))]
        if level + 1 < self.n_split:
            ec = self.vcycle(level + 1, [torch.zeros_like(r) for r in rc],
                             rc, symmetric)
        else:
            rw = slabs.whole(rc)
            ec = _scatter(self.whole.vcycle(level + 1, torch.zeros_like(rw),
                                            rw, symmetric), self.devices)
        u = [x + _prolong(e) for x, e in zip(u, ec)]
        for _ in range(opt.n_post_smooth):
            u = _smooth_rb_slabs(u, b, h2, masks, opt.smooth_relax,
                                 reverse=symmetric)
        return u


def _pcg_slabs(hier, b):
    """:func:`_pcg` on slabs, its inner products added in slab order."""
    opt, h2 = hier.whole.opt, hier.whole.h2[0]
    dot = lambda x, y: float(_slab_sum(lambda a, c: (a * c).sum(), x, y))
    u = [torch.zeros_like(x) for x in b]
    r = [x.clone() for x in b]
    bnorm = dot(b, b) ** 0.5
    if bnorm == 0.0:
        return u
    z = _minus_mean(hier.vcycle(0, [torch.zeros_like(x) for x in r], r,
                                symmetric=True))
    p = z
    rz = dot(r, z)
    for _ in range(opt.maxiter):
        q = _laplacian_slabs(p, h2)
        alpha = rz / dot(p, q)
        u = [x + alpha * y for x, y in zip(u, p)]
        r = [x - alpha * y for x, y in zip(r, q)]
        if dot(r, r) ** 0.5 <= opt.tol * bnorm:
            break
        z = _minus_mean(hier.vcycle(0, [torch.zeros_like(x) for x in r], r,
                                    symmetric=True))
        rz_new = dot(r, z)
        p = [x + (rz_new / rz) * y for x, y in zip(z, p)]
        rz = rz_new
    return u


def _poisson_slabs(grid, b, opt):
    """Poisson on x-slabs; with ``"direct"`` or ``"fft"`` the slabs may
    carry a leading axis of independent right-hand sides."""
    devices = [x.device for x in b]
    hier = _SlabHierarchy(grid, opt, devices)
    if opt.scheme == "fft" or hier.n_split == 0:
        w = slabs.whole(b)
        u = poisson_multigrid(grid, w, opt) if w.dim() == 3 else \
            torch.stack([poisson_multigrid(grid, x, opt) for x in w])
        return _scatter(u, devices)
    b = _minus_mean(b)
    if opt.scheme == "pcg":
        u = _pcg_slabs(hier, b)
    else:
        u = [torch.zeros_like(x) for x in b]
        for _ in range(opt.maxiter):
            u = hier.vcycle(0, u, b)
    return _minus_mean(u)


def poisson_multigrid(grid: Grid, b, opt: MGOptions = None):
    """Solve the periodic 7-point Poisson problem Lap(u) = b (b's mean
    taken out) with a zero-mean u (MultiGridLevel::run_direct,
    fibergen.cpp:7489-8917).  ``b`` whole or a list of x-slabs (u then
    too)."""
    opt = opt or MGOptions()
    if opt.scheme not in ("direct", "pcg", "fft"):
        raise ValueError(f"Unknown multigrid scheme '{opt.scheme}' (expected "
                         f"direct, pcg or fft)")
    if slabs.sharded(b):
        return _poisson_slabs(grid, b, opt)
    if opt.scheme == "fft":
        return _coarse_solve_fft(b, grid)
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

    tau: the (3, nx, ny, nz) force field; returns u (3, nx, ny, nz).  On
    x-slabs (``tau`` a list) the x differences take the neighbours' halo
    planes and u comes back as slabs."""
    opt = opt or MGOptions()
    hs = (grid.nx / grid.dx, grid.ny / grid.dy, grid.nz / grid.dz)
    if slabs.sharded(tau):
        return _g0_multigrid_slabs(grid, mu_0, lambda_0, tau, alpha, opt, hs)
    f = tau
    # negative forward divergence (divVector, fibergen.cpp:19983-20003)
    b = alpha * ((f[0] - _roll(f[0], -1, 0)) * hs[0]
                 + (f[1] - _roll(f[1], -1, 1)) * hs[1]
                 + (f[2] - _roll(f[2], -1, 2)) * hs[2])
    p = poisson_multigrid(grid, b, opt)
    c1, fac = _g0_factors(mu_0, lambda_0, alpha)
    us = []
    for i in range(3):
        c2 = -(1.0 / mu_0) * fac * hs[i]
        # p[k-1] - p[k] (fibergen.cpp:20042: p[k + _bfd] - p[k])
        dp = _roll(p, 1, i) - p
        us.append(poisson_multigrid(grid, c1 * f[i] + c2 * dp, opt))
    return torch.stack(us)


def _g0_factors(mu_0, lambda_0, alpha):
    lam0 = np.float64(lambda_0)
    with np.errstate(divide="ignore", invalid="ignore"):
        fac = float(1.0 - mu_0 / (2.0 * mu_0 + lam0))
    return alpha / mu_0, fac


def _g0_multigrid_slabs(grid, mu_0, lambda_0, f, alpha, opt, hs):
    """:func:`g0_multigrid_staggered` on the x-slabs of ``f``."""
    b = [alpha * ((x[0] - x0p[2:]) * hs[0]
                  + (x[1] - _roll(x[1], -1, 1)) * hs[1]
                  + (x[2] - _roll(x[2], -1, 2)) * hs[2])
         for x, x0p in zip(f, _padded([x[0] for x in f]))]
    p = poisson_multigrid(grid, b, opt)
    c1, fac = _g0_factors(mu_0, lambda_0, alpha)
    pp = _padded(p)
    # p[k-1] - p[k] (fibergen.cpp:20042: p[k + _bfd] - p[k])
    rhs = [torch.stack([
        c1 * x[i] + (-(1.0 / mu_0) * fac * hs[i]) * (
            (ps_p[:-2] if i == 0 else _roll(ps, 1, i)) - ps)
        for i in range(3)]) for x, ps, ps_p in zip(f, p, pp)]
    if opt.scheme == "pcg":
        # CG's steps differ from component to component: one at a time
        us = [poisson_multigrid(grid, [r[i] for r in rhs], opt)
              for i in range(3)]
        return [torch.stack(u) for u in zip(*us)]
    # the three displacement solves as one batch of right-hand sides
    return poisson_multigrid(grid, rhs, opt)
