"""Real-space staggered-grid finite-difference operators (plain PyTorch).

The reference's epsOperatorStaggered / divOperatorStaggered
(fibergen.cpp:18614-18908) as periodic rolls.  These are the plain forms
that the stencil kernels (ops/stencil_kernels.py) are checked against.

    D+ f = (f(i+1) - f(i)) * n/d      forward difference
    D- f = (f(i) - f(i-1)) * n/d      backward difference

eps uses D+ on the diagonal and D- on the shear terms; div uses D- on the
diagonal and D+ on the shear terms (adjoint pair).  The scalar (heat and
porous) pair uses D+ for the gradient and D- for the divergence, and the
finite-strain pair (full gradient, divergence of a full tensor) mixes them
as the symmetric pair does; both pairs stay plain PyTorch on every device,
as the JAX package computes them outside any Pallas kernel.

On an x-slab of a sharded field (``parallel/``) each pair takes
``halo=(minus, plus)``, the neighbouring slabs' x-planes
(``comm.halo_x``): the stencil runs on the slab with its halo planes
attached, and the two outer planes are dropped.  ``grid`` is the whole
grid (its n/d per axis).
"""
from __future__ import annotations

import torch

_AX = (-3, -2, -1)


def _dp(f, axis, h):
    """Forward difference along spatial axis (0=x, 1=y, 2=z)."""
    return (torch.roll(f, -1, dims=_AX[axis]) - f) * h


def _dm(f, axis, h):
    """Backward difference along spatial axis."""
    return (f - torch.roll(f, 1, dims=_AX[axis])) * h


def with_halo(fn, field, halo):
    """``fn`` of the slab ``field`` (x at axis -3) with its ``halo=(minus,
    plus)`` planes attached, minus those two planes."""
    ext = torch.cat([halo[0], field, halo[1]], dim=-3)
    return fn(ext).narrow(-3, 1, field.shape[-3]).contiguous()


def hs(grid):
    """Inverse voxel sizes n/d per axis."""
    return (grid.nx / grid.dx, grid.ny / grid.dy, grid.nz / grid.dz)


def eps_staggered(grid, E, u, halo=None):
    """Symmetrized staggered gradient of displacement + mean strain E
    (fibergen.cpp:18614-18692).  u: (3,nx,ny,nz), E: (6,), returns (6,...)."""
    if halo is not None:
        return with_halo(lambda x: eps_staggered(grid, E, x), u, halo)
    hx, hy, hz = hs(grid)
    ux, uy, uz = u[0], u[1], u[2]
    return torch.stack([
        E[0] + _dp(ux, 0, hx),
        E[1] + _dp(uy, 1, hy),
        E[2] + _dp(uz, 2, hz),
        E[3] + 0.5 * (_dm(uz, 1, hy) + _dm(uy, 2, hz)),
        E[4] + 0.5 * (_dm(uz, 0, hx) + _dm(ux, 2, hz)),
        E[5] + 0.5 * (_dm(uy, 0, hx) + _dm(ux, 1, hy)),
    ])


def div_staggered(grid, tau, halo=None):
    """Staggered divergence of a symmetric tensor field (6 comps), backward
    differences on the diagonal, forward on the shear terms
    (fibergen.cpp:18853-18908).  Returns (3, nx, ny, nz)."""
    if halo is not None:
        return with_halo(lambda x: div_staggered(grid, x), tau, halo)
    hx, hy, hz = hs(grid)
    return torch.stack([
        _dm(tau[0], 0, hx) + _dp(tau[5], 1, hy) + _dp(tau[4], 2, hz),
        _dp(tau[5], 0, hx) + _dm(tau[1], 1, hy) + _dp(tau[3], 2, hz),
        _dp(tau[4], 0, hx) + _dp(tau[3], 1, hy) + _dm(tau[2], 2, hz),
    ])


def eps_staggered_comp(grid, u, c):
    """Voigt component ``c`` of ``eps_staggered(grid, 0, u)``, without the
    other five (the low-memory CG reads the gradient one component at a
    time, so no 6-component field is formed)."""
    hx, hy, hz = hs(grid)
    ux, uy, uz = u[0], u[1], u[2]
    if c == 0:
        return _dp(ux, 0, hx)
    if c == 1:
        return _dp(uy, 1, hy)
    if c == 2:
        return _dp(uz, 2, hz)
    if c == 3:
        return 0.5 * (_dm(uz, 1, hy) + _dm(uy, 2, hz))
    if c == 4:
        return 0.5 * (_dm(uz, 0, hx) + _dm(ux, 2, hz))
    return 0.5 * (_dm(uy, 0, hx) + _dm(ux, 1, hy))


def div_stress_diff_comp(grid, p, two_dmu, ltr, i):
    """Row ``i`` of ``div_staggered((C(x) - C0) : p)`` for per-voxel
    isotropic moduli, the 6-component stress never formed: ``two_dmu`` =
    2 (mu(x) - mu_0), ``ltr`` = (lam(x) - lam_0) tr(p) (0.0 when both
    lambdas vanish); ``p`` a sequence of six components."""
    hx, hy, hz = hs(grid)

    def t(c):
        s = two_dmu * p[c]
        return s + ltr if c < 3 else s

    if i == 0:
        return _dm(t(0), 0, hx) + _dp(t(5), 1, hy) + _dp(t(4), 2, hz)
    if i == 1:
        return _dp(t(5), 0, hx) + _dm(t(1), 1, hy) + _dp(t(3), 2, hz)
    return _dp(t(4), 0, hx) + _dp(t(3), 1, hy) + _dm(t(2), 2, hz)


def eps_staggered_heat(grid, E, u, halo=None):
    """Staggered gradient of a scalar potential + mean gradient E
    (fibergen.cpp:18697-18758).  u: (1,nx,ny,nz), E: (3,), returns (3,...)."""
    if halo is not None:
        return with_halo(lambda x: eps_staggered_heat(grid, E, x), u, halo)
    hx, hy, hz = hs(grid)
    p = u[0]
    return torch.stack([E[0] + _dp(p, 0, hx), E[1] + _dp(p, 1, hy),
                        E[2] + _dp(p, 2, hz)])


def div_staggered_heat(grid, tau, halo=None):
    """Staggered divergence of a vector field into a scalar, backward
    differences (fibergen.cpp:18914-18968).  Returns (1, nx, ny, nz)."""
    if halo is not None:
        return with_halo(lambda x: div_staggered_heat(grid, x), tau, halo)
    hx, hy, hz = hs(grid)
    return (_dm(tau[0], 0, hx) + _dm(tau[1], 1, hy)
            + _dm(tau[2], 2, hz))[None]


def eps_staggered_hyper(grid, E, u, halo=None):
    """Full (unsymmetrized) staggered gradient of displacement + mean
    deformation gradient E (fibergen.cpp:18763-18847).  u: (3,nx,ny,nz),
    E: (9,), returns (9, ...) in the dim-9 component order."""
    if halo is not None:
        return with_halo(lambda x: eps_staggered_hyper(grid, E, x), u, halo)
    hx, hy, hz = hs(grid)
    ux, uy, uz = u[0], u[1], u[2]
    return torch.stack([
        E[0] + _dp(ux, 0, hx),
        E[1] + _dp(uy, 1, hy),
        E[2] + _dp(uz, 2, hz),
        E[3] + _dm(uy, 2, hz),   # F_yz = d_z u_y
        E[4] + _dm(ux, 2, hz),   # F_xz
        E[5] + _dm(ux, 1, hy),   # F_xy
        E[6] + _dm(uz, 1, hy),   # F_zy
        E[7] + _dm(uz, 0, hx),   # F_zx
        E[8] + _dm(uy, 0, hx),   # F_yx
    ])


def div_staggered_hyper(grid, tau, halo=None):
    """Staggered divergence of a full (9-component) tensor field, row i
    from tau[i, :] (fibergen.cpp:19016-19071).  Returns (3, nx, ny, nz)."""
    if halo is not None:
        return with_halo(lambda x: div_staggered_hyper(grid, x), tau, halo)
    hx, hy, hz = hs(grid)
    return torch.stack([
        _dm(tau[0], 0, hx) + _dp(tau[5], 1, hy) + _dp(tau[4], 2, hz),
        _dp(tau[8], 0, hx) + _dm(tau[1], 1, hy) + _dp(tau[3], 2, hz),
        _dp(tau[7], 0, hx) + _dp(tau[6], 1, hy) + _dm(tau[2], 2, hz),
    ])
