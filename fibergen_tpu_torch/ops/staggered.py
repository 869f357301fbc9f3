"""Real-space staggered-grid finite-difference operators (plain PyTorch).

The reference's epsOperatorStaggered / divOperatorStaggered
(fibergen.cpp:18614-18908) as periodic rolls.  These are the plain forms
that the stencil kernels (ops/stencil_kernels.py) are checked against.

    D+ f = (f(i+1) - f(i)) * n/d      forward difference
    D- f = (f(i) - f(i-1)) * n/d      backward difference

eps uses D+ on the diagonal and D- on the shear terms; div uses D- on the
diagonal and D+ on the shear terms (adjoint pair).  The scalar (heat and
porous) pair uses D+ for the gradient and D- for the divergence; it stays
plain PyTorch on every device, as the JAX package computes it outside any
Pallas kernel.
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


def hs(grid):
    """Inverse voxel sizes n/d per axis."""
    return (grid.nx / grid.dx, grid.ny / grid.dy, grid.nz / grid.dz)


def eps_staggered(grid, E, u):
    """Symmetrized staggered gradient of displacement + mean strain E
    (fibergen.cpp:18614-18692).  u: (3,nx,ny,nz), E: (6,), returns (6,...)."""
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


def div_staggered(grid, tau):
    """Staggered divergence of a symmetric tensor field (6 comps), backward
    differences on the diagonal, forward on the shear terms
    (fibergen.cpp:18853-18908).  Returns (3, nx, ny, nz)."""
    hx, hy, hz = hs(grid)
    return torch.stack([
        _dm(tau[0], 0, hx) + _dp(tau[5], 1, hy) + _dp(tau[4], 2, hz),
        _dp(tau[5], 0, hx) + _dm(tau[1], 1, hy) + _dp(tau[3], 2, hz),
        _dp(tau[4], 0, hx) + _dp(tau[3], 1, hy) + _dm(tau[2], 2, hz),
    ])


def eps_staggered_heat(grid, E, u):
    """Staggered gradient of a scalar potential + mean gradient E
    (fibergen.cpp:18697-18758).  u: (1,nx,ny,nz), E: (3,), returns (3,...)."""
    hx, hy, hz = hs(grid)
    p = u[0]
    return torch.stack([E[0] + _dp(p, 0, hx), E[1] + _dp(p, 1, hy),
                        E[2] + _dp(p, 2, hz)])


def div_staggered_heat(grid, tau):
    """Staggered divergence of a vector field into a scalar, backward
    differences (fibergen.cpp:18914-18968).  Returns (1, nx, ny, nz)."""
    hx, hy, hz = hs(grid)
    return (_dm(tau[0], 0, hx) + _dm(tau[1], 1, hy)
            + _dm(tau[2], 2, hz))[None]
