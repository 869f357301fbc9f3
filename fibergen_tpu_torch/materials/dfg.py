"""The doubly-fine grid: constitutive laws evaluated on a 2x refined grid.

Port of fibergen_tpu/materials/dfg.py, the reference's half/full staggered
schemes (use_dfg, fibergen.cpp:14894; prolongate_to_dfg and
restrict_from_dfg, fibergen.cpp:14214-14341): the staggered discretization
stores the shear components at edge-centred positions, so the phases are
voxelized at twice the resolution, each Voigt component of the strain is
prolongated with its own half-voxel shift (nearest with shift), the law is
evaluated on the fine grid, and the stress is restricted back by a shifted
8-point average.  Dims 3 and 6.
"""
from __future__ import annotations

import torch

from ..core.grid import Grid
from .mixing import MixedMaterial

# per-Voigt-component shifts (fibergen.cpp:14231-14233): diagonal
# components at cell centres, shears at the edge-centred positions
_SHIFTS = {
    3: [(0, 0, 0)] * 3,
    6: [(0, 0, 0), (0, 0, 0), (0, 0, 0),
        (0, 1, 1), (1, 0, 1), (1, 1, 0)],
}


def _shifted(shift):
    """(shifts, dims) of the axes a component is shifted along."""
    dims = tuple(d for d, s in zip((-3, -2, -1), shift) if s)
    return tuple(1 for _ in dims), dims


def _prolong_comp(x, shift):
    """Nearest-neighbour 2x upsample with a half-voxel shift,
    dest[i] = src[((i + s) mod 2n) / 2] (fibergen.cpp:14244-14266)."""
    nx, ny, nz = x.shape
    out = x[:, None, :, None, :, None].expand(nx, 2, ny, 2, nz, 2).reshape(
        2 * nx, 2 * ny, 2 * nz)
    shifts, dims = _shifted(shift)
    return torch.roll(out, [-s for s in shifts], dims) if dims else out


def _restrict_comp(y, shift):
    """The mean over each 2x2x2 block of the fine component, shifted back
    by its half voxel."""
    shifts, dims = _shifted(shift)
    if dims:
        y = torch.roll(y, shifts, dims)
    nx, ny, nz = (n // 2 for n in y.shape)
    return y.reshape(nx, 2, ny, 2, nz, 2).sum(dim=(1, 3, 5)) / 8.0


def _check_dim(dim):
    if dim not in _SHIFTS:
        raise NotImplementedError(
            f"the doubly-fine grid of dim-{dim} fields is not ported yet "
            f"(ROADMAP.md, Queue 1 item 5); dims 3 and 6 are")


def prolong(F):
    """A (dim, nx, ny, nz) field on the doubly-fine (dim, 2nx, 2ny, 2nz)
    grid."""
    _check_dim(F.shape[0])
    shifts = _SHIFTS[F.shape[0]]
    return torch.stack([_prolong_comp(F[g], shifts[g])
                        for g in range(F.shape[0])])


def restrict(Y):
    """A (dim, 2nx, 2ny, 2nz) field back on the coarse grid."""
    _check_dim(Y.shape[0])
    shifts = _SHIFTS[Y.shape[0]]
    return torch.stack([_restrict_comp(Y[g], shifts[g])
                        for g in range(Y.shape[0])])


def fine_grid(grid: Grid) -> Grid:
    """The doubly-fine grid of ``grid``: twice the voxels, the same cell
    and origin."""
    return Grid(2 * grid.nx, 2 * grid.ny, 2 * grid.nz, grid.dx, grid.dy,
                grid.dz, grid.x0)


class DfgMaterial:
    """A mixed material whose phase fields live on the doubly-fine grid,
    seen from the coarse grid: every evaluation is prolongate -> fine-grid
    law -> restrict (calcStress with use_dfg, fibergen.cpp:18134-18149).
    The means (meanPK1 with dfg, fibergen.cpp:17793-17811), the energy and
    the reference material's bounds are taken on the fine grid.  It never
    takes the isotropic K1/K2 route.  A delegate, not a mixed material:
    it offers the methods the solvers call and forwards each to ``inner``
    on the fine grid."""

    rule = "dfg"

    def __init__(self, inner: MixedMaterial):
        _check_dim(inner.dim)
        self.inner = inner
        # the same phase list: fine phi fields assigned through it reach
        # the inner material
        self.phases = inner.phases

    @property
    def dim(self):
        return self.inner.dim

    def iso_route(self):
        return False

    def state(self):
        return self.inner.state()

    def pk1(self, F):
        return restrict(self.inner.pk1(prolong(F)))

    def stress_diff(self, F, mu_0, lambda_0):
        return restrict(self.inner.stress_diff(prolong(F), mu_0, lambda_0))

    def dpk1(self, F, W):
        return restrict(self.inner.dpk1(prolong(F), prolong(W)))

    def w(self, F):
        """The energy density on the fine grid."""
        return self.inner.w(prolong(F))

    def mean_w(self, F):
        return self.inner.w(prolong(F)).mean()

    def mean_pk1(self, F):
        return self.inner.pk1(prolong(F)).mean(dim=(-3, -2, -1))

    def mean_cauchy(self, F):
        return self.inner.mean_cauchy(prolong(F))

    def polarization(self, mu_0, F, inv=False):
        return restrict(self.inner.polarization(mu_0, prolong(F), inv))

    def eig_range(self, F=None, zero_trace=False, devices=None):
        return self.inner.eig_range(None if F is None else prolong(F),
                                    zero_trace, devices)

    def __str__(self):
        return f"dfg({self.inner})"
