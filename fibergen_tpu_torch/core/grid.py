"""Periodic voxel grid description and Fourier frequency tables.

Fields are torch tensors of shape ``(ncomp, nx, ny, nz)``; the Fourier-domain
(rfft) shape is ``(ncomp, nx, ny, nz//2 + 1)``.  The tables are host numpy
arrays: the operators turn them into device tensors once per grid and dtype.
"""
from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np


def _freq_index(n: int) -> np.ndarray:
    """Signed integer frequency index per FFT bin (fibergen.cpp:19093-19098).

    For even n the Nyquist bin maps to -n/2 (matching ii_half = n/2 - 1)."""
    k = np.arange(n)
    half = (n // 2 - 1) if n % 2 == 0 else n // 2
    return np.where(k <= half, k, k - n).astype(np.float64)


def _rfreq_index(n: int) -> np.ndarray:
    """Signed frequency index for the rfft (half) axis of length n//2+1."""
    return _freq_index(n)[: n // 2 + 1].copy() if n > 1 else np.zeros(1)


@dataclasses.dataclass(frozen=True)
class Grid:
    """Static description of the periodic RVE voxel grid: voxel counts
    ``nx, ny, nz`` and physical edge lengths ``dx, dy, dz``
    (fibergen.cpp:14661-14668)."""

    nx: int
    ny: int
    nz: int
    dx: float = 1.0
    dy: float = 1.0
    dz: float = 1.0
    x0: tuple = (0.0, 0.0, 0.0)

    @property
    def shape(self):
        return (self.nx, self.ny, self.nz)

    @property
    def nzc(self):
        return self.nz // 2 + 1

    @property
    def rshape(self):
        """Fourier-domain (rfft) shape."""
        return (self.nx, self.ny, self.nzc)

    @property
    def spacing(self):
        """Voxel edge lengths (dx/nx, dy/ny, dz/nz)."""
        return (self.dx / self.nx, self.dy / self.ny, self.dz / self.nz)

    @property
    def nxyz(self):
        return self.nx * self.ny * self.nz

    # Tables broadcast over the trailing three axes of a field:
    # x -> (nx,1,1), y -> (ny,1), z -> (nzc,).

    @cached_property
    def freq_index(self):
        """Signed integer FFT frequency indices (fx, fy, fz)."""
        fx = _freq_index(self.nx).reshape(self.nx, 1, 1)
        fy = _freq_index(self.ny).reshape(self.ny, 1)
        fz = _rfreq_index(self.nz)
        return fx, fy, fz

    def xi(self, two_pi=False):
        """Continuous wavenumbers xi_a = f_a / d_a (optionally * 2 pi) of
        the collocated Green operators, which use only their ratios
        (fibergen.cpp:19386)."""
        fx, fy, fz = self.freq_index
        s = 2.0 * np.pi if two_pi else 1.0
        return (fx * (s / self.dx), fy * (s / self.dy), fz * (s / self.dz))

    def xi_staggered(self):
        """Half-shifted phases of the staggered-grid G0 operator:
        xi_a = pi * f_a / n_a (fibergen.cpp:19838-19839)."""
        fx, fy, fz = self.freq_index
        return (
            fx * (np.pi / self.nx),
            fy * (np.pi / self.ny),
            fz * (np.pi / self.nz),
        )

    def staggered_h(self):
        """Half voxel sizes h_a = d_a / (2 n_a) (fibergen.cpp:19838)."""
        return (
            self.dx / (2 * self.nx),
            self.dy / (2 * self.ny),
            self.dz / (2 * self.nz),
        )
