"""Linear constitutive laws: isotropic elasticity and the scalar law of
heat conduction, porous flow and viscosity (fluidity).

Laws act on whole Voigt fields ``(dim, nx, ny, nz)``; dim-6 strains store
tensor shear components (core.voigt).
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class LinearIsotropic:
    """sigma = 2 mu eps + lambda tr(eps) I  (fibergen.cpp:11354-11474)."""

    mu: float
    lam: float
    dim: int = 6
    is_linear: bool = True

    def pk1(self, F):
        tr = self.lam * (F[0] + F[1] + F[2])
        out = 2.0 * self.mu * F
        return torch.cat([out[0:3] + tr, out[3:]])

    def eig_range_const(self):
        """(lmin, lmax) of the Voigt tangent (getRefMaterial bounds,
        fibergen.cpp:12153-12236)."""
        e = (2.0 * self.mu, 2.0 * self.mu + 3.0 * self.lam)
        return (min(e), max(e))

    def iso_moduli(self):
        return (self.mu, self.lam)

    def __str__(self):
        return f"linear isotropic lambda={self.lam:g} mu={self.mu:g}"


@dataclasses.dataclass
class ScalarLinearIsotropic:
    """Scalar conductivity/fluidity law sigma = mu * E on dim-3 fields
    (fibergen.cpp:11161-11228).  Also used for viscosity (dim 6)."""

    mu: float
    dim: int = 3
    is_linear: bool = True

    def pk1(self, F):
        return self.mu * F

    def eig_range_const(self):
        return (self.mu, self.mu)

    def iso_moduli(self):
        return (0.5 * self.mu, 0.0)  # C = mu * I == 2*(mu/2)*Id with lam=0

    def __str__(self):
        return f"scalar linear isotropic mu={self.mu:g}"
