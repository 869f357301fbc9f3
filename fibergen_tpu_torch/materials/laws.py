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

    def polarization(self, mu_0, F, inv=False):
        """Eyre-Milton transform (C - C0)(C + C0)^{-1} F with C0 = 2 mu_0 Id,
        or (C + C0)^{-1} F with ``inv`` (calcPolarization,
        fibergen.cpp:10414-10445, 11427-11467).  (C + C0)^{-1} =
        Id/m - lam/(m (3 lam + m)) II with m = 2 (mu + mu_0)."""
        m = 2.0 * (self.mu + mu_0)
        b = self.lam / (m * (3.0 * self.lam + m))
        P = (1.0 / m) * F
        P = torch.cat([P[0:3] - b * (F[0] + F[1] + F[2]), P[3:]])
        if inv:
            return P
        trP = self.lam * (P[0] + P[1] + P[2])
        P = 2.0 * (self.mu - mu_0) * P
        return torch.cat([P[0:3] + trP, P[3:]])

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

    def polarization(self, mu_0, F, inv=False):
        """Eyre-Milton transform of C = mu I against C0 = 2 mu_0 I: the law's
        own mu, not the halved ``iso_moduli`` one (calcPolarization)."""
        denom = self.mu + 2.0 * mu_0
        if inv:
            return F / denom
        return (self.mu - 2.0 * mu_0) / denom * F

    def __str__(self):
        return f"scalar linear isotropic mu={self.mu:g}"
