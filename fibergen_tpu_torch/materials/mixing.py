"""Phase containers and the Voigt mixing rule on the all-isotropic path.

Equivalent of PhaseBase + VoigtMixedMaterialLaw (fibergen.cpp:12004-12062,
12729-12777).  Phases hold per-voxel volume-fraction tensors phi
(nx, ny, nz).  For all-isotropic phase sets the per-voxel moduli
mu(x) = sum phi_p mu_p and lam(x) = sum phi_p lam_p are formed once and
cached, so the stencil kernels read two moduli planes per voxel.  Fields
are dim 6 (elasticity, viscosity) or dim 3 (heat, porous flow, with scalar
laws: sigma = 2 mu(x) E).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from ..core import fields


@dataclasses.dataclass
class Phase:
    """Per-phase state: name, law, volume-fraction field
    (PhaseBase, fibergen.cpp:12004-12062)."""

    name: str
    law: object
    phi: Optional[torch.Tensor] = None  # (nx, ny, nz)
    index: int = 0


class VoigtMixed:
    """Arithmetic (Voigt) stress averaging P = sum_p phi_p P_p(F)
    (VoigtMixedMaterialLaw, fibergen.cpp:12729-12777), restricted to phase
    sets whose laws all expose ``iso_moduli``."""

    rule = "voigt"

    def __init__(self, phases: List[Phase], dim: int = 6):
        if dim not in (3, 6):
            raise NotImplementedError(f"dim {dim} is not ported (3 and 6 are)")
        self._dim = dim
        self.phases = []
        self._iso_key = None
        self._iso_val = None
        self._phi_dropped = False
        for p in phases:
            p.index = len(self.phases)
            self.phases.append(p)

    @property
    def dim(self):
        return self._dim

    def _all_iso(self):
        """Per-voxel (mu(x), lam(x)) if every phase law exposes
        ``iso_moduli``, else None.  Cached on the identity of the phi
        tensors."""
        phis = [p.phi for p in self.phases]
        if self._iso_key is not None and (
                self._phi_dropped
                or all(a is b for a, b in zip(self._iso_key, phis))):
            return self._iso_val
        mus, lams = [], []
        for p in self.phases:
            f = getattr(p.law, "iso_moduli", None)
            if f is None:
                return None
            mu, lam = f()
            mus.append(mu)
            lams.append(lam)
        mu_x = sum(p.phi * m for p, m in zip(self.phases, mus))
        lam_x = sum(p.phi * lm for p, lm in zip(self.phases, lams))
        self._iso_key = phis
        self._iso_val = (mu_x, lam_x)
        return self._iso_val

    def iso_moduli(self, dtype, device):
        """(mu(x), lam(x)) contiguous in ``dtype`` on ``device``; the
        conversion is cached beside the mixed moduli."""
        iso = self._all_iso()
        if iso is None:
            raise NotImplementedError("only isotropic linear phases are ported")
        key = (dtype, torch.device(device))
        cache = getattr(self, "_iso_cast", None)
        if cache is None or cache[0] is not self._iso_val or cache[1] != key:
            mu_x, lam_x = (t.to(device=device, dtype=dtype).contiguous()
                           for t in iso)
            self._iso_cast = (self._iso_val, key, (mu_x, lam_x))
        return self._iso_cast[2]

    def drop_phi(self):
        """Free the per-phase phi fields, keeping only the cached mixed
        moduli: the solve reads mu(x) and lam(x) only."""
        if self._all_iso() is None:
            raise ValueError("drop_phi requires all-isotropic linear phases")
        self._phi_dropped = True
        for p in self.phases:
            p.phi = None

    def pk1(self, F):
        mu_x, lam_x = self.iso_moduli(F.dtype, F.device)
        two_mu = 2.0 * mu_x
        if self._dim == 3:
            return two_mu * F
        ltr = lam_x * (F[0] + F[1] + F[2])
        return torch.stack([two_mu * F[0] + ltr, two_mu * F[1] + ltr,
                            two_mu * F[2] + ltr]
                           + [two_mu * F[k] for k in range(3, self._dim)])

    def mean_pk1(self, F):
        """<P(F)> over voxels (meanPK1, fibergen.cpp:12312)."""
        return fields.mean(self.pk1(F))

    def stress_diff(self, F, mu_0, lambda_0):
        """(C - C0) : F (calcStressDiff, fibergen.cpp:18030) with the moduli
        shift folded into the mixed coefficients."""
        mu_x, lam_x = self.iso_moduli(F.dtype, F.device)
        return stress_diff_iso(F, mu_x, lam_x, mu_0, lambda_0)

    def eig_range(self, zero_trace=False):
        """Per-voxel tangent eigenvalue bounds reduced over the grid
        (getRefMaterial, fibergen.cpp:12153-12236): the isotropic tangent
        has eigenvalues {2 mu, 2 mu + 3 lam}; without row and column 0
        (``zero_trace``, viscosity) {2 mu, 2 mu + 2 lam}; a scalar law's
        (dim 3) is 2 mu."""
        mu_x, lam_x = self._all_iso()
        e1 = 2.0 * mu_x
        if self._dim == 3:
            return e1.min(), e1.max()
        e2 = 2.0 * mu_x + (2.0 if zero_trace else 3.0) * lam_x
        return torch.minimum(e1, e2).min(), torch.maximum(e1, e2).max()

    def __str__(self):
        return f"{self.rule} mixed ({len(self.phases)} phases)"


def stress_diff_iso(F, mu_x, lam_x, mu_0, lambda_0):
    """tau = 2(mu(x) - mu_0) F + (lam(x) - lambda_0) tr(F) I on a dim-6
    field; tau = 2(mu(x) - mu_0) F on a dim-3 field."""
    two_dmu = 2.0 * (mu_x - mu_0)
    if F.shape[0] == 3:
        return two_dmu * F
    ltr = (lam_x - lambda_0) * (F[0] + F[1] + F[2])
    return torch.stack([two_dmu * F[0] + ltr, two_dmu * F[1] + ltr,
                        two_dmu * F[2] + ltr]
                       + [two_dmu * F[k] for k in range(3, F.shape[0])])
