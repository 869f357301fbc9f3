"""Phase containers and the Voigt mixing rule.

Equivalent of PhaseBase + VoigtMixedMaterialLaw (fibergen.cpp:12004-12062,
12729-12777).  Phases hold per-voxel volume-fraction tensors phi
(nx, ny, nz).  For all-isotropic linear phase sets the per-voxel moduli
mu(x) = sum phi_p mu_p and lam(x) = sum phi_p lam_p are formed once and
cached, so the stencil kernels read two moduli planes per voxel.  Fields
are dim 6 (elasticity, viscosity) or dim 3 (heat, porous flow, with scalar
laws: sigma = 2 mu(x) E).  Finite-strain (dim 9) phase sets mix each
phase's response phi-weighted: P = sum phi_p P_p(F), and likewise the
energy and the tangent.

On a sharded field (x-slabs, ``parallel/slabs.py``) the responses run
per slab: the mixed moduli and the phase fields are split into the same
slabs once (:meth:`VoigtMixed.iso_moduli_slabs`,
:meth:`VoigtMixed.phase_fields`), the stresses, the tangent, the energy
and the polarization are voxel-local, and the means and the eigenvalue
bounds reduce over the slabs.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from ..core import fields
from ..parallel import Mesh, shard_field, slabs
from . import laws

# voxels per chunk of the nonlinear tangent eigenvalue pass: the tangent of
# a chunk, (chunk, 9, 9), and its jvp intermediates stay at a few hundred MB
EIG_CHUNK = 1 << 18
# matrices per torch.linalg.eigvalsh call: on the card it calls cuSOLVER's
# batched symmetric eigensolver (cusolverDnXsyevBatched), which refuses a
# batch of 32768 or more 9x9 matrices (CUSOLVER_STATUS_INVALID_VALUE)
EIG_BATCH = 1 << 14


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
    (VoigtMixedMaterialLaw, fibergen.cpp:12729-12777) for phase sets whose
    laws all expose ``iso_moduli`` (dim 3 and 6) or are all hyperelastic
    (dim 9)."""

    rule = "voigt"

    def __init__(self, phases: List[Phase], dim: int = 6):
        if dim not in (3, 6, 9):
            raise NotImplementedError(f"dim {dim} is not ported (3, 6 and 9 "
                                      f"are)")
        if dim == 9 and not all(isinstance(p.law, laws.HyperelasticLaw)
                                for p in phases):
            raise NotImplementedError("dim 9 takes hyperelastic phase laws "
                                      "only")
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

    def iso_moduli_slabs(self, dtype, devices):
        """(mu(x), lam(x)) in ``dtype``, each split into the x-slabs of a
        mesh over ``devices``; cached beside the mixed moduli, so a solve
        splits them once."""
        iso = self._all_iso()
        if iso is None:
            raise NotImplementedError("only isotropic linear phases are ported")
        key = (dtype, tuple(torch.device(d) for d in devices))
        cache = getattr(self, "_iso_slabs", None)
        if cache is None or cache[0] is not self._iso_val or cache[1] != key:
            mesh = Mesh(key[1])
            self._iso_slabs = (self._iso_val, key, tuple(
                shard_field(t.to(dtype=dtype), mesh) for t in iso))
        return self._iso_slabs[2]

    def _moduli_like(self, F):
        """(mu(x), lam(x)) laid out as ``F``: in its type on its device, or
        split into its x-slabs."""
        if slabs.sharded(F):
            return self.iso_moduli_slabs(F[0].dtype, [f.device for f in F])
        return self.iso_moduli(F.dtype, F.device)

    def drop_phi(self):
        """Free the per-phase phi fields, keeping only the cached mixed
        moduli: the solve reads mu(x) and lam(x) only."""
        if self._all_iso() is None:
            raise ValueError("drop_phi requires all-isotropic linear phases")
        self._phi_dropped = True
        for p in self.phases:
            p.phi = None

    def phase_fields(self, F):
        """The phase fields phi laid out as ``F``, one entry per phase: in
        F's type on its device, or split into F's x-slabs (cached per type
        and devices, so a solve splits them once).  Raises after
        :meth:`drop_phi`."""
        if self._phi_dropped:
            raise ValueError("the phase-wise response needs the phase "
                             "fields phi, which drop_phi freed")
        if not slabs.sharded(F):
            return [p.phi.to(dtype=F.dtype, device=F.device)
                    for p in self.phases]
        phis = [p.phi for p in self.phases]
        key = (F[0].dtype, tuple(f.device for f in F))
        cache = getattr(self, "_phi_slabs", None)
        if cache is None or cache[1] != key or not all(
                a is b for a, b in zip(cache[0], phis)):
            mesh = Mesh(key[1])
            self._phi_slabs = (phis, key, [
                shard_field(phi.to(dtype=key[0]), mesh) for phi in phis])
        return self._phi_slabs[2]

    def _phase_sum(self, fn, *fields, comp=True):
        """sum_p phi_p fn(p.law, *fields) over the phases, phi laid out as
        the first field (:meth:`phase_fields`; a component axis in front of
        phi with ``comp``); on x-slabs slab by slab."""
        n = len(fields)

        def one(*args):
            out = None
            for p, phi in zip(self.phases, args[n:]):
                t = (phi[None] if comp else phi) * fn(p.law, *args[:n])
                out = t if out is None else out + t
            return out
        return slabs.smap(one, *fields, *self.phase_fields(fields[0]))

    def pk1(self, F):
        if self._dim == 9:
            return self._phase_sum(lambda law, F: law.pk1(F), F)
        return slabs.smap(self._pk1_iso, F, *self._moduli_like(F))

    def _pk1_iso(self, F, mu_x, lam_x):
        """The isotropic linear stress 2 mu(x) F + lam(x) tr(F) I (dim 6),
        2 mu(x) F (dim 3)."""
        two_mu = 2.0 * mu_x
        if self._dim == 3:
            return two_mu * F
        ltr = lam_x * (F[0] + F[1] + F[2])
        return torch.stack([two_mu * F[0] + ltr, two_mu * F[1] + ltr,
                            two_mu * F[2] + ltr]
                           + [two_mu * F[k] for k in range(3, self._dim)])

    def dpk1(self, F, W):
        """Directional derivative of P at F along W (dPK1,
        fibergen.cpp:10338); dim 9 only (the linear path reads the mixed
        moduli)."""
        return self._phase_sum(lambda law, F, W: law.dpk1(F, W), F, W)

    def w(self, F):
        """Stored energy density per voxel (W, dim 9)."""
        return self._phase_sum(lambda law, F: law.w(F), F, comp=False)

    def mean_pk1(self, F):
        """<P(F)> over voxels (meanPK1, fibergen.cpp:12312); on x-slabs a
        list with the mean on every slab's device."""
        return fields.mean(self.pk1(F))

    def mean_w(self, F):
        """<W(F)> over voxels (meanW, fibergen.cpp:12239)."""
        return slabs.vmean(torch.mean, self.w(F))

    def mean_cauchy(self, F):
        """<sigma> with sigma = P F^T / det F pushed forward per voxel; the
        stress itself below dim 9."""
        if self._dim != 9:
            return self.mean_pk1(F)
        return fields.mean(slabs.smap(laws.cauchy_from_pk1_comp, self.pk1(F),
                                      F))

    def polarization(self, mu_0, F, inv=False):
        """Eyre-Milton transform, each phase's law phi-weighted
        (fibergen.cpp:12087-12099; exact for sharp 0/1 phase fields).  Needs
        the phase fields: raises after :meth:`drop_phi`."""
        return self._phase_sum(
            lambda law, F: law.polarization(mu_0, F, inv), F)

    def stress_diff(self, F, mu_0, lambda_0):
        """(C - C0) : F (calcStressDiff, fibergen.cpp:18030) with the moduli
        shift folded into the mixed coefficients; in dim 9 the generic
        P(F) - 2 mu_0 F - lambda_0 tr(F) I.  On x-slabs (dim 3 and 6) per
        slab."""
        if self._dim == 9:
            tau = self.pk1(F) - 2.0 * mu_0 * F
            if lambda_0 != 0.0:
                tau[0:3] -= lambda_0 * (F[0] + F[1] + F[2])
            return tau
        return slabs.smap(stress_diff_iso, F, *self._moduli_like(F), mu_0,
                          lambda_0)

    def eig_range(self, F=None, zero_trace=False, devices=None):
        """Per-voxel tangent eigenvalue bounds reduced over the grid
        (getRefMaterial, fibergen.cpp:12153-12236), as 0-d tensors: the
        isotropic tangent has eigenvalues {2 mu, 2 mu + 3 lam}; without
        row and column 0 (``zero_trace``, viscosity) {2 mu, 2 mu + 2 lam};
        a scalar law's (dim 3) is 2 mu.  Dim 9: the eigenvalues of the
        symmetrized 9x9 tangent at ``F`` (:meth:`_eig_range_nonlinear`),
        on the x-slabs of a sharded F per slab.  With ``devices`` (dim 3
        and 6) the bounds of each x-slab of the moduli on a mesh over them.
        Bounds of slabs are reduced over the slabs."""
        if self._dim == 9:
            return _reduce_bounds(slabs.smap(
                lambda F, *phis: self._eig_range_nonlinear(F, zero_trace,
                                                           phis=phis),
                F, *self.phase_fields(F)))
        if devices is not None:
            mus, lams = self.iso_moduli_slabs(self._all_iso()[0].dtype,
                                              devices)
            return _reduce_bounds(slabs.smap(
                lambda m, lm: self._eig_range_iso(m, lm, zero_trace), mus,
                lams))
        return self._eig_range_iso(*self._all_iso(), zero_trace)

    def _eig_range_iso(self, mu_x, lam_x, zero_trace):
        e1 = 2.0 * mu_x
        if self._dim == 3:
            return e1.min(), e1.max()
        e2 = 2.0 * mu_x + (2.0 if zero_trace else 3.0) * lam_x
        return torch.minimum(e1, e2).min(), torch.maximum(e1, e2).max()

    def _eig_range_nonlinear(self, F, zero_trace, chunk=EIG_CHUNK,
                             phis=None):
        """min and max eigenvalue of the symmetrized per-voxel tangent
        dP/dF at a whole F or one slab of it (the reference's per-voxel
        LAPACK syev loop, fibergen.cpp:12472-12530), with the phase fields
        ``phis`` laid out as F (the whole ones by default), in flat voxel
        chunks: per chunk the nine columns dP[e_j] come from one jvp per
        phase, batched over the unit directions with ``torch.func.vmap``,
        and ``torch.linalg.eigvalsh`` takes the (chunk, 9, 9) matrices
        ``EIG_BATCH`` at a time."""
        dim = self._dim
        n = F[0].numel()
        Ff = F.reshape(dim, n)
        phis = [torch.broadcast_to(phi, F.shape[1:]).reshape(n)
                for phi in (self.phase_fields(F) if phis is None else phis)]
        eye = torch.eye(dim, dtype=F.dtype, device=F.device)
        lo = hi = None
        for s in range(0, n, chunk):
            Fk = Ff[:, s:s + chunk].contiguous()
            Ws = eye[:, :, None].expand(dim, dim, Fk.shape[1])
            T = None
            for p, phi in zip(self.phases, phis):
                cols = torch.func.vmap(
                    lambda w, law=p.law: law.dpk1(Fk, w))(Ws)
                t = phi[s:s + chunk] * cols         # (j, i, voxel)
                T = t if T is None else T + t
            T = T.permute(2, 1, 0)                   # (voxel, i, j)
            T = 0.5 * (T + T.transpose(1, 2))
            if zero_trace:
                T = T[:, 1:, 1:]
            for b in range(0, T.shape[0], EIG_BATCH):
                e = torch.linalg.eigvalsh(T[b:b + EIG_BATCH])
                emin, emax = e.min(), e.max()
                lo = emin if lo is None else torch.minimum(lo, emin)
                hi = emax if hi is None else torch.maximum(hi, emax)
            del T, e
        return lo, hi

    def __str__(self):
        return f"{self.rule} mixed ({len(self.phases)} phases)"


def _reduce_bounds(b):
    """(min, max) over per-slab (lo, hi) bounds, taken on the first slab's
    device; whole bounds as they are."""
    if not slabs.sharded(b):
        return b
    return (slabs.fold(torch.minimum, [lo for lo, _ in b]),
            slabs.fold(torch.maximum, [hi for _, hi in b]))


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
