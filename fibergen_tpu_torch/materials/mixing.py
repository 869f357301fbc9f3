"""Phase containers and the mixing rules of composite voxels.

Equivalent of PhaseBase + MixedMaterialLaw* (fibergen.cpp:12004-14342).
Phases hold per-voxel volume-fraction tensors phi (nx, ny, nz); a mixing
rule defines the response where 0 < phi < 1.  :class:`MixedMaterial` is
the generic material: the stress, energy and tangent are sums over the
phases weighted per voxel (by phi for the Voigt rule, by a selection for
the Maximum, Random and 50-50 rules), and the stress difference is
P(F) - 2 mu_0 F - lambda_0 tr(F) I.  A rule whose response is an
isotropic law with per-voxel moduli (Voigt and Reuss over isotropic linear
phases, ``_iso_linear``) forms mu(x) and lam(x) once and caches them, so
the stencil kernels read two moduli planes per voxel and the stress
difference folds the moduli shift into them.  Fields are dim 6
(elasticity, viscosity) or dim 3 (heat, porous flow: sigma = 2 mu(x) E for
scalar laws).  Finite-strain (dim 9) phase sets mix under the Voigt,
Maximum, Random and 50-50 rules (P = sum w_p P_p(F), and likewise the
energy and the tangent) and the laminates of materials/laminate.py;
Reuss, Split and Iso need isotropic laws and refuse them, as in the JAX
package.

On a sharded field (x-slabs, ``parallel/slabs.py``) the Voigt rule's
responses run per slab: the mixed moduli and the phase fields are split
into the same slabs once (:meth:`MixedMaterial.iso_moduli_slabs`,
:meth:`MixedMaterial.phase_fields`), the stresses, the tangent, the energy
and the polarization are voxel-local, and the means and the eigenvalue
bounds reduce over the slabs.  Every other rule, and the laws that read a
field (the transversely isotropic orientation field), run on per-slab
views (:meth:`MixedMaterial.slab_views`, driven by
materials/sharded.py): the same material over the slab's cut of phi, of
the orientation fields, of the selector rules' weights (computed on the
whole grid, so the Random rule's voxel hash keeps its global index) and of
the interface normals.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..core import fields, voigt
from ..parallel import Mesh, shard_field, slabs
from . import laws

# voxels per chunk of the nonlinear tangent eigenvalue pass: the tangent of
# a chunk, (chunk, 9, 9), and its jvp intermediates stay at a few hundred MB
EIG_CHUNK = 1 << 18
# matrices per torch.linalg.eigvalsh call: on the card it calls cuSOLVER's
# batched symmetric eigensolver (cusolverDnXsyevBatched), which refuses a
# batch of 32768 or more 9x9 matrices (CUSOLVER_STATUS_INVALID_VALUE)
EIG_BATCH = 1 << 14
# phi threshold of an interface voxel (the Random, 50-50 and Iso rules)
_RTHR = 1e-7


@dataclasses.dataclass
class Phase:
    """Per-phase state: name, law, volume-fraction field
    (PhaseBase, fibergen.cpp:12004-12062)."""

    name: str
    law: object
    phi: Optional[torch.Tensor] = None  # (nx, ny, nz)
    index: int = 0


class MixedMaterial:
    """A mixed material over phases (MixedMaterialLawBase,
    fibergen.cpp:12067-12143): each voxel's response is the sum of the
    phases' responses weighted by :meth:`_weights_like` (phi here)."""

    rule = "voigt"
    # True when pk1 is the isotropic law with the moduli of _all_iso()
    # (the fused stress difference, the K1/K2 route)
    _iso_linear = False

    def __init__(self, phases: List[Phase], dim: int = 6):
        if dim not in (3, 6, 9):
            raise NotImplementedError(f"dim {dim} is not ported (3, 6 and 9 "
                                      f"are)")
        if dim == 9 and not all(isinstance(p.law, laws.HyperelasticLaw)
                                for p in phases):
            raise NotImplementedError("dim 9 takes hyperelastic phase laws "
                                      "only")
        if dim == 9 and self.rule in ("reuss", "iso"):
            raise NotImplementedError(f"{self.rule} mixing needs isotropic "
                                      f"laws")
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

    # ------------------------------------------------ isotropic moduli
    def _all_iso(self):
        """Per-voxel (mu(x), lam(x)) = sum phi_p (mu_p, lam_p) if every
        phase law exposes ``iso_moduli``, else None."""
        return self._cached_iso(self._iso_arithmetic)

    def _cached_iso(self, mix):
        """``mix()``'s moduli, cached on the identity of the phi tensors."""
        phis = [p.phi for p in self.phases]
        if self._iso_key is not None and (
                self._phi_dropped
                or all(a is b for a, b in zip(self._iso_key, phis))):
            return self._iso_val
        val = mix()
        if val is not None:
            self._iso_key, self._iso_val = phis, val
        return val

    def _iso_arithmetic(self):
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
        return mu_x, lam_x

    def iso_route(self):
        """True when the response is the isotropic law with the moduli of
        :meth:`_all_iso` (the JAX package's ``_iso_linear`` gate with
        ``_all_iso() is not None``): the stress difference folds into the
        moduli, and staggered elasticity takes K1 and K2."""
        return (self._dim != 9 and self._iso_linear
                and self._all_iso() is not None)

    def state(self):
        """The tensors the response reads (phi, orientation fields, the
        interface rules' normals, the mixed moduli): a reference material
        computed from them holds while each is the same object."""
        out = [p.phi for p in self.phases]
        out += [getattr(p.law, "orientation", None) for p in self.phases]
        out.append(getattr(self, "normals", None))
        if self._phi_dropped:
            out += list(self._iso_val)
        return tuple(out)

    def iso_moduli(self, dtype, device):
        """(mu(x), lam(x)) contiguous in ``dtype`` on ``device``; the
        conversion is cached beside the mixed moduli."""
        iso = self._all_iso()
        if iso is None:
            raise NotImplementedError("the phases have no isotropic moduli")
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
            raise NotImplementedError("the phases have no isotropic moduli")
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

    # ------------------------------------------------ per-slab views
    def with_phases(self, phases):
        """A shallow copy of the material over ``phases`` (the same rule and
        options), its caches empty."""
        v = copy.copy(self)
        for name in _CACHES:
            v.__dict__.pop(name, None)
        v._iso_key = v._iso_val = None
        v.phases = phases
        return v

    def slab_views(self, mesh):
        """One view of the material per x-slab of ``mesh``: the material
        over the slab's cut of each phase field and of each law's
        orientation field (:meth:`_adapt_views` cuts what a rule reads
        besides), each an ordinary material of the slab's voxels."""
        if self._phi_dropped:
            raise ValueError("slab views need the phase fields phi, which "
                             "drop_phi freed")
        phis = [shard_field(p.phi, mesh) for p in self.phases]
        lawss = [_law_slabs(p.law, mesh) for p in self.phases]
        views = [self.with_phases([
            Phase(p.name, lw[i], ph[i], p.index)
            for p, lw, ph in zip(self.phases, lawss, phis)])
            for i in range(mesh.size)]
        self._adapt_views(views, mesh)
        return views

    def _adapt_views(self, views, mesh):
        """Cut into ``views`` what the rule reads besides phi and the laws
        (nothing here)."""

    def drop_phi(self):
        """Free the per-phase phi fields, keeping only the cached mixed
        moduli: the solve reads mu(x) and lam(x) only."""
        if self._all_iso() is None:
            raise ValueError("drop_phi requires all-isotropic linear phases")
        self._phi_dropped = True
        # the cache key held the phi tensors: with it they would stay
        self._iso_key = ()
        for p in self.phases:
            p.phi = None

    # ------------------------------------------------ phase weights
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

    def _weights_like(self, F):
        """Each phase's per-voxel weight laid out as ``F``: phi."""
        return self.phase_fields(F)

    def _phase_sum(self, fn, *fields, comp=True, weights=None):
        """sum_p w_p fn(p.law, *fields) over the phases, the weights w_p
        (:meth:`_weights_like` by default) laid out as the first field (a
        component axis in front of w_p with ``comp``); on x-slabs slab by
        slab."""
        n = len(fields)
        if weights is None:
            weights = self._weights_like(fields[0])

        def one(*args):
            out = None
            for p, w in zip(self.phases, args[n:]):
                t = (w[None] if comp else w) * fn(p.law, *args[:n])
                out = t if out is None else out + t
            return out
        return slabs.smap(one, *fields, *weights)

    # ------------------------------------------------ responses
    def pk1(self, F):
        return self._phase_sum(lambda law, F: law.pk1(F), F)

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
        fibergen.cpp:10338)."""
        return self._phase_sum(lambda law, F, W: law.dpk1(F, W), F, W)

    def w(self, F):
        """Stored energy density per voxel (W)."""
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
        (fibergen.cpp:12087-12099; exact for sharp 0/1 phase fields).  A law
        without one raises; so does a material after :meth:`drop_phi`."""
        return self._phase_sum(
            lambda law, F: law.polarization(mu_0, F, inv), F,
            weights=self.phase_fields(F))

    def stress_diff(self, F, mu_0, lambda_0):
        """(C - C0) : F (calcStressDiff, fibergen.cpp:18030).  On the
        isotropic route (:meth:`iso_route`) the moduli shift folds into the
        mixed coefficients, per slab on x-slabs; otherwise the generic
        P(F) - 2 mu_0 F - lambda_0 tr(F) I (slab by slab on x-slabs: the
        Voigt rule's finite strain there)."""
        if self.iso_route():
            return slabs.smap(stress_diff_iso, F, *self._moduli_like(F),
                              mu_0, lambda_0)

        def diff(P, F):
            tau = P - 2.0 * mu_0 * F
            if self._dim >= 6 and lambda_0 != 0.0:
                tau[0:3] -= lambda_0 * (F[0] + F[1] + F[2])
            return tau
        return slabs.smap(diff, self.pk1(F), F)

    def stress_diffs(self, xs, mu_0, lambda_0, out):
        """:meth:`stress_diff` of each of the B fields ``xs`` into row b of
        ``out`` (a (B, ...) batch), case by case; returns ``out``."""
        for b, x in enumerate(xs):
            out[b] = self.stress_diff(x, mu_0, lambda_0)
        return out

    # ------------------------------------------------ reference material
    def eig_range(self, F=None, zero_trace=False, devices=None):
        """Per-voxel tangent eigenvalue bounds reduced over the grid
        (getRefMaterial, fibergen.cpp:12153-12236), as 0-d tensors.  Phases
        with isotropic moduli: those of the mixed moduli, {2 mu, 2 mu +
        3 lam}, without row and column 0 (``zero_trace``, viscosity)
        {2 mu, 2 mu + 2 lam}, a scalar law's (dim 3) 2 mu; with ``devices``
        per x-slab of the moduli on a mesh over them, reduced over the
        slabs.  Other linear phases: the extremes of the phases' constant
        bounds (``eig_range_const``; ``zero_trace`` is not applied, as in
        the JAX package).  Dim 9: the eigenvalues of the symmetrized 9x9
        tangent at ``F`` (:meth:`_eig_range_nonlinear`), on the x-slabs of
        a sharded F per slab."""
        if self._dim == 9:
            return _reduce_bounds(slabs.smap(
                lambda F, *phis: self._eig_range_nonlinear(F, zero_trace,
                                                           phis=phis),
                F, *self._weights_like(F)))
        iso = self._all_iso()
        if iso is None:
            bounds = [p.law.eig_range_const() for p in self.phases]
            return (torch.tensor(min(b[0] for b in bounds),
                                 dtype=torch.float64),
                    torch.tensor(max(b[1] for b in bounds),
                                 dtype=torch.float64))
        if devices is not None:
            mus, lams = self.iso_moduli_slabs(iso[0].dtype, devices)
            return _reduce_bounds(slabs.smap(
                lambda m, lm: self._eig_range_iso(m, lm, zero_trace), mus,
                lams))
        return self._eig_range_iso(*iso, zero_trace)

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
        LAPACK syev loop, fibergen.cpp:12472-12530), with the phase weights
        ``phis`` laid out as F (the rule's whole ones by default: phi for
        the Voigt rule, the selection of the Maximum, Random and 50-50
        rules, as the JAX package's full-grid pass takes them,
        mixing.py:213-330), in flat voxel
        chunks: per chunk the nine columns dP[e_j] come from one jvp per
        phase, batched over the unit directions with ``torch.func.vmap``,
        and ``torch.linalg.eigvalsh`` takes the (chunk, 9, 9) matrices
        ``EIG_BATCH`` at a time."""
        dim = self._dim
        n = F[0].numel()
        Ff = F.reshape(dim, n)
        phis = [torch.broadcast_to(phi, F.shape[1:]).reshape(n)
                for phi in (self._weights_like(F) if phis is None else phis)]
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


class VoigtMixed(MixedMaterial):
    """Arithmetic (Voigt) stress averaging P = sum_p phi_p P_p(F)
    (VoigtMixedMaterialLaw, fibergen.cpp:12729-12777).  For isotropic
    linear phases (dim 3 and 6) the response is the isotropic law with the
    mixed moduli mu(x), lam(x)."""

    rule = "voigt"
    _iso_linear = True

    def pk1(self, F):
        if self.iso_route():
            return slabs.smap(self._pk1_iso, F, *self._moduli_like(F))
        return super().pk1(F)

    def dpk1(self, F, W):
        if self.iso_route():
            return self.pk1(W)
        return super().dpk1(F, W)


class ReussMixed(MixedMaterial):
    """Harmonic (Reuss) compliance averaging (ReussMixedMaterialLaw,
    fibergen.cpp:12653-12726) of isotropic phases: the per-voxel moduli are
    the harmonic means of 2 mu and 3 lam + 2 mu, an isotropic law (the
    K1/K2 route).  Other laws raise, as in the JAX package."""

    rule = "reuss"
    _iso_linear = True

    def _iso_harmonic(self):
        mus, lams = [], []
        for p in self.phases:
            f = getattr(p.law, "iso_moduli", None)
            if f is None:
                raise NotImplementedError("reuss mixing needs isotropic laws")
            mu, lam = f()
            mus.append(mu)
            lams.append(lam)
        eps = np.finfo(np.float64).tiny
        # harmonic averages of (2 mu) and (3 lam + 2 mu) -> (mu, lam)
        inv_m = sum(p.phi / (2.0 * m + eps) for p, m in zip(self.phases, mus))
        inv_k = sum(p.phi / (3.0 * lm + 2.0 * m + eps)
                    for p, m, lm in zip(self.phases, mus, lams))
        two_mu = 1.0 / inv_m
        three_lam_two_mu = 1.0 / inv_k
        mu_x = 0.5 * two_mu
        lam_x = (three_lam_two_mu - two_mu) / 3.0
        return mu_x, lam_x

    def _all_iso(self):
        return self._cached_iso(self._iso_harmonic)

    def pk1(self, F):
        return slabs.smap(self._pk1_iso, F, *self._moduli_like(F))

    def dpk1(self, F, W):
        return self.pk1(W)

    def w(self, F):
        s = self.pk1(F)
        wts = [float(x) for x in voigt.weights(self._dim)]
        return 0.5 * sum(wts[i] * s[i] * F[i] for i in range(self._dim))


class _SelectorMixed(MixedMaterial):
    """A rule whose per-voxel phase weights are a function of the phi
    fields (:meth:`_rule_weights`), computed once per phi tensors, type and
    device.  A slab view reads the whole grid's weights cut to its slab
    (``_cut_weights``)."""

    _cut_weights = None

    def _rule_weights(self, phis):
        raise NotImplementedError

    def _adapt_views(self, views, mesh):
        cut = [shard_field(w, mesh) for w in
               self._rule_weights(torch.stack([p.phi for p in self.phases]))]
        for i, v in enumerate(views):
            v._cut_weights = [w[i] for w in cut]

    def _weights_like(self, F):
        if slabs.sharded(F):
            raise ValueError(f"the {self.rule} rule takes x-slabs through "
                             f"its slab views (materials/sharded.py)")
        if self._phi_dropped:
            raise ValueError("the phase-wise response needs the phase "
                             "fields phi, which drop_phi freed")
        phis = [p.phi for p in self.phases]
        key = (F.dtype, F.device)
        cache = getattr(self, "_w_cache", None)
        if cache is None or cache[1] != key or not all(
                a is b for a, b in zip(cache[0], phis)):
            w = self._rule_weights(torch.stack(phis)) \
                if self._cut_weights is None else self._cut_weights
            self._w_cache = (phis, key, [x.to(dtype=F.dtype, device=F.device)
                                         for x in w])
        return self._w_cache[2]


def _interface(phis):
    """Voxels where some phase is neither absent nor pure."""
    return ((phis > _RTHR) & (phis < 1.0 - _RTHR)).any(dim=0)


class MaximumMixed(_SelectorMixed):
    """Dominant-phase selection: the voxel takes the law of the phase with
    the largest phi, the first on a tie (MaximumMixedMaterialLaw,
    fibergen.cpp:12568-12605)."""

    rule = "maximum"

    def _rule_weights(self, phis):
        arg = torch.argmax(phis, dim=0)
        return [(arg == i).to(phis.dtype) for i in range(len(self.phases))]


class RandomMixed(_SelectorMixed):
    """Interface voxels take one pseudo-random phase, pure voxels their
    phase (RandomMixedMaterialLaw, fibergen.cpp:12782-12867), by the
    reference's LCG hash of the flat C-order voxel index."""

    rule = "random"

    def _rule_weights(self, phis):
        nph = len(self.phases)
        shape = phis.shape[1:]
        idx = torch.arange(phis[0].numel(), dtype=torch.int64,
                           device=phis.device).reshape(shape)
        rnd = (((idx * 1103515245 + 12345) >> 16) & 0x7FFFFFFF) % nph
        sel = torch.stack([(rnd == p).to(phis.dtype) for p in range(nph)])
        return list(torch.where(_interface(phis)[None], sel, phis))

    def _all_iso(self):
        return None


class FiftyFiftyMixed(_SelectorMixed):
    """Interface voxels average all phases equally
    (FiftyFiftyMixedMaterialLaw, fibergen.cpp:12870-12955)."""

    rule = "fiftyfifty"

    def _rule_weights(self, phis):
        eq = torch.full_like(phis, 1.0 / len(self.phases))
        return list(torch.where(_interface(phis)[None], eq, phis))

    def _all_iso(self):
        return None


class SplitMixed(MixedMaterial):
    """Volumetric/deviatoric split with a rule for each part
    (SplitMixedMaterialLaw, fibergen.cpp:12608-12650).  The sub-rules
    share the phases."""

    rule = "split"

    def __init__(self, phases, dim=6, dev_rule="voigt", vol_rule="reuss"):
        super().__init__(phases, dim=dim)
        self.dev = MIXING_RULES[dev_rule](self.phases, dim=dim)
        self.vol = MIXING_RULES[vol_rule](self.phases, dim=dim)

    def _adapt_views(self, views, mesh):
        # each sub-rule on its own views of the same slabs
        for v, dev, vol in zip(views, self.dev.slab_views(mesh),
                               self.vol.slab_views(mesh)):
            v.dev, v.vol = dev, vol

    @staticmethod
    def _split(F):
        tr3 = (F[0] + F[1] + F[2]) / 3.0
        Fvol = torch.zeros_like(F)
        Fvol[0:3] = tr3[None]
        return F - Fvol, Fvol

    def pk1(self, F):
        Fdev, Fvol = self._split(F)
        return self.dev.pk1(Fdev) + self.vol.pk1(Fvol)

    def dpk1(self, F, W):
        Wdev, Wvol = self._split(W)
        return self.dev.dpk1(F, Wdev) + self.vol.dpk1(F, Wvol)

    def w(self, F):
        Fdev, Fvol = self._split(F)
        return self.dev.w(Fdev) + self.vol.w(Fvol)

    def _all_iso(self):
        return None


class IsoMixed(MixedMaterial):
    """The energy-optimal isostrain/isostress split of two isotropic phases
    (IsoMixedMaterialLaw, fibergen.cpp:12958-13083): (c2 C1 + c1 C2) F1 =
    C2 F, F2 = (F - c1 F1)/c2, in closed form (the mixing matrix is itself
    isotropic and inverted analytically)."""

    rule = "iso"

    def __init__(self, phases, dim=6):
        super().__init__(phases, dim=dim)
        if len(phases) != 2:
            raise ValueError("iso mixing requires exactly 2 phases")

    def _phase_strains(self, F):
        l1, l2 = self.phases[0].law, self.phases[1].law
        if not (hasattr(l1, "iso_moduli") and hasattr(l2, "iso_moduli")):
            raise NotImplementedError("iso mixing needs isotropic laws")
        mu1, la1 = l1.iso_moduli()
        mu2, la2 = l2.iso_moduli()
        c1, c2 = (p.phi.to(dtype=F.dtype, device=F.device)
                  for p in self.phases)
        # M = c2 C1 + c1 C2, isotropic with per-voxel moduli (m, l)
        m = c2 * mu1 + c1 * mu2
        l = c2 * la1 + c1 * la2
        # F1 = M^-1 C2 F: inv(2m Id + l II) applied to 2 mu2 F + la2 tr(F) I
        trF = F[0] + F[1] + F[2]
        rhs = 2.0 * mu2 * F
        if self._dim >= 6:
            rhs[0:3] += (la2 * trF)[None]
        tr_rhs = rhs[0] + rhs[1] + rhs[2]
        inv2m = 1.0 / torch.clamp_min(2.0 * m, 1e-300)
        b = l / (torch.clamp_min(2.0 * m, 1e-300)
                 * torch.clamp_min(3.0 * l + 2.0 * m, 1e-300))
        F1 = inv2m[None] * rhs
        if self._dim >= 6:
            F1[0:3] -= (b * tr_rhs)[None]
        # pure voxels: F1 = F2 = F
        pure = ((c2 <= _RTHR) | (c1 <= _RTHR))[None]
        F1 = torch.where(pure, F, F1)
        F2 = (F - c1[None] * F1) / torch.clamp_min(c2, _RTHR)[None]
        F2 = torch.where(pure, F, F2)
        return F1, F2, c1, c2

    def pk1(self, F):
        F1, F2, c1, c2 = self._phase_strains(F)
        return c1[None] * self.phases[0].law.pk1(F1) \
            + c2[None] * self.phases[1].law.pk1(F2)

    def dpk1(self, F, W):
        # the phase strains are linear in F, and so is the stress
        return self.pk1(W)

    def w(self, F):
        F1, F2, c1, c2 = self._phase_strains(F)
        return c1 * self.phases[0].law.w(F1) + c2 * self.phases[1].law.w(F2)

    def _all_iso(self):
        return None


MIXING_RULES = {
    "voigt": VoigtMixed,
    "reuss": ReussMixed,
    "maximum": MaximumMixed,
    "random": RandomMixed,
    "fiftyfifty": FiftyFiftyMixed,
    "split": SplitMixed,
    "iso": IsoMixed,
}


# the interface rules (materials/laminate.py, which imports this module):
# not in MIXING_RULES, as in the JAX package
_INTERFACE_RULES = {"laminate": "LaminateMixed",
                    "infinity_laminate": "InfinityLaminateMixed",
                    "infinity-laminate": "InfinityLaminateMixed",
                    "fluidity": "FluidityMixed"}


def make_mixed(rule: str, phases: List[Phase], dim: int = 6
               ) -> MixedMaterial:
    """Mixing-rule factory (create_mixing_rule, fibergen.cpp:14975-15030):
    the names of MIXING_RULES, and the interface rules of
    materials/laminate.py (``laminate``, ``infinity_laminate`` or
    ``infinity-laminate``, ``fluidity``), whose ``normals`` field the
    caller sets on the material."""
    if rule in _INTERFACE_RULES:
        from . import laminate
        return getattr(laminate, _INTERFACE_RULES[rule])(phases, dim=dim)
    try:
        cls = MIXING_RULES[rule]
    except KeyError:
        raise ValueError(f"Unknown mixing rule '{rule}'") from None
    return cls(phases, dim=dim)


# the per-material caches a view starts without (with_phases)
_CACHES = ("_iso_cast", "_iso_slabs", "_phi_slabs", "_w_cache",
           "_jump_cache")


def _law_slabs(law, mesh):
    """A phase law per x-slab of ``mesh``: a law that reads an orientation
    field (the transversely isotropic law without a fixed axis) gets its
    slab's cut of it; any other law is shared."""
    o = getattr(law, "orientation", None)
    if o is None or law._fixed_axis() is not None:
        return [law] * mesh.size
    return [dataclasses.replace(law, orientation=x)
            for x in shard_field(o, mesh)]


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
