"""Constitutive laws: isotropic and general (6x6) linear elasticity, the
transversely isotropic law, the scalar and the anisotropic (3x3) laws of
heat conduction and porous flow (the scalar one also viscosity's
fluidity), and the finite-strain hyperelastic laws.

Laws act on whole Voigt fields ``(dim, nx, ny, nz)``; dim-6 strains store
tensor shear components, dim 9 the full deformation gradient
[xx, yy, zz, yz, xz, xy, zy, zx, yx] (core.voigt).  A linear law's tangent
is the law itself (``dpk1(F, W) = pk1(W)``) and its energy is
1/2 sigma : eps; the constant tensors of a law (a 6x6 or 3x3 matrix) are
moved to a field's type and device once per type and device.  A hyperelastic law
defines its stored energy on the nine component fields; its first
Piola-Kirchhoff stress and the stress's directional derivative come from
``torch.func`` (grad, and jvp over grad), as the JAX package takes them
from ``jax.grad`` and ``jax.jvp``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core import voigt
from . import convert


def _weights(dim):
    """The double-contraction weights as Python floats."""
    return [float(w) for w in voigt.weights(dim)]


class MaterialLaw:
    """What every law shares (MaterialLaw, fibergen.cpp:10287-10445): the
    energy 1/2 sigma : eps, the tangent and the Cauchy stress of a linear
    law, and no polarization unless the law defines one."""

    dim: int = 6
    is_linear: bool = False

    def pk1(self, F):
        raise NotImplementedError

    def w(self, F):
        s = self.pk1(F)
        wts = _weights(self.dim)
        return 0.5 * sum(wts[i] * s[i] * F[i] for i in range(self.dim))

    def dpk1(self, F, W):
        """Directional derivative of pk1 at F along W (dPK1,
        fibergen.cpp:10338): the law itself for a linear law."""
        return self.pk1(W)

    def eig_range_const(self):
        """(lmin, lmax) of the Voigt tangent when it is constant (getRefMaterial
        bounds, fibergen.cpp:12153-12236); None for nonlinear laws."""
        return None

    def cauchy(self, F):
        """The Cauchy stress: the stress itself below dim 9."""
        return self.pk1(F)

    def polarization(self, mu_0, F, inv=False):
        """Eyre-Milton transform (C - C0)(C + C0)^{-1} F with C0 = 2 mu_0 Id
        (calcPolarization, fibergen.cpp:10414-10445)."""
        raise NotImplementedError(f"{type(self).__name__} has no polarization")

    def _on(self, name, value, like):
        """The host array ``value`` as a tensor in ``like``'s type on its
        device, made once per type and device."""
        cache = self.__dict__.setdefault("_tensors", {})
        key = (name, like.dtype, like.device)
        if key not in cache:
            cache[key] = torch.as_tensor(np.asarray(value, dtype=np.float64),
                                         dtype=like.dtype, device=like.device)
        return cache[key]

    def __str__(self):
        return type(self).__name__


@dataclasses.dataclass
class LinearIsotropic(MaterialLaw):
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
class ScalarLinearIsotropic(MaterialLaw):
    """Scalar conductivity/fluidity law sigma = mu * E on dim-3 fields
    (fibergen.cpp:11161-11228).  Also used for viscosity (dim 6)."""

    mu: float
    dim: int = 3
    is_linear: bool = True

    def pk1(self, F):
        return self.mu * F

    def w(self, F):
        wts = _weights(self.dim)
        return 0.5 * self.mu * sum(wts[i] * F[i] * F[i]
                                   for i in range(self.dim))

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


@dataclasses.dataclass
class LinearGeneral(MaterialLaw):
    """Full 6x6 stiffness in Voigt notation, sigma = C : eps
    (LinearGeneralMaterialLaw, fibergen.cpp:11233-11349).  The strain holds
    tensor shear components, so the Voigt weights go on C's columns."""

    C: np.ndarray  # (6, 6)
    dim: int = 6
    is_linear: bool = True

    def pk1(self, F):
        Cw = self._on("Cw", np.asarray(self.C, dtype=np.float64)
                      * voigt.weights(6)[None, :], F)
        return torch.einsum("ij,j...->i...", Cw, F)

    def eig_range_const(self):
        e = np.linalg.eigvalsh(np.asarray(self.C, dtype=np.float64))
        return (float(e.min()), float(e.max()))

    def __str__(self):
        return "general linear C"


@dataclasses.dataclass
class MatrixLinearAnisotropic(MaterialLaw):
    """Anisotropic conduction/permeability S = K E with a full 3x3 matrix
    (MatrixLinearAnisotropicMaterialLaw, fibergen.cpp:11089-11160)."""

    K: np.ndarray  # (3, 3)
    dim: int = 3
    is_linear: bool = True

    def pk1(self, F):
        return torch.einsum("ij,j...->i...", self._on("K", self.K, F), F)

    def w(self, F):
        s = self.pk1(F)
        return 0.5 * sum(s[i] * F[i] for i in range(3))

    def eig_range_const(self):
        K = np.asarray(self.K, dtype=np.float64)
        e = np.linalg.eigvalsh(0.5 * (K + K.T))
        return (float(e.min()), float(e.max()))

    def __str__(self):
        return "matrix linear anisotropic"


@dataclasses.dataclass
class LinearTransverselyIsotropic(MaterialLaw):
    """Transversely isotropic elasticity with five engineering constants
    and an axis: a fixed vector ``a``, or a per-voxel unit ``orientation``
    field (3, nx, ny, nz) on the solve's device
    (LinearTransverselyIsotropicMaterialLaw, fibergen.cpp:11479-11593):

        S = 2 mu E + lambda tr(E) I + alpha (a.E.a) I
            + (alpha tr(E) + beta (a.E.a)) A + dmu (AE + EA),  A = a x a.

    With a fixed axis the law is one constant 6x6 map (its columns the
    stresses of the unit strains), applied as one product; with a field
    the terms are formed voxel by voxel."""

    E: float = 1.0
    nu: float = 0.3
    E_a: float = 1.0
    G_a: float = 1.0
    nu_a: float = 0.3
    a: Optional[np.ndarray] = None          # fixed direction, else field
    orientation: object = None              # (3, nx, ny, nz) unit field
    dim: int = 6
    is_linear: bool = True

    def __post_init__(self):
        E, nu, E_a, G_a, nu_ab = self.E, self.nu, self.E_a, self.G_a, self.nu_a
        G = E / (2 * (nu + 1))
        nu_ba = E / E_a * nu_ab
        D = (1 + nu) * (1 - nu - 2 * nu_ab * nu_ba)
        self._alpha = E * (nu_ab * (1 + nu - nu_ba) - nu) / D
        self._beta = (E_a * (1 - nu * nu) - E * (nu + nu_ab * nu_ba)
                      - 2 * E * (nu_ab * (1 + nu - nu_ba) - nu)) / D \
            - 4 * G_a + 2 * G
        self._lam = E * (nu + nu_ab * nu_ba) / D
        self._two_mu = 2 * G
        self._two_dmu = 2 * (G_a - G)

    def _fixed_axis(self):
        """The unit axis as floats, or None when the law reads a field."""
        if self.a is not None and np.linalg.norm(self.a) != 0:
            av = np.asarray(self.a, dtype=np.float64)
            return [float(x) for x in av / np.linalg.norm(av)]
        if self.orientation is None:
            raise ValueError("tiso law needs a direction or orientation field")
        return None

    def matrix(self, a):
        """The 6x6 map of strains (tensor shear components) to stresses
        about the axis ``a``: column j is the stress of the unit strain
        e_j."""
        eye = np.eye(6)
        C = np.zeros((6, 6))
        for j in range(6):
            C[:, j] = np.asarray(self._stress_terms(eye[j], a),
                                 dtype=np.float64)
        return C

    def pk1(self, F):
        a = self._fixed_axis()
        if a is not None:
            C = self._on("C", self.matrix(a), F)
            return torch.einsum("ij,j...->i...", C, F)
        o = self.orientation.to(dtype=F.dtype, device=F.device)
        return torch.stack(self._stress_terms(F, (o[0], o[1], o[2])))

    def _stress_terms(self, F, a):
        """The six stress components [xx, yy, zz, yz, xz, xy] on tensors,
        numpy arrays or floats alike."""
        a0, a1, a2 = a
        # A = a x a in Voigt [xx, yy, zz, yz, xz, xy]
        A = [a0 * a0, a1 * a1, a2 * a2, a1 * a2, a0 * a2, a0 * a1]
        trE = F[0] + F[1] + F[2]
        w = _weights(6)
        aEa = sum(w[i] * A[i] * F[i] for i in range(6))
        # (AE + EA)_ij = sum_k A_ik E_kj + E_ik A_kj for symmetric A, E
        Am = [[A[0], A[5], A[4]], [A[5], A[1], A[3]], [A[4], A[3], A[2]]]
        Em = [[F[0], F[5], F[4]], [F[5], F[1], F[3]], [F[4], F[3], F[2]]]

        def prod(i, j):
            return sum(Am[i][k] * Em[k][j] + Em[i][k] * Am[k][j]
                       for k in range(3))

        AE = [prod(0, 0), prod(1, 1), prod(2, 2),
              0.5 * (prod(1, 2) + prod(2, 1)),
              0.5 * (prod(0, 2) + prod(2, 0)),
              0.5 * (prod(0, 1) + prod(1, 0))]

        c_I = self._lam * trE + self._alpha * aEa
        c_A = self._alpha * trE + self._beta * aEa
        out = []
        for i in range(6):
            t = self._two_mu * F[i] + c_A * A[i] + 0.5 * self._two_dmu * AE[i]
            if i < 3:
                t = t + c_I
            out.append(t)
        return out

    def eig_range_const(self):
        """Bounds of the symmetric part of the 6x6 map about a = e_z,
        whatever the axis, as the JAX package takes them."""
        C = self.matrix((0.0, 0.0, 1.0))
        e = np.linalg.eigvalsh(0.5 * (C + C.T))
        return (float(e.min()), float(e.max()))

    def __str__(self):
        return (f"linear transversely isotropic lambda={self._lam:g} "
                f"mu={0.5 * self._two_mu:g}")


# ------------------------------------------------------------------------
# finite strain: component helpers on (9, ...) fields
# ------------------------------------------------------------------------

def _safe_log(x):
    """log with a clamp against J <= 0 (the reference's MaterialLaw::log
    guard)."""
    return torch.log(torch.clamp_min(x, torch.finfo(x.dtype).tiny))


def f_rows(F):
    """(9, ...) -> the nine matrix entries in row-major order (f00, f01,
    f02, f10, f11, f12, f20, f21, f22) of the dim-9 component order."""
    return F[0], F[5], F[4], F[8], F[1], F[3], F[7], F[6], F[2]


def det3_comp(F):
    """det(F) from the (9, ...) components."""
    f00, f01, f02, f10, f11, f12, f20, f21, f22 = f_rows(F)
    return (f00 * (f11 * f22 - f12 * f21)
            - f01 * (f10 * f22 - f12 * f20)
            + f02 * (f10 * f21 - f11 * f20))


def cauchy_green_comp(F):
    """Unique entries (C00, C11, C22, C12, C02, C01) of C = F^T F."""
    f00, f01, f02, f10, f11, f12, f20, f21, f22 = f_rows(F)
    C00 = f00 * f00 + f10 * f10 + f20 * f20
    C11 = f01 * f01 + f11 * f11 + f21 * f21
    C22 = f02 * f02 + f12 * f12 + f22 * f22
    C12 = f01 * f02 + f11 * f12 + f21 * f22
    C02 = f00 * f02 + f10 * f12 + f20 * f22
    C01 = f00 * f01 + f10 * f11 + f20 * f21
    return C00, C11, C22, C12, C02, C01


def cauchy_from_pk1_comp(P, F):
    """sigma = P F^T / det(F) on (9, ...) components (MaterialLaw::Cauchy,
    fibergen.cpp:10326): sigma_ij = P_ik F_jk / J."""
    p00, p01, p02, p10, p11, p12, p20, p21, p22 = f_rows(P)
    f00, f01, f02, f10, f11, f12, f20, f21, f22 = f_rows(F)
    J = det3_comp(F)
    return torch.stack([
        (p00 * f00 + p01 * f01 + p02 * f02) / J,
        (p10 * f10 + p11 * f11 + p12 * f12) / J,
        (p20 * f20 + p21 * f21 + p22 * f22) / J,
        (p10 * f20 + p11 * f21 + p12 * f22) / J,
        (p00 * f20 + p01 * f21 + p02 * f22) / J,
        (p00 * f10 + p01 * f11 + p02 * f12) / J,
        (p20 * f10 + p21 * f11 + p22 * f12) / J,
        (p20 * f00 + p21 * f01 + p22 * f02) / J,
        (p10 * f00 + p11 * f01 + p12 * f02) / J])


class HyperelasticLaw(MaterialLaw):
    """Finite-strain law on (9, ...) deformation-gradient fields:
    subclasses define the energy density ``energy(F)`` with the component
    helpers above (no voxel-trailing (..., 3, 3) view); PK1 = dW/dF and
    dPK1(F)[W] = d2W/dF2 : W come from ``torch.func``."""

    dim = 9
    is_linear = False

    def energy(self, F):
        raise NotImplementedError

    def w(self, F):
        return self.energy(F)

    def pk1(self, F):
        # gradient of sum(W) over the (9, ...) field == per-voxel dW/dF
        return torch.func.grad(lambda x: self.energy(x).sum())(F)

    def dpk1(self, F, W):
        return torch.func.jvp(self.pk1, (F,), (W,))[1]

    def cauchy(self, F):
        return cauchy_from_pk1_comp(self.pk1(F), F)


@dataclasses.dataclass
class SaintVenantKirchhoff(HyperelasticLaw):
    """W = lambda/2 tr(E)^2 + mu E:E with E = (F^T F - I)/2
    (fibergen.cpp:11598-11724)."""

    mu: float
    lam: float

    def energy(self, F):
        C00, C11, C22, C12, C02, C01 = cauchy_green_comp(F)
        E00, E11, E22 = 0.5 * (C00 - 1.0), 0.5 * (C11 - 1.0), 0.5 * (C22 - 1.0)
        trE = E00 + E11 + E22
        # E:E with the symmetric off-diagonals E_ij = C_ij / 2 counted twice
        EE = (E00 * E00 + E11 * E11 + E22 * E22
              + 0.5 * (C01 * C01 + C02 * C02 + C12 * C12))
        return 0.5 * self.lam * trE * trE + self.mu * EE

    def __str__(self):
        return (f"hyperelastic Saint Venant-Kirchhoff lambda={self.lam:g} "
                f"mu={self.mu:g}")


@dataclasses.dataclass
class NeoHooke(HyperelasticLaw):
    """W = mu/2 (tr C - 3 - 2 ln J) + lambda/2 (ln J)^2
    (fibergen.cpp:11729-11861)."""

    mu: float
    lam: float

    def energy(self, F):
        trC = (F * F).sum(0)
        logJ = _safe_log(det3_comp(F))
        return 0.5 * (self.mu * (trC - 3.0 - 2.0 * logJ)
                      + self.lam * logJ * logJ)

    def __str__(self):
        return f"hyperelastic Neo-Hooke lambda={self.lam:g} mu={self.mu:g}"


@dataclasses.dataclass
class NeoHooke2(HyperelasticLaw):
    """W = mu/2 (J^{-2/3} tr C - 3) + K/2 (J - 1)^2
    (fibergen.cpp:11867-11998)."""

    mu: float
    K: float

    def energy(self, F):
        trC = (F * F).sum(0)
        J = det3_comp(F)
        Jm23 = torch.clamp_min(J, torch.finfo(F.dtype).tiny) ** (-2.0 / 3.0)
        J1 = J - 1.0
        return 0.5 * (self.mu * (Jm23 * trC - 3.0) + self.K * J1 * J1)

    def __str__(self):
        return f"hyperelastic Neo-Hooke-2 K={self.K:g} mu={self.mu:g}"


class GoldbergLaw(HyperelasticLaw):
    """Isochoric-invariant energies W(J1, J2, J3) with
    J1 = J3^{-2/3} tr C, J2 = J3^{-4/3} (trC^2 - tr C^2)/2, J3 = det F
    (GeneralGoldbergMaterialLaw, fibergen.cpp:10455-10665)."""

    def w_inv(self, J1, J2, J3):
        raise NotImplementedError

    def energy(self, F):
        C00, C11, C22, C12, C02, C01 = cauchy_green_comp(F)
        trC = C00 + C11 + C22
        # tr(C^2) for symmetric C: the sum of squared entries
        trCC = (C00 * C00 + C11 * C11 + C22 * C22
                + 2.0 * (C01 * C01 + C02 * C02 + C12 * C12))
        J3 = torch.clamp_min(det3_comp(F), torch.finfo(F.dtype).tiny)
        J1 = J3 ** (-2.0 / 3.0) * trC
        J2 = 0.5 * J3 ** (-4.0 / 3.0) * (trC * trC - trCC)
        return self.w_inv(J1, J2, J3)


def _vol(J3):
    return J3 + 1.0 / J3 - 2.0


def _vol5(J3):
    J5 = J3 ** 5
    return J5 + 1.0 / J5 - 2.0


@dataclasses.dataclass
class GoldbergMatrix1(GoldbergLaw):
    """W = m1 (J1-3) + m2 (J3 + 1/J3 - 2) (fibergen.cpp:10669-10717)."""
    m1: float = 1.0
    m2: float = 10.0

    def w_inv(self, J1, J2, J3):
        return self.m1 * (J1 - 3.0) + self.m2 * _vol(J3)


@dataclasses.dataclass
class GoldbergMatrix2(GoldbergLaw):
    """Cubic in (J1-3) + volumetric (fibergen.cpp:10719-10770)."""
    m1: float = 0.5
    m2: float = 0.1
    m3: float = 1.0
    m4: float = 5.0

    def w_inv(self, J1, J2, J3):
        x = J1 - 3.0
        return (self.m1 + (self.m2 + self.m3 * x) * x) * x + self.m4 * _vol(J3)


@dataclasses.dataclass
class GoldbergMatrix3(GoldbergLaw):
    """W = m1 (J1-3) + m2/50 (J3^5 + J3^-5 - 2) (fibergen.cpp:10772-10820)."""
    m1: float = 1.0
    m2: float = 10.0

    def w_inv(self, J1, J2, J3):
        return self.m1 * (J1 - 3.0) + (self.m2 / 50.0) * _vol5(J3)


@dataclasses.dataclass
class GoldbergMatrix4(GoldbergLaw):
    """Cubic isochoric + stiff J3^5 volumetric (fibergen.cpp:10822-10876)."""
    m1: float = 0.5
    m2: float = 1.0
    m3: float = 3.0
    m4: float = 50.0

    def w_inv(self, J1, J2, J3):
        x = J1 - 3.0
        return self.m1 * x + self.m2 * x * x + self.m3 * x ** 3 \
            + (self.m4 / 50.0) * _vol5(J3)


@dataclasses.dataclass
class GoldbergFiber1(GoldbergLaw):
    """W = f1 (J1-3) + f2 (J3 + 1/J3 - 2) (fibergen.cpp:10878-10904)."""
    f1: float = 10.0
    f2: float = 100.0

    def w_inv(self, J1, J2, J3):
        return self.f1 * (J1 - 3.0) + self.f2 * _vol(J3)


@dataclasses.dataclass
class GoldbergFiber2(GoldbergLaw):
    """Logarithmic locking law W = -f1 f2/2 ln((f1 + 3 - J1)/f1) + vol
    (fibergen.cpp:10858-10904)."""
    f1: float = 10.0
    f2: float = 2.0
    f3: float = 500.0

    def w_inv(self, J1, J2, J3):
        c = torch.clamp_min((self.f1 + (3.0 - J1)) / self.f1,
                            torch.finfo(J1.dtype).tiny)
        return -0.5 * self.f1 * self.f2 * torch.log(c) + self.f3 * _vol(J3)


@dataclasses.dataclass
class GoldbergFiber3(GoldbergLaw):
    """W = f1 J1 + f2 J1^4 + f3 sqrt(J2) + f4 vol (fibergen.cpp:10906-10942)."""
    f1: float = 1.0
    f2: float = 0.02
    f3: float = 100.0
    f4: float = 500.0

    def w_inv(self, J1, J2, J3):
        return self.f1 * J1 + self.f2 * J1 ** 4 \
            + self.f3 * torch.sqrt(torch.clamp_min(
                J2, torch.finfo(J1.dtype).tiny)) \
            + self.f4 * _vol(J3)


@dataclasses.dataclass
class GoldbergFiber4(GoldbergLaw):
    """W = f1 (J1-3) + f2/50 (J3^5 + J3^-5 - 2) (fibergen.cpp:10944-10981)."""
    f1: float = 20.0
    f2: float = 200.0

    def w_inv(self, J1, J2, J3):
        return self.f1 * (J1 - 3.0) + (self.f2 / 50.0) * _vol5(J3)


@dataclasses.dataclass
class GoldbergFiber5(GoldbergLaw):
    """Exponential stiffening W = f1 (e^{f2 (J1-3)} - 1) + f3 vol
    (fibergen.cpp:10983-11018)."""
    f1: float = 3.5
    f2: float = 2.0
    f3: float = 500.0

    def w_inv(self, J1, J2, J3):
        return self.f1 * (torch.exp(self.f2 * (J1 - 3.0)) - 1.0) \
            + self.f3 * _vol(J3)


@dataclasses.dataclass
class GoldbergFiber6(GoldbergLaw):
    """Exponential isochoric + J3^5 volumetric (fibergen.cpp:11020-11087)."""
    f1: float = 3.5
    f2: float = 4.0
    f3: float = 500.0

    def w_inv(self, J1, J2, J3):
        return self.f1 * (torch.exp(self.f2 * (J1 - 3.0)) - 1.0) \
            + (self.f3 / 50.0) * _vol5(J3)


GOLDBERG_LAWS = {
    "gb_matrix1": GoldbergMatrix1,
    "gb_matrix2": GoldbergMatrix2,
    "gb_matrix3": GoldbergMatrix3,
    "gb_matrix4": GoldbergMatrix4,
    "gb_fiber1": GoldbergFiber1,
    "gb_fiber2": GoldbergFiber2,
    "gb_fiber3": GoldbergFiber3,
    "gb_fiber4": GoldbergFiber4,
    "gb_fiber5": GoldbergFiber5,
    "gb_fiber6": GoldbergFiber6,
}


def make_law(kind: str, dim_hint: int = 6, **params) -> MaterialLaw:
    """Law factory by XML tag name (readSettings law table,
    fibergen.cpp:15219-15305): ``iso`` and the hyperelastic laws from any
    two isotropic constants (convert.elastic_constants), ``scalar`` from
    ``mu`` (dim ``dim_hint``), ``general`` from ``C``."""
    kind = kind.lower()
    if kind in ("iso", "linear_isotropic", "matrix", "fiber", ""):
        c = convert.elastic_constants(**params)
        return LinearIsotropic(mu=c["mu"], lam=c["lam"])
    if kind in ("scalar", "scalar_linear_isotropic"):
        return ScalarLinearIsotropic(mu=float(params["mu"]), dim=dim_hint)
    if kind in ("general", "linear_general"):
        return LinearGeneral(C=np.asarray(params["C"], dtype=np.float64))
    if kind in ("svk", "saint_venant_kirchhoff", "sv"):
        c = convert.elastic_constants(**params)
        return SaintVenantKirchhoff(mu=c["mu"], lam=c["lam"])
    if kind in ("nh", "neo_hooke", "neo-hooke", "neohooke"):
        c = convert.elastic_constants(**params)
        return NeoHooke(mu=c["mu"], lam=c["lam"])
    if kind in ("nh2", "neo_hooke_2", "neohooke2"):
        c = convert.elastic_constants(**params)
        return NeoHooke2(mu=c["mu"], K=c["K"])
    raise ValueError(f"Unknown material law '{kind}'")
