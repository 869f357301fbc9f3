"""Interface-aware mixing of composite voxels: the rank-1 laminate, the
infinity-laminate and the fluidity rule.

Port of fibergen_tpu/materials/laminate.py (LaminateMixedMaterialLaw,
InfinityLaminateMixedMaterialLaw and FluidityMixedMaterialLaw,
fibergen.cpp:13086-14213).  An interface voxel (both active phases with
phi > 1e-7) is a laminate along the interface normal n: the phase strains
are

    F1 = F - alpha1 sym(a x n),   F2 = F + alpha2 sym(a x n)

with the jump vector a minimizing c1 W1(F1) + c2 W2(F2) (a x n, not
symmetrized, on the finite-strain deformation gradient).  For linear laws
one Newton step from a = 0 is the exact minimizer: a per-voxel 3x3 solve,
done here by Cramer's rule on the component fields; nonlinear (dim 9)
laws take seven further Newton steps, as the JAX package does
(laminate.py:194-232).  Scalar (dim 3) laws take the closed-form jump
along n (``material_kernels.laminate_jump``; two linear phases take
``material_kernels.laminate_heat``, the kernel on the card).  The tangent
comes from ``torch.func.jvp`` through the stress, as the JAX package takes
it from ``jax.jvp``, and the reference material of a nonlinear laminate
from the eigenvalues of that tangent on the whole grid.

With more than two phases only the two largest-phi phases of a voxel take
part, gathered into isotropic laws with per-voxel moduli.  On the
x-slabs of a sharded field each rule runs on its slab views
(``MixedMaterial.slab_views``), the normals cut into the same slabs.
"""
from __future__ import annotations

from typing import List

import torch

from ..core import voigt
from ..ops import material_kernels
from ..ops.material_kernels import THR as _THR
from ..ops.material_kernels import unit_or_ex as _unit_or_ex
from ..parallel import shard_field, slabs
from .mixing import MixedMaterial, Phase


def _top2_phases(phis):
    """Per-voxel indices and renormalized fractions of the two largest
    phases of the stacked phi fields ``phis`` (the reference walks the
    phase list per voxel and takes the <= 2 with phi > 0,
    fibergen.cpp:12186-12209); ties keep the phase order."""
    order = torch.argsort(-phis, dim=0, stable=True)
    i1, i2 = order[0], order[1]
    c1 = torch.gather(phis, 0, i1[None])[0]
    c2 = torch.gather(phis, 0, i2[None])[0]
    tot = torch.clamp_min(c1 + c2, _THR)
    return i1, i2, c1 / tot, c2 / tot


class _FieldIso:
    """A linear isotropic law with per-voxel moduli fields, the virtual
    phase law of the n-phase selection.  Moduli follow ``iso_moduli``'s
    convention C = 2 mu Id + lam I x I (in dim 3, pk1 = 2 mu F)."""

    is_linear = True

    def __init__(self, mu, lam, dim):
        self._mu = mu
        self._lam = lam
        self._dim = dim

    def iso_moduli(self):
        return (self._mu, self._lam)

    def pk1(self, F):
        out = 2.0 * self._mu[None] * F
        if self._dim >= 6:
            tr = self._lam * (F[0] + F[1] + F[2])
            out = torch.cat([out[0:3] + tr[None], out[3:]])
        return out

    def dpk1(self, F, W):
        return self.pk1(W)

    def w(self, F):
        s = self.pk1(F)
        wts = [float(x) for x in voigt.weights(self._dim)]
        return 0.5 * sum(wts[i] * s[i] * F[i] for i in range(self._dim))


def _dyad_basis(n, dim):
    """B_k = sym(e_k x n) as dim-6 Voigt fields, or e_k x n as dim-9 ones
    ((a x n)_ij = a_i n_j), k = 0..2, from a (3, nx, ny, nz) normal
    field."""
    n0, n1, n2 = n[0], n[1], n[2]
    z = torch.zeros_like(n0)
    if dim == 9:
        return [torch.stack([n0, z, z, z, n2, n1, z, z, z]),
                torch.stack([z, n1, z, n2, z, z, z, z, n0]),
                torch.stack([z, z, n2, z, z, z, n1, n0, z])]
    return [torch.stack([n0, z, z, z, 0.5 * n2, 0.5 * n1]),
            torch.stack([z, n1, z, 0.5 * n2, z, 0.5 * n0]),
            torch.stack([z, z, n2, 0.5 * n1, 0.5 * n0, z])]


def _solve3(K, b):
    """x with K x = b per voxel by Cramer's rule; ``K`` a 3x3 nested list
    and ``b`` a list of 3 fields."""
    adj = [[K[1][1] * K[2][2] - K[1][2] * K[2][1],
            K[0][2] * K[2][1] - K[0][1] * K[2][2],
            K[0][1] * K[1][2] - K[0][2] * K[1][1]],
           [K[1][2] * K[2][0] - K[1][0] * K[2][2],
            K[0][0] * K[2][2] - K[0][2] * K[2][0],
            K[0][2] * K[1][0] - K[0][0] * K[1][2]],
           [K[1][0] * K[2][1] - K[1][1] * K[2][0],
            K[0][1] * K[2][0] - K[0][0] * K[2][1],
            K[0][0] * K[1][1] - K[0][1] * K[1][0]]]
    det = K[0][0] * adj[0][0] + K[0][1] * adj[1][0] + K[0][2] * adj[2][0]
    return [(adj[i][0] * b[0] + adj[i][1] * b[1] + adj[i][2] * b[2]) / det
            for i in range(3)]


class _InterfaceMixed(MixedMaterial):
    """What the interface rules share: the ``normals`` field (3, nx, ny,
    nz), pointing from phase 2 into phase 1, kept in its own type on the
    material's device and read in the field's type."""

    def __init__(self, phases: List[Phase], dim: int = 6, normals=None):
        super().__init__(phases, dim=dim)
        if len(phases) < 2:
            raise ValueError(f"{self.rule} mixing requires at least 2 phases")
        self.normals = normals

    def _adapt_views(self, views, mesh):
        if self.normals is not None:
            for v, n in zip(views, shard_field(self.normals, mesh)):
                v.normals = n

    def _normals_like(self, F, normalize=False):
        if self.normals is None:
            raise ValueError(f"{self.rule} mixing requires a normals field")
        return _unit_or_ex(self.normals.to(dtype=F.dtype, device=F.device),
                           normalize)

    def _active(self, F):
        """(i1, i2, c1, c2): with two phases their phi fields (i1, i2
        None); with more the two largest per voxel, renormalized."""
        phis = self.phase_fields(F)
        if len(phis) == 2:
            return None, None, phis[0], phis[1]
        return _top2_phases(torch.stack(phis))


class LaminateMixed(_InterfaceMixed):
    """Rank-1 laminate mixing (LaminateMixedMaterialLaw,
    fibergen.cpp:13086-13736).  More than two phases need linear isotropic
    laws."""

    rule = "laminate"

    def __init__(self, phases: List[Phase], dim: int = 6, normals=None):
        super().__init__(phases, dim=dim, normals=normals)
        if len(phases) > 2 and not all(hasattr(p.law, "iso_moduli")
                                       for p in phases):
            raise ValueError("laminate mixing with more than 2 phases "
                             "requires linear isotropic laws")

    def _two_phase_view(self, F):
        """(law1, law2, c1, c2): the two active phases of each voxel."""
        i1, i2, c1, c2 = self._active(F)
        if i1 is None:
            return self.phases[0].law, self.phases[1].law, c1, c2
        mu, lam = torch.tensor([p.law.iso_moduli() for p in self.phases],
                               dtype=c1.dtype, device=c1.device).T
        return (_FieldIso(mu[i1], lam[i1], self._dim),
                _FieldIso(mu[i2], lam[i2], self._dim), c1, c2)

    def _jump_coeffs(self, c1, c2):
        """(alpha1, alpha2): (c2, c1) keeps the volume average c1 F1 +
        c2 F2 = F."""
        return c2, c1

    def _phase_strains(self, F, view, keep=False):
        """The phase strains (F1, F2) of the laminate at F; with ``keep``
        (nonlinear laws) also what the tangent through the converged jump
        needs (:meth:`dpk1`): the basis B, the weights, a1 and a2, the
        interface mask, K and the phase tangents C_p(F_p)[B_l] at the
        final jump."""
        law1, law2, c1, c2 = view
        mask = (c1 > _THR) & (c2 > _THR)
        n = self._normals_like(F)
        a1, a2 = self._jump_coeffs(c1, c2)
        if self._dim == 3:
            # scalar jump s along n, closed form; conductivity k = 2 iso mu
            return material_kernels.laminate_jump(
                F, n, c1, c2, a1, a2, 2.0 * law1.iso_moduli()[0],
                2.0 * law2.iso_moduli()[0], mask)
        B = _dyad_basis(n, self._dim)
        w = torch.as_tensor(voigt.weights(self._dim), dtype=F.dtype,
                            device=F.device).reshape(-1, 1, 1, 1)
        m1, m2 = c1 * a1 * a1, c2 * a2 * a2
        one, zero = torch.ones_like(c1), torch.zeros_like(c1)

        def strains(a):
            if a is None:
                return F, F
            jump = sum(ak[None] * Bk for ak, Bk in zip(a, B))
            return F - a1[None] * jump, F + a2[None] * jump

        def newton_step(a):
            """One Newton step on the jump (the reference's per-voxel
            Newton, fibergen.cpp:13104-13470 and 13753-14040), from a
            (None: a = 0):
              g_k  = (c2 a2 P2(F2) - c1 a1 P1(F1)) : B_k
              K_kl = B_k : (c1 a1^2 C1(F1) + c2 a2^2 C2(F2)) : B_l"""
            F1, F2 = strains(a)
            dP = (c2 * a2)[None] * law2.pk1(F2) \
                - (c1 * a1)[None] * law1.pk1(F1)
            g = [torch.where(mask, (dP * w * Bk).sum(0), 0.0) for Bk in B]
            del dP
            CB = [m1[None] * law1.dpk1(F1, Bl) + m2[None] * law2.dpk1(F2, Bl)
                  for Bl in B]
            # K = I off the interface keeps the solve regular there
            K = [[torch.where(mask, (B[k] * w * CB[l]).sum(0),
                              one if k == l else zero) for l in range(3)]
                 for k in range(3)]
            del CB
            da = _solve3(K, [-gk for gk in g])
            # keep the previous iterate where the solve blew up
            ok = torch.isfinite(da[0]) & torch.isfinite(da[1]) \
                & torch.isfinite(da[2])
            prev = [zero] * 3 if a is None else a
            return [torch.where(ok, p + d, p) for p, d in zip(prev, da)]

        a = newton_step(None)
        if not (getattr(law1, "is_linear", False)
                and getattr(law2, "is_linear", False)):
            # nonlinear laws: seven further steps (quadratic convergence
            # at moderate strain), as the JAX package takes them
            for _ in range(7):
                a = newton_step(a)
        if not keep:
            return strains(a)
        F1, F2 = strains(a)
        C1B = [law1.dpk1(F1, Bl) for Bl in B]
        C2B = [law2.dpk1(F2, Bl) for Bl in B]
        K = [[torch.where(mask, (B[k] * w * (m1[None] * C1B[l]
                                             + m2[None] * C2B[l])).sum(0),
                          one if k == l else zero) for l in range(3)]
             for k in range(3)]
        return F1, F2, dict(B=B, w=w, a1=a1, a2=a2, mask=mask, K=K, C1B=C1B,
                            C2B=C2B)

    def _jump_state(self, F):
        """(view, F1, F2, tangent data) of :meth:`_phase_strains` with
        ``keep``, kept for the last F (the same tensor, unchanged): the
        Newton operator and the reference material take many tangent
        applications at one F."""
        c = getattr(self, "_jump_cache", None)
        if c is not None and c[0] is F and c[1] == F._version:
            return c[2]
        view = self._two_phase_view(F)
        st = (view,) + self._phase_strains(F, view, keep=True)
        self._jump_cache = (F, F._version, st)
        return st

    def _heat_route(self, F):
        """(phi1, phi2, normals, k1, k2) in F's layout where the input shows
        that the dim-3 closed form takes ``material_kernels.laminate_heat``:
        two phases with linear isotropic laws without lambda (pk1 = 2 mu F),
        a whole float32 or float64 field.  An x-slab's view takes it on its
        slab, one launch a slab on the slab's device (the map is per voxel,
        and the view holds its own cut of phi and the normals).  None
        otherwise (dim 6 and 9, more phases, a list of x-slabs)."""
        if (self._dim != 3 or len(self.phases) != 2 or slabs.sharded(F)
                or F.dtype not in (torch.float32, torch.float64)):
            return None
        ks = []
        for p in self.phases:
            if not (getattr(p.law, "is_linear", False)
                    and hasattr(p.law, "iso_moduli")):
                return None
            mu, lam = p.law.iso_moduli()
            if lam != 0.0:
                return None
            ks.append(2.0 * mu)
        if self.normals is None:
            raise ValueError(f"{self.rule} mixing requires a normals field")
        phi1, phi2 = (torch.broadcast_to(c, F.shape[1:]).contiguous()
                      for c in self.phase_fields(F))
        n = self.normals.to(dtype=F.dtype, device=F.device).contiguous()
        return phi1, phi2, n, ks[0], ks[1]

    def _laminate_heat(self, route, xs, mu_0, out):
        phi1, phi2, n, k1, k2 = route
        return material_kernels.laminate_heat(
            phi1, phi2, n, [x.contiguous() for x in xs], out, k1, k2, mu_0,
            self.rule)

    def pk1(self, F):
        route = self._heat_route(F)
        if route is not None:
            return self._laminate_heat(route, [F], 0.0,
                                       F.new_empty((1,) + F.shape))[0]
        view = self._two_phase_view(F)
        F1, F2 = self._phase_strains(F, view)
        law1, law2, c1, c2 = view
        return c1[None] * law1.pk1(F1) + c2[None] * law2.pk1(F2)

    def stress_diff(self, F, mu_0, lambda_0):
        """P(F) - 2 mu_0 F: on the dim-3 route (:meth:`_heat_route`) one
        launch of the laminate's kernel, else the generic difference."""
        route = self._heat_route(F)
        if route is None:
            return super().stress_diff(F, mu_0, lambda_0)
        return self._laminate_heat(route, [F], mu_0,
                                   F.new_empty((1,) + F.shape))[0]

    def stress_diffs(self, xs, mu_0, lambda_0, out):
        """:meth:`stress_diff` of the B fields ``xs`` into ``out``: on the
        dim-3 route the whole batch through the laminate's kernel (one
        launch up to ``material_kernels.MAX_CASES`` cases), else case by
        case."""
        route = self._heat_route(xs[0])
        if route is None:
            return super().stress_diffs(xs, mu_0, lambda_0, out)
        return self._laminate_heat(route, xs, mu_0, out)

    def w(self, F):
        view = self._two_phase_view(F)
        F1, F2 = self._phase_strains(F, view)
        law1, law2, c1, c2 = view
        return c1 * law1.w(F1) + c2 * law2.w(F2)

    def dpk1(self, F, W):
        """The consistent tangent through the per-voxel solve: the jvp of
        the one-step solve for linear laws; for nonlinear laws the
        derivative of the converged jump, a' = -K^{-1} dg/dF[W] (what the
        JAX package's jvp through its eight Newton steps converges to),
        and dP = c1 C1(F1)[W - a1 a'.B] + c2 C2(F2)[W + a2 a'.B].  On the
        dim-3 route the response is linear in F, so the tangent is pk1(W)
        (a jvp cannot trace the kernel's launch)."""
        if all(getattr(p.law, "is_linear", False) for p in self.phases):
            if self._heat_route(W) is not None:
                return self.pk1(W)
            return torch.func.jvp(self.pk1, (F,), (W,))[1]
        (law1, law2, c1, c2), F1, F2, t = self._jump_state(F)
        B, w, a1, a2, mask = t["B"], t["w"], t["a1"], t["a2"], t["mask"]
        C1W, C2W = law1.dpk1(F1, W), law2.dpk1(F2, W)
        dg = (c2 * a2)[None] * C2W - (c1 * a1)[None] * C1W
        g = [torch.where(mask, -(dg * w * Bk).sum(0), 0.0) for Bk in B]
        del dg
        da = [torch.where(torch.isfinite(d), d, 0.0)
              for d in _solve3(t["K"], g)]
        dJ1 = sum(d[None] * cb for d, cb in zip(da, t["C1B"]))
        dJ2 = sum(d[None] * cb for d, cb in zip(da, t["C2B"]))
        return c1[None] * (C1W - a1[None] * dJ1) \
            + c2[None] * (C2W + a2[None] * dJ2)

    def _eig_range_nonlinear(self, F, zero_trace, chunk=None, phis=None):
        """min and max eigenvalue of the symmetrized tangent through the
        jump solve on the whole grid (its columns dP[e_j] from
        :meth:`dpk1`, the JAX package's full-grid pass for the rules other
        than Voigt, mixing.py:213-235), ``EIG_BATCH`` voxels per
        eigvalsh call."""
        from .mixing import EIG_BATCH
        dim = self._dim
        eye = torch.eye(dim, dtype=F.dtype, device=F.device)
        T = torch.stack([self.dpk1(F, eye[j].reshape(dim, 1, 1, 1)
                                   .expand(F.shape)).reshape(dim, -1)
                         for j in range(dim)])          # (j, i, voxel)
        T = T.permute(2, 1, 0)
        T = 0.5 * (T + T.transpose(1, 2))
        if zero_trace:
            T = T[:, 1:, 1:]
        lo = hi = None
        for b in range(0, T.shape[0], EIG_BATCH):
            e = torch.linalg.eigvalsh(T[b:b + EIG_BATCH])
            lo = e.min() if lo is None else torch.minimum(lo, e.min())
            hi = e.max() if hi is None else torch.maximum(hi, e.max())
        return lo, hi


class InfinityLaminateMixed(LaminateMixed):
    """Infinity-laminate mixing (InfinityLaminateMixedMaterialLaw,
    fibergen.cpp:13737-14067): the laminate's minimization with the fixed
    half weights q1 = q2 = 1/2 on the jump."""

    rule = "infinity_laminate"

    def _jump_coeffs(self, c1, c2):
        half = torch.full_like(c1, 0.5)
        return half, half


def _mm(A, B):
    """The per-voxel product of two 3x3 matrices held as nested lists of
    fields (component arithmetic: a batched matmul of 3x3 matrices per
    voxel is far slower on the card)."""
    return [[A[i][0] * B[0][j] + A[i][1] * B[1][j] + A[i][2] * B[2][j]
             for j in range(3)] for i in range(3)]


def _tr(A):
    return [[A[j][i] for j in range(3)] for i in range(3)]


def _rot_to_e1(n):
    """Rotations R with R n = e1 per voxel (Tensor3x3::rot,
    fibergen.cpp:9232-9266, Rodrigues form) from (3, nx, ny, nz) unit
    vectors, as a nested 3x3 list of fields."""
    c = n[0]                                     # n . e1
    z = torch.zeros_like(c)
    v1, v2 = n[2], -n[1]                         # v = n x e1 = (0, v1, v2)
    V = [[z, -v2, v1], [v2, z, z], [-v1, z, z]]
    VV = _mm(V, V)
    denom = torch.where(1.0 + c > 1e-8, 1.0 + c, 1.0)
    flip = 1.0 + c <= 1e-8
    # n ~ -e1: the rotation by pi about e2, diag(-1, 1, -1)
    return [[torch.where(flip, (-1.0 if i != 1 else 1.0) if i == j else 0.0,
                         (1.0 if i == j else 0.0) + V[i][j] + VV[i][j] / denom)
             for j in range(3)] for i in range(3)]


class FluidityMixed(_InterfaceMixed):
    """Fluidity interface mixing (FluidityMixedMaterialLaw,
    fibergen.cpp:14068-14213) of viscosity's stored stresses: in the frame
    that maps n to e_x the diagonal and the in-plane (yz) components take
    the harmonic fluidity f_R = 1/(c1/f1 + c2/f2), the normal shears (xz,
    xy) the arithmetic f_V = c1 f1 + c2 f2; gamma = R^T Fx(R sigma R^T) R.
    Pure voxels take c1 f1 + c2 f2.  The phases' laws give their fluidity
    as ``mu`` (scalar isotropic laws)."""

    rule = "fluidity"

    def __init__(self, phases: List[Phase], dim: int = 6, normals=None):
        super().__init__(phases, dim=dim, normals=normals)
        if dim != 6:
            raise ValueError("fluidity mixing requires dim 6 (viscosity)")
        if not all(hasattr(p.law, "mu") for p in phases):
            raise ValueError("fluidity mixing requires scalar-isotropic "
                             "laws (fibergen.cpp:14120-14125)")

    def pk1(self, F):
        i1, i2, c1, c2 = self._active(F)
        if i1 is None:
            f1, f2 = self.phases[0].law.mu, self.phases[1].law.mu
        else:
            f = torch.tensor([p.law.mu for p in self.phases],
                             dtype=c1.dtype, device=c1.device)
            f1, f2 = f[i1], f[i2]
        mask = (c1 > _THR) & (c2 > _THR)
        n = self._normals_like(F, normalize=True)
        f_R = 1.0 / (c1 / f1 + c2 / f2)
        f_V = c1 * f1 + c2 * f2
        s0, s1, s2, s3, s4, s5 = F
        sig = [[s0, s5, s4], [s5, s1, s3], [s4, s3, s2]]
        R = _rot_to_e1(n)
        Rt = _tr(R)
        sp = _mm(_mm(R, sig), Rt)
        # the rotated frame: the normal shears (0, 1), (0, 2) take f_V
        spp = [[sp[i][j] * (f_V if (i == 0) != (j == 0) else f_R)
                for j in range(3)] for i in range(3)]
        gam = _mm(_mm(Rt, spp), R)
        mixed = torch.stack([gam[0][0], gam[1][1], gam[2][2], gam[1][2],
                             gam[0][2], gam[0][1]])
        return torch.where(mask[None], mixed, f_V[None] * F)

    def w(self, F):
        wts = torch.as_tensor(voigt.weights(6), dtype=F.dtype,
                              device=F.device).reshape(-1, 1, 1, 1)
        return 0.5 * (self.pk1(F) * wts * F).sum(0)

    def dpk1(self, F, W):
        return self.pk1(W)
