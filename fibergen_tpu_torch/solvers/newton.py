"""Finite-strain Newton-Krylov (runCGHyper, fibergen.cpp:22699-23131) and
nonlinear CG (runNLCGHyper, fibergen.cpp:22480-22695).

Port of fibergen_tpu/solvers/newton.py ``run_newton_cg``: an outer Newton
iteration on the nonlinear Lippmann-Schwinger equation, an inner linear CG
on the linearized operator.  Under mixed boundary conditions (a projector
P that is not the identity) every Gamma application corrects its mean
(ops/gamma.py), the inner solve starts from the mean X0 = M:S0, and the
outer convergence test reads the boundary condition error.  The tangent
dP/dF(F)[Q] is torch.func's jvp of the autodiff PK1
(``newton_tangent="exact"``), or the per-voxel frozen isotropic form
a Q + b tr(Q) I + c Q^T refreshed at each outer iteration
(``"frozen_iso"``, modified Newton).  The Gamma operator is
``ops.gamma.gamma_hyper``: K3 with the full-gradient constants on the
staggered grid, K5 at C = 9 on the collocated grid.

Sharded (``solver.par``), the fields are x-slabs and the scalars lists
replicated over them (``parallel/slabs.py``): every field and scalar op
goes through ``slabs.smap``, the inner products add per-slab partials in
slab order, and the Gamma operator runs the kz-slab chains.

The inner CG runs ``check_every`` iterations on the device per host read:
the host reads the chunk's (gamma, denominator, metric) stacks once and
acts on them in order.  The JAX package reads each chunk one dispatch
behind and keeps the newer chunk's field; this loop is not pipelined and
stops at the end of the chunk that converged, so at ``check_every > 1``
the two differ by at most one chunk of inner iterations per outer one.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import fields, voigt
from ..ops import gamma as gammamod
from ..parallel import slabs
from ..utils.logging import LOG
from .estimators import make_estimator

# component c of Q^T in the dim-9 order [xx, yy, zz, yz, xz, xy, zy, zx, yx]
_T9 = [0, 1, 2, 6, 7, 8, 3, 4, 5]


def metric_for(mat, kind):
    """Estimator metric of the given kind on a field (None for the
    residual and none kinds, which read no field): the component norms,
    the mean stress or the mean energy.  The inner and the outer estimator
    each get the metric of their own kind."""
    def metric(eps):
        if kind == "epsilon":
            return fields.component_norm(eps)
        if kind == "sigma":
            return mat.mean_pk1(eps)
        if kind == "energy":
            return mat.mean_w(eps)
        return None
    return metric


def _host(x):
    return None if x is None else slabs.local(x).cpu().numpy()


def _iso_project(T):
    """Least-squares projection of a 9x9 tangent matrix onto the frozen
    isotropic form a I + b (tr outer) + c (transpose map); returns
    (a, b, c).  Exact for isotropic laws at F = Id."""
    I9 = np.eye(9)
    Ptr = np.zeros((9, 9))
    Ptr[:3, :3] = 1.0
    PT = np.zeros((9, 9))
    for i, j in enumerate(_T9):
        PT[i, j] = 1.0
    G = np.stack([I9.ravel(), Ptr.ravel(), PT.ravel()], axis=1)
    coef, *_ = np.linalg.lstsq(G, np.asarray(T, np.float64).ravel(),
                               rcond=None)
    return tuple(float(x) for x in coef)


def _frozen_abc(solver):
    """Per-voxel (a, b, c) fields of the modified-Newton tangent: each
    phase law's exact 9x9 tangent at the mean deformation, projected onto
    the isotropic form, phi-mixed (VoigtMixed's dP/dF = sum phi_p
    dP_p/dF).  Sharded, the mean is taken across the slabs and each slab
    gets its (a, b, c) from its own phi."""
    mat = solver.mat
    F0 = slabs.local(fields.mean(solver.eps)).reshape(9, 1, 1, 1)
    eye = torch.eye(9, dtype=F0.dtype, device=F0.device)
    coefs = []
    for p in mat.phases:
        cols = [p.law.dpk1(F0, eye[j].reshape(9, 1, 1, 1)) for j in range(9)]
        T = torch.stack([c.reshape(9) for c in cols], dim=1)
        coefs.append(_iso_project(T.cpu().numpy()))
    return slabs.smap(lambda *phis: tuple(
        sum(ph * c[k] for ph, c in zip(phis, coefs)) for k in range(3)),
        *mat.phase_fields(solver.eps))


class _Operator:
    """The linearized operator of one outer iteration at F:
    A(Q) = -Gamma0 (dP/dF(F) - C0) : Q (ApplyOperator, fibergen.cpp:23132),
    with the exact or the frozen tangent."""

    def __init__(self, solver, F, mu0, lam0, abc):
        self.s, self.F, self.mu0, self.lam0, self.abc = (solver, F, mu0,
                                                         lam0, abc)
        self.bc = solver._bca()
        self.zero = solver._vector(np.zeros(9))

    def stress_deriv(self, Q):
        """(dP/dF(F) - C0) : Q (calcStressDeriv, fibergen.cpp:18425-18480);
        frozen: (a - 2 mu0) Q + c Q^T + (b - lam0) tr(Q) I."""
        if self.abc is not None:
            return slabs.smap(self._frozen, Q, self.abc)
        return slabs.smap(self._minus_c0, self.s.mat.dpk1(self.F, Q), Q)

    def _frozen(self, Q, abc):
        a, b, c = abc
        W = (a - 2.0 * self.mu0) * Q + c * Q[_T9]
        W[0:3] += (b - self.lam0) * (Q[0] + Q[1] + Q[2])
        return W

    def _minus_c0(self, dP, Q):
        W = dP - 2.0 * self.mu0 * Q
        if self.lam0 != 0.0:
            W[0:3] -= self.lam0 * (Q[0] + Q[1] + Q[2])
        return W

    def gamma(self, E, tau):
        s = self.s
        return gammamod.gamma_hyper(s.grid, s.scheme, E, self.mu0, self.lam0,
                                    tau, par=s.par, bc=self.bc)

    def __call__(self, Q):
        return self.gamma(self.zero, self.stress_deriv(Q))


def _init(op, X0):
    """X = -Gamma0 P(F) with mean X0; R = A(X) with the same operator A as
    the steps (exact or frozen: a frozen step on an exact R solves another
    system); gamma = <R, R>."""
    X = op.gamma(X0, op.s.mat.pk1(op.F))
    R = op(X)
    return X, R, _plus_tiny(op, fields.inner_l2(R, R))


def _plus_tiny(op, x):
    return slabs.smap(lambda v: v + op.s._tiny, x)


def _step(op, X, R, Q, gamma):
    """One inner CG step in the unshifted form; X, R and Q are updated in
    place.  Returns (gamma of the next step, denominator <Q, Q - A Q>)."""
    W = op(Q)
    denom = _plus_tiny(op, fields.inner_l2_diff(Q, Q, W))
    alpha = slabs.smap(torch.div, gamma, denom)
    slabs.smap(torch.Tensor.addcmul_, X, Q, alpha)      # X + alpha Q
    slabs.smap(lambda r, w, q, a: r.addcmul_(w.sub_(q), a), R, W, Q,
               alpha)                                    # R - alpha (Q - W)
    delta = _plus_tiny(op, fields.inner_l2(R, R))
    slabs.smap(lambda q, d, g, r: q.mul_(d / g).add_(r), Q, delta, gamma,
               R)                                        # R + beta Q
    return delta, denom


def run_newton_cg(solver, E0, S0):
    """Newton-Krylov for finite strain at the prescribed mean deformation
    gradient E0 and mean stress S0 (9 values each; S0 acts through the
    projector's M).  Sets ``solver._canceled`` and
    ``solver._diverged`` on NaN or an indefinite inner operator; counts
    the outer and inner iterations in ``solver.newton_iterations``."""
    opt = solver.opt
    mat = solver.mat
    relax = opt.newton_relax

    # satisfy P : <eps> = E0 (fibergen.cpp:22744-22745)
    dE = np.asarray(E0, np.float64) - voigt.dyad4_mv(
        solver.P, _host(fields.mean(solver.eps)).astype(np.float64))
    solver.eps = slabs.smap(lambda e, d: e + d.reshape(-1, 1, 1, 1),
                            solver.eps, solver._vector(dE))

    metric = metric_for(mat, solver._estimator_kind)
    per_step = solver._estimator_kind in ("epsilon", "sigma", "energy")
    outer_kind = make_estimator(opt.outer_error_estimator).metric_kind
    metric_outer = metric_for(mat, outer_kind)
    ee_outer = make_estimator(opt.outer_error_estimator)
    ee_outer.start(_host(metric_outer(solver.eps)))
    iter_outer = 0
    gamma0 = -1.0
    best_outer = float("inf")
    stall_outer = 0
    K = max(1, int(opt.check_every))
    stats = solver.newton_iterations

    while True:
        if gamma0 < 0 or opt.update_ref == "always":
            solver.calc_ref_material()
        F = solver.eps
        abc = (_frozen_abc(solver) if opt.newton_tangent == "frozen_iso"
               else None)
        op = _Operator(solver, F, solver.mu_0, solver.lambda_0, abc)
        X0 = solver._vector(voigt.dyad4_mv(solver._bc.M, np.asarray(S0)))
        X, R, gamma = _init(op, X0)
        if gamma0 < 0:
            gamma0 = float(slabs.local(gamma))
        Q = slabs.smap(torch.clone, R)
        stats[0] += 1

        ee = make_estimator(opt.error_estimator)
        ee.start(_host(metric(solver.eps)))
        solver._reset_stall()        # the inner CG restarts its errors
        it = 0
        done = False
        def relaxed():
            return slabs.smap(lambda f, x: f + relax * x, F, X)

        while not done:
            eps_checkpoint = solver.eps
            gs, ds, ms = [], [], []
            for _ in range(K):
                gs.append(slabs.local(gamma))
                gamma, denom = _step(op, X, R, Q, gamma)
                ds.append(slabs.local(denom))
                if per_step:
                    ms.append(slabs.local(metric(relaxed())))
            solver.eps = relaxed()
            gs = torch.stack(gs).cpu().numpy()
            ds = torch.stack(ds).cpu().numpy()
            ms = torch.stack(ms).cpu().numpy() if ms else None
            for k in range(K):
                if ds[k] <= 0:
                    solver._canceled = True
                    solver._diverged = True
                    LOG.error(f"indefinite operator (alpha={ds[k]:g}) "
                              "canceling CG!")
                    solver.eps = eps_checkpoint
                    return
                if ee.metric_kind == "residual":
                    ee.update_cg(float(gs[k]), gamma0)
                else:
                    ee.update(None if ms is None else ms[k])
                stats[1] += 1
                it, done = solver._converged(it, ee.abs_error(),
                                             ee.rel_error(), check_bc=False)
                if done:
                    break
        del op, X, R, Q
        if solver._canceled:
            return

        ee_outer.update(_host(metric_outer(solver.eps)))
        # outer stagnation, apart from the inner CG's (each outer iteration
        # costs a whole inner solve, so the patience is short)
        outer_rel = ee_outer.rel_error()
        if outer_rel < best_outer * (1.0 - opt.tol_red):
            best_outer = outer_rel
            stall_outer = 0
        else:
            stall_outer += 1
            if stall_outer >= 5:
                LOG.warn(f"Newton made no progress for {stall_outer} outer "
                         f"iterations at rel. error {outer_rel:g}: stopping "
                         "at the precision floor.")
                break
        solver._reset_stall()
        iter_outer, done = solver._converged(
            iter_outer, ee_outer.abs_error(), outer_rel)
        if done:
            break


def run_nlcg(solver, E0, S0):
    """Nonlinear conjugate gradients for finite strain (runNLCGHyper,
    fibergen.cpp:22480-22695; the JAX package's newton.py:382-452): one
    basic step to the mean, then X <- X + nl_cg_alpha s with s = dX +
    beta s_old, dX = -Gamma0 P(X) with mean M:S0 (grad_step, calcGrad,
    fibergen.cpp:22434-22447), beta by ``nl_cg_beta_scheme`` (steepest
    descent, Polak-Ribiere with its restart, Fletcher-Reeves,
    Hestenes-Stiefel, Dai-Yuan), clipped at 0.  The reference's
    backtracking line search is dead code (fibergen.cpp:22597): the step
    is the constant nl_cg_alpha.  The error is sqrt(<dX, dX>) against its
    first value; one host read per iteration takes <dX, dX> and the inner
    products beta needs."""
    opt = solver.opt
    mat = solver.mat
    solver.calc_ref_material()
    E = solver._bc_mean(np.asarray(E0), np.asarray(S0))
    solver.eps = solver._gamma(solver.eps, solver._vector(E), None, None,
                               solver._bca())
    solver.calc_ref_material()
    mu0, lam0 = solver.mu_0, solver.lambda_0
    bc = solver._bca()
    Emean = solver._vector(voigt.dyad4_mv(solver._bc.M, np.asarray(S0)))
    alpha = opt.nl_cg_alpha
    scheme = opt.nl_cg_beta_scheme
    tiny = np.finfo(np.float64).tiny

    X = solver.eps
    s = slabs.smap(torch.zeros_like, X)
    dX = None
    n2 = 0.0
    n2_first = -1.0
    it = 0
    while True:
        dX_old, n2_old, s_old = dX, n2, s
        dX = gammamod.gamma_hyper(solver.grid, solver.scheme, Emean, mu0,
                                  lam0, mat.pk1(X), alpha=-1.0,
                                  par=solver.par, bc=bc)
        dots = [fields.inner_l2(dX, dX)]
        if it >= 1 and scheme in ("polak_ribiere", "hestenes_stiefel",
                                  "day_yuan"):
            dots.append(fields.inner_l2(dX, dX_old))
            if scheme != "polak_ribiere":
                dots.append(fields.inner_l2_diff(s_old, dX, dX_old))
        host = torch.stack([slabs.local(d) for d in dots]).cpu().numpy()
        n2 = float(host[0])
        if n2_first < 0:
            n2_first = n2 + tiny
        it, done = solver._converged(it, np.sqrt(n2), np.sqrt(n2 / n2_first),
                                     check_bc=False)
        if done:
            break
        beta = 0.0
        if it > 1:
            if scheme == "polak_ribiere":
                dot_old = float(host[1])
                beta = 0.0 if dot_old > 0.2 * n2 else \
                    (n2 - dot_old) / n2_old
            elif scheme == "fletcher_reeves":
                beta = n2 / n2_old
            elif scheme == "hestenes_stiefel":
                beta = (n2 - float(host[1])) / float(host[2])
            elif scheme == "day_yuan":
                beta = n2 / float(host[2])
        beta = max(0.0, beta)
        s = dX if beta == 0.0 else slabs.smap(lambda d, o: d + beta * o, dX,
                                              s_old)
        X = slabs.smap(lambda x, d: x + alpha * d, X, s)
        solver.eps = X
