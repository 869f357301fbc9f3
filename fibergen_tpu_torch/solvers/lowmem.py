"""The low-memory linear CG on the staggered grid.

Port of the JAX package's ``low_mem`` CG (fibergen_tpu/solvers/ls.py:
416-502, 720-935, 1126-1163, 2316-2319).  The plain CG step holds eps, r,
the previous and the new direction, the operator's output w and the two
field-sized products of its ``<r, r>``: 7 * dim fields beside the material
(PLAIN_FIELDS).  The low-memory step never forms w or a 6-component
stress: it applies the operator component by component around the K3
chain, u = G0 div((C - C0) : p), and reads w's components off u twice,
once for the CG denominator and once for the update, each reduced to a
scalar at once (:func:`lm6_step`).  Its peak is the state eps, r and p,
the spectral chain's input, spectrum and output, and one component's
temporaries.

Two routes, as in the JAX package:

* ``"lm6"``, the tuple state: eps, r and p are lists of six separate
  (nx, ny, nz) tensors across the whole solve (no 6-component buffer
  exists until ``eps`` is stacked once at the end); elasticity and the
  viscosity Delta scheme, trivial or mixed BCs, under every estimator, for
  materials on the isotropic route (``MixedMaterial.iso_route``), with
  ``check_every`` > 1 (the JAX package's chunked driver);
* ``"stacked"``, elasticity with trivial BCs otherwise (``check_every`` 1,
  or a material off the isotropic route): the same component-wise step on
  (6, nx, ny, nz) tensors, or, off the isotropic route, the plain stress
  difference and divergence around K3 with w's components read off u
  (:func:`generic_step`).

The G0 is ``green.g0_staggered_fused``: K3 on the card, its twin on the
CPU.  The component stencils are plain PyTorch, as the JAX package keeps
them in ``jnp``; ``del`` does the work of its ``optimization_barrier``
chains: at most one component's temporaries are alive at a time.

``low_mem="on"`` takes a low-memory route where one applies (unsharded,
``gamma_scheme="staggered"``, ``g0_solver="fft"``, elasticity or
viscosity) and the plain step elsewhere.  ``"auto"`` takes it only on a
card whose free memory cannot hold the plain step's fields
(:func:`plain_solve_bytes` against ``torch.cuda.mem_get_info``); the JAX
package's threshold of 11e9 bytes (ls.py:433) is its 16 GB TPU's, and the
plain route holds 512^3 float32 in 23 GiB of the H100's 80 GB.
"""
from __future__ import annotations

import math

import torch

from ..core import voigt
from ..ops import green, staggered
from .bc import bc_correction

# fields of the plain CG step beside the material, per component: eps, r,
# p_prev, p and w, and the two products fields.inner_l2 forms for <r, r>
PLAIN_FIELDS = 7
# fields of the lm6 step beside the material: eps, r and p (18), the K3
# chain's input, its half spectrum and its output (3 each); the component
# stencils add a few fields' worth of temporaries before the chain starts
LM6_FIELDS = 27

_WV = [float(w) for w in voigt.weights(6)]


def plain_solve_bytes(grid, dim, itemsize):
    """The bytes the plain CG step allocates beside the material."""
    return PLAIN_FIELDS * dim * math.prod(grid.shape) * itemsize


def lm6_solve_bytes(grid, itemsize):
    """The bytes the lm6 step allocates beside the material, the chain's
    half spectrum counted at its (nz // 2 + 1) planes."""
    nxyz = math.prod(grid.shape)
    spec = 3 * grid.nx * grid.ny * (grid.nz // 2 + 1) * 2
    return ((LM6_FIELDS - 3) * nxyz + spec) * itemsize


def engaged(s) -> bool:
    """Whether ``low_mem`` engages for solver ``s``: "on"; "auto" on a card
    whose free memory (the driver's free bytes and what the caching
    allocator holds unused) is below :func:`plain_solve_bytes`."""
    o = s.opt.low_mem
    if o != "auto":
        return o == "on"
    if s.device.type != "cuda":
        return False
    free, _ = torch.cuda.mem_get_info(s.device)
    free += (torch.cuda.memory_reserved(s.device)
             - torch.cuda.memory_allocated(s.device))
    itemsize = torch.empty((), dtype=s.dtype).element_size()
    return plain_solve_bytes(s.grid, s.dim, itemsize) > free


def route(s, bc, K):
    """The low-memory route of a linear CG solve ("lm6", "stacked") or None
    for the plain step (the JAX package's ``_lm6_capable`` and cg_step
    dispatch, ls.py:619-627, 1161-1165, 1669)."""
    if not (s.par is None and s.scheme == "staggered"
            and s.opt.g0_solver == "fft"
            and s.mode in ("elasticity", "viscosity") and engaged(s)):
        return None
    if K > 1 and s.mat.iso_route():
        return "lm6"
    if s.mode == "elasticity" and bc is None:
        return "stacked"
    return None


class _Op:
    """The low-memory operator of one solve: the moduli planes and the
    constants of the reference medium."""

    def __init__(self, s, bc, visc):
        self.grid = s.grid
        self.mu_x, self.lam_x = s.mat.iso_moduli(s.dtype, s.device)
        self.mu0, self.lam0 = s.mu_0, s.lambda_0
        self.no_ltr = self.lam0 == 0.0 and all(
            float(p.law.iso_moduli()[1]) == 0.0 for p in s.mat.phases)
        self.bc, self.visc = bc, visc
        self.nxyz = float(math.prod(s.grid.shape))
        self.tiny = s._tiny

    def _ltr(self, p):
        """(lam(x) - lam_0) tr(p), or 0.0 when both lambdas vanish."""
        if self.no_ltr:
            return 0.0
        return (self.lam_x - self.lam0) * (p[0] + p[1] + p[2])

    def apply(self, p, dtype, device):
        """u = G0 div((C - C0) : p) (the dual G0 of the Delta scheme in
        viscosity) and, where the viscosity term or a mixed BC needs it,
        the mean of (C - C0) : p.  The three rows of the divergence are
        formed one at a time, the trace term recomputed for each."""
        grid = self.grid
        two_dmu = 2.0 * (self.mu_x - self.mu0)
        f = torch.empty((3,) + grid.shape, dtype=dtype, device=device)
        for i in range(3):
            ltr = self._ltr(p)
            f[i] = staggered.div_stress_diff_comp(grid, p, two_dmu, ltr, i)
            del ltr
        tmean = None
        if self.visc or self.bc is not None:
            ltr = self._ltr(p)
            mean_ltr = 0.0 if self.no_ltr else ltr.mean()
            del ltr
            tmean = torch.stack([(two_dmu * p[c]).mean()
                                 + (mean_ltr if c < 3 else 0.0)
                                 for c in range(6)])
        del two_dmu
        if self.visc:
            u = green.g0_staggered_fused(grid, -self.mu0, float("inf"), f)
        else:
            u = green.g0_staggered_fused(grid, self.mu0, self.lam0, f)
        return u, tmean

    def w_terms(self, p, tmean):
        """(adj, taufac, two_dmu, ltr) of the w components: w_c = eps_c(u)
        + adj[c] + taufac ((C - C0) : p)_c, the Delta scheme's tau term
        (alpha = -1) and the mean correction of a mixed BC
        (delta_operator's staggered branch, initBCProjector)."""
        adj, taufac, two_dmu, ltr = None, 0.0, None, 0.0
        if self.visc:
            taufac = -1.0 / (2.0 * self.mu0)
            adj = -taufac * tmean
            two_dmu = 2.0 * (self.mu_x - self.mu0)
            ltr = self._ltr(p)
        if self.bc is not None:
            R = bc_correction(self.bc, tmean, torch.stack(
                [pc.mean() for pc in p]) if self.bc.bc_relax != 1.0 else None)
            adj = -R if adj is None else adj - R
        return adj, taufac, two_dmu, ltr

    def w_comp(self, u, c, p, terms):
        adj, taufac, two_dmu, ltr = terms
        w = staggered.eps_staggered_comp(self.grid, u, c)
        if adj is not None:
            w = w + adj[c]
        if self.visc:
            w = w + taufac * (two_dmu * p[c] + (ltr if c < 3 else 0.0))
        return w


def _op(s, bc):
    return _Op(s, bc, s.mode == "viscosity")


def lm6_step(s, eps, r, p, gamma, gamma_prev, bc=None, metric=True):
    """One CG step on component sequences (lists of six tensors, or the
    rows of (6, nx, ny, nz) tensors), updated in place: p = r + beta p,
    u = G0 div((C - C0) : p), the denominator <p, p - w> and then the
    updates of eps and r, w's components read off u each time.  Returns
    (eps, r, p, delta, gamma, metric) as LSSolver._cg_step does."""
    op = _op(s, bc)
    beta = gamma / gamma_prev
    for c in range(6):
        p[c].mul_(beta).add_(r[c])
    u, tmean = op.apply(p, s.dtype, s.device)
    terms = op.w_terms(p, tmean)
    acc = 0.0
    for c in range(6):
        w = op.w_comp(u, c, p, terms)
        acc = acc + _WV[c] * (p[c] * (p[c] - w)).sum()
        del w
    alpha = gamma / (acc / op.nxyz + op.tiny)
    delta = 0.0
    for c in range(6):
        w = op.w_comp(u, c, p, terms)
        r[c].sub_(alpha * (p[c] - w))
        del w
        eps[c].add_(alpha * p[c])
        delta = delta + _WV[c] * (r[c] * r[c]).sum()
    del u, terms
    delta = delta / op.nxyz + op.tiny
    met = None
    if metric:
        met = lm6_metric(s, eps) if isinstance(eps, list) else s._metric(eps)
    return eps, r, p, delta, gamma, met


def _residual(s, op, eps, Ej):
    """The exact residual r_c = krylov(eps)_c + E_c - eps_c as six
    tensors, and <r, r>."""
    u, tmean = op.apply(eps, s.dtype, s.device)
    terms = op.w_terms(eps, tmean)
    r, acc = [], 0.0
    for c in range(6):
        rc = op.w_comp(u, c, eps, terms)
        rc.add_(Ej[c] - eps[c])
        acc = acc + _WV[c] * (rc * rc).sum()
        r.append(rc)
    return r, acc / op.nxyz + op.tiny


def lm6_init(s, Ej, bc=None):
    """The tuple state at eps = E (lm6_init, ls.py:879-898): eps_c the
    constant E_c, r = krylov(E) (E - eps vanishes), p = 0 and
    gamma_prev = gamma; returns (eps, r, p, gamma, gamma, metric)."""
    op = _op(s, bc)
    shape = s.grid.shape
    eps = [torch.empty(shape, dtype=s.dtype, device=s.device).fill_(Ej[c])
           for c in range(6)]
    r, gamma0 = _residual(s, op, [Ej[c] for c in range(6)], Ej)
    p = [torch.zeros(shape, dtype=s.dtype, device=s.device)
         for _ in range(6)]
    return eps, r, p, gamma0, gamma0, lm6_metric(s, eps)


def lm6_reinit(s, eps, Ej, bc=None):
    """The exact residual and <r, r> of the tuple state (the cg_reinit
    path on the lm6 route)."""
    return _residual(s, _op(s, bc), eps, Ej)


def _iso_stress(mu_x, lam_x, eps, c, ltr):
    return 2.0 * mu_x * eps[c] + (ltr if c < 3 else 0.0)


def lm6_metric(s, eps):
    """The estimator's metric of the tuple state (lm6_metric, ls.py:746-761):
    the component norms, the mean stress of the isotropic law or its mean
    energy; None for the residual estimator."""
    kind = s._estimator_kind
    if kind == "epsilon":
        return torch.sqrt(torch.stack([(e * e).mean() for e in eps]))
    if kind not in ("sigma", "energy"):
        return None
    mu_x, lam_x = s.mat.iso_moduli(s.dtype, s.device)
    ltr = lam_x * (eps[0] + eps[1] + eps[2])
    if kind == "sigma":
        return torch.stack([_iso_stress(mu_x, lam_x, eps, c, ltr).mean()
                            for c in range(6)])
    acc = 0.0
    for c in range(6):
        acc = acc + 0.5 * _WV[c] * (_iso_stress(mu_x, lam_x, eps, c, ltr)
                                    * eps[c]).mean()
    return acc


def lm6_means(s, eps):
    """(mean strain, mean stress) of the tuple state, what bc_error reads
    while ``s.eps`` is not formed (lm6_means, ls.py:733-744)."""
    mu_x, lam_x = s.mat.iso_moduli(s.dtype, s.device)
    ltr = lam_x * (eps[0] + eps[1] + eps[2])
    return (torch.stack([e.mean() for e in eps]),
            torch.stack([_iso_stress(mu_x, lam_x, eps, c, ltr).mean()
                         for c in range(6)]))


def generic_step(s, eps, r, p_prev, gamma, gamma_prev, metric=True):
    """The stacked low-memory step off the isotropic route (cg_step_lowmem's
    generic branch, ls.py:455-469): the plain stress difference and
    divergence around K3, w's components read off u for the denominator
    and again for the updates."""
    grid, tiny = s.grid, s._tiny
    nxyz = float(math.prod(grid.shape))
    p = r + (gamma / gamma_prev) * p_prev
    tau = s.mat.stress_diff(p, s.mu_0, s.lambda_0)
    f = staggered.div_staggered(grid, tau)
    del tau
    u = green.g0_staggered_fused(grid, s.mu_0, s.lambda_0, f)
    del f
    acc = 0.0
    for c in range(6):
        w = staggered.eps_staggered_comp(grid, u, c)
        acc = acc + _WV[c] * (p[c] * (p[c] - w)).sum()
        del w
    alpha = gamma / (acc / nxyz + tiny)
    delta = 0.0
    for c in range(6):
        w = staggered.eps_staggered_comp(grid, u, c)
        r[c].sub_(alpha * (p[c] - w))
        del w
        eps[c].add_(alpha * p[c])
        delta = delta + _WV[c] * (r[c] * r[c]).sum()
    delta = delta / nxyz + tiny
    return eps, r, p, delta, gamma, s._metric(eps) if metric else None


def stacked_step(s, eps, r, p, gamma, gamma_prev, metric=True):
    """The stacked low-memory step (cg_step_lowmem, ls.py:435-502): the
    component-wise :func:`lm6_step` on (6, ...) tensors on the isotropic
    route, :func:`generic_step` off it."""
    if s.mat.iso_route():
        return lm6_step(s, eps, r, p, gamma, gamma_prev, metric=metric)
    return generic_step(s, eps, r, p, gamma, gamma_prev, metric=metric)
