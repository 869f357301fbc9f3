"""Mixed-precision iterative refinement: deep tolerances from float32 solves.

Port of fibergen_tpu/solvers/refine.py and the refinement driver of its
LSSolver (fibergen_tpu/solvers/ls.py:1811-1990).  A float32 CG stagnates
near a relative error of 1e-7; below that, each sweep

    1. takes the true residual r = E - A eps in float64,
    2. solves the correction A d = r in float32 to ``refine_inner_tol``,
    3. adds d to eps in float64,

until the correction's size relative to eps is at most ``tol``.  Each
sweep multiplies the error by about the inner solve's accuracy, so two or
three sweeps take 1e-6 to 1e-10.

The JAX package forms the float64 residual on the host CPU, since the TPU
has no float64.  The card has it: here the residual and the accumulation
run on the solver's device in float64, through a float64 twin of the
solver (:class:`Refiner`): the same LSSolver code a ``dtype="float64"``
solve runs, on a float64 copy of the material whose mixed moduli are
mixed anew from the float64 phase fields (the float32 values are exact
in float64, so the twin's operator is the float32 solve's problem without
its rounding).  On the card that is K1, K3 and K2 (or K5 on the collocated
grid, K4 in heat) in their double instances.  The corrections are float32
solves through the solver's own CG step (K1, K3, K2 on the staggered
elasticity route; K5 collocated), or through the lm6 step after an lm6
solve (solvers/lowmem.py).

Two defects of the JAX package are not copied: its solver's ``eps`` stays
None when a sweep raises (ls.py:1854), and its float64 material (cached
on the solver, refine.py:90) is never rebuilt when the phases change.
Here ``eps`` always holds the latest solution, and the float64 twin is
rebuilt whenever the tensors the material reads (``state()``) are others.
"""
from __future__ import annotations

import copy
import dataclasses
import math
import time

import numpy as np
import torch

from ..core import voigt
from ..utils.logging import LOG
from . import lowmem

_MATERIALS = "fibergen_tpu_torch.materials"
# cached derivatives of a material's fields: rebuilt from the float64
# fields, never cast
_CACHES = ("_iso_cast", "_iso_slabs", "_phi_slabs", "_w_cache",
           "_jump_cache")


def material64(mat):
    """A float64 copy of the material ``mat`` (phases, laws, the interface
    normals, a DfgMaterial's inner material): each float tensor it holds
    cast to float64, shared tensors cast once, and the cached mixed moduli
    left to be mixed anew from the float64 phi (kept, cast, after
    ``drop_phi``, which freed the phi they were mixed from)."""
    memo = {}

    def cast(x):
        key = id(x)
        if key in memo:
            return memo[key][1]
        if torch.is_tensor(x):
            out = x.to(torch.float64) if x.is_floating_point() else \
                (x.to(torch.complex128) if x.is_complex() else x)
        elif isinstance(x, list):
            out = []
            memo[key] = (x, out)
            out.extend(cast(v) for v in x)
            return out
        elif isinstance(x, tuple):
            out = tuple(cast(v) for v in x)
        elif isinstance(x, dict):
            out = {k: cast(v) for k, v in x.items()}
        elif type(x).__module__.startswith(_MATERIALS) \
                and hasattr(x, "__dict__"):
            out = copy.copy(x)
            memo[key] = (x, out)
            for name, v in vars(x).items():
                if name in _CACHES:
                    delattr(out, name)
                else:
                    setattr(out, name, cast(v))
            if getattr(out, "_iso_key", None) is not None \
                    and not out._phi_dropped:
                out._iso_key = out._iso_val = None
            return out
        else:
            out = x
        memo[key] = (x, out)
        return out

    return cast(mat)


def _wnorm(x):
    """sqrt(<x, x>), the Voigt-weighted mean square of a (dim, ...) field,
    reduced one component at a time."""
    w = voigt.weights(x.shape[0])
    acc = 0.0
    for c in range(x.shape[0]):
        acc = acc + float(w[c]) * float((x[c] * x[c]).sum())
    return math.sqrt(acc / math.prod(x.shape[1:]))


class Refiner:
    """The float64 twin of a float32 solver: the residual, the means."""

    def __init__(self, s, mat64):
        from .ls import LSSolver
        opt = dataclasses.replace(s.opt, dtype="float64", refine="off",
                                  low_mem="off")
        self.lss = LSSolver(s.grid, mat64, opt, device=s.device)
        self.lss.mu_0, self.lss.lambda_0 = s.mu_0, s.lambda_0
        self.lss._settle_route()

    def residual(self, eps64, E):
        """r = -Gamma (C - C0) eps + (E - eps) in float64 (the CG init's
        residual) and sqrt(<r, r>)."""
        t = self.lss
        mu_x, lam_x = t._moduli()
        zero = t._vector(np.zeros(t.dim))
        r = t._gamma(eps64, zero, mu_x, lam_x)
        r.add_(t._vector(E).reshape(-1, 1, 1, 1) - eps64)
        return r, _wnorm(r)

    def mean_strain(self, eps64):
        return eps64.mean(dim=(-3, -2, -1)).cpu().numpy()

    def mean_stress(self, eps64):
        return self.lss.mat.mean_pk1(eps64).cpu().numpy()

    def mean_energy(self, eps64):
        return float(self.lss.mat.mean_w(eps64))


def refiner(s):
    """The solver's float64 twin, rebuilt when the tensors its material
    reads are others than at the last build; it takes the solver's
    reference medium."""
    key = s.mat.state()
    cached = getattr(s, "_refiner_cache", None)
    if cached is None or len(cached[0]) != len(key) or not all(
            a is b for a, b in zip(cached[0], key)):
        cached = (key, Refiner(s, material64(s.mat)))
        s._refiner_cache = cached
    ref = cached[1]
    ref.lss.mu_0, ref.lss.lambda_0 = s.mu_0, s.lambda_0
    return ref


def _solve_correction(s, rhs, maxiter=1000):
    """d with A d = rhs (A = I + Gamma (C - C0)), a float32 CG from d = 0
    on the solver's own step (the lm6 step after an lm6 solve; rhs a
    float64 device field, cast one component at a time there).  Stops on
    the CG recurrence, sqrt(gamma / gamma_0) <= refine_inner_tol, after
    ``maxiter`` steps, or after three chunks of ``check_every`` steps
    without a 1e-3 gain (the float32 floor)."""
    K = max(1, int(s.opt.check_every))
    tiny = s._tiny
    lm6 = s._route == "lm6"
    wv = voigt.weights(s.dim)
    if lm6:
        r = [rhs[c].to(s.dtype) for c in range(6)]
        d = [torch.zeros_like(x) for x in r]
        p = [torch.zeros_like(x) for x in r]
        step = lambda *a: lowmem.lm6_step(s, *a, metric=False)
    else:
        r = rhs.to(s.dtype)
        d, p = torch.zeros_like(r), torch.zeros_like(r)
        mu_x, lam_x = s._moduli()
        zero = s._vector(np.zeros(s.dim))
        if s._route == "stacked":
            step = lambda *a: lowmem.stacked_step(s, *a, metric=False)
        else:
            step = lambda *a: s._cg_step(*a, mu_x, lam_x, zero,
                                         metric=False)
    gamma = 0.0
    for c in range(s.dim):
        gamma = gamma + float(wv[c]) * (r[c] * r[c]).sum()
    gamma = gamma / math.prod(s.grid.shape) + tiny
    g0 = float(gamma)
    gamma_prev = gamma
    it, best, stall = 0, float("inf"), 0
    while True:
        for _ in range(K):
            d, r, p, gamma, gamma_prev, _ = step(d, r, p, gamma, gamma_prev)
        it += K
        rel = math.sqrt(max(0.0, float(gamma)) / g0)
        if rel <= s.opt.refine_inner_tol or it >= maxiter:
            break
        if rel < best * (1.0 - 1e-3):
            best, stall = rel, 0
        else:
            stall += 1
            if stall >= 3:
                break
    del r, p
    return (torch.stack(d) if lm6 else d), it


def refine(s, E):
    """The refinement sweeps after the float32 CG of ``s`` reached
    ``max(tol, 1e-6)`` (LSSolver._refine, ls.py:1839-1897): ``s.eps64``
    holds the float64 solution, ``s.eps`` its float32 copy; the correction
    sizes join ``s.residuals``, the sweeps and their inner iterations go
    to ``s.refine_sweeps`` and ``s.refine_inner_iters``, and each sweep's
    (correction size, float64 residual norm before it, inner iterations)
    to ``s.refine_log``."""
    t0 = time.perf_counter()
    ref = refiner(s)
    tol = s.opt.tol
    eps64 = s.eps.to(torch.float64)
    # free the float32 field for the sweeps: it is rebuilt from eps64 at
    # the end, also when a sweep raises
    s.eps = None
    LOG.info(f"# Mixed-precision refinement to tol {tol:g} (float32 "
             f"corrections, float64 residuals on {s.device})")
    s.refine_sweeps = 0
    s.refine_inner_iters = 0
    s.refine_log = []
    prev_rel, rel, converged = None, float("inf"), False
    try:
        for sweep in range(1, s.opt.refine_max_sweeps + 1):
            s.refine_sweeps = sweep
            r64, rnorm = ref.residual(eps64, E)
            d, inner = s._solve_correction(r64)
            del r64
            s.refine_inner_iters += inner
            d64 = d.to(torch.float64)
            del d
            eps64.add_(d64)
            dn, en = _wnorm(d64), _wnorm(eps64)
            del d64
            rel = dn / (en + float(np.finfo(np.float64).tiny))
            s.residuals.append(rel)
            s.refine_log.append((rel, rnorm, inner))
            LOG.info(f"# Refinement sweep {sweep}: correction rel. = "
                     f"{rel:g} f64 residual = {rnorm:g} ({inner} inner "
                     f"iterations)")
            if rel <= tol:
                converged = True
                LOG.info("Converged.")
                break
            if prev_rel is not None and rel > 0.5 * prev_rel:
                LOG.warn(f"refinement stalled at rel. error {rel:g} "
                         f"(tolerance {tol:g}): stopping at the "
                         "mixed-precision floor.")
                break
            prev_rel = rel
        if not converged and prev_rel is not None and rel <= prev_rel:
            LOG.warn(f"refinement stopped after {s.opt.refine_max_sweeps} "
                     f"sweeps at rel. error {rel:g} (tolerance {tol:g})")
    finally:
        s.eps64 = eps64
        s.eps = eps64.to(s.dtype)
        s._refiner = ref
    LOG.info(f"refinement wall time {time.perf_counter() - t0:.3f} s")
