"""Lippmann-Schwinger solver: linear CG on the staggered grid.

Port of fibergen_tpu/solvers/ls.py (the reference's LSSolver,
fibergen.cpp:14643-24741) for trivial (pure strain) boundary conditions,
the staggered discretization and one device, in four modes.  On a card each
CG step runs hand-written kernels, on the CPU their plain twins:

* elasticity: K1 (ops/stencil_kernels.py), the K3 G0 chain
  (ops/spectral_kernels.py, with its own transforms), K2;
* heat and porous flow: plain stencils around the scalar K4 chain
  (ops/gamma.py gamma_heat_staggered);
* viscosity (the Delta dual scheme): K1 tau-sum mode, K3 with the dual
  constants, K2 Delta mode (ops/gamma.py fused_visc).

The scalars gamma, gamma_prev and beta stay on the device; the host reads
the residual history once per ``check_every`` iterations.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import List, Optional

import numpy as np
import torch

from ..core import fields
from ..core.device import resolve_device, resolve_dtype
from ..ops import gamma as gammamod
from ..ops import green
from ..ops.stencil_kernels import eps_from_u_dot, stress_div_beta
from ..utils.logging import LOG
from .estimators import make_estimator

MODE_DIM = {"elasticity": 6, "heat": 3, "porous": 3, "viscosity": 6}


class SolverError(RuntimeError):
    pass


@dataclasses.dataclass
class SolverOptions:
    """Solver configuration: the field names and defaults of
    fibergen_tpu.SolverOptions (fibergen.cpp:14780-14892).  Options this
    port does not implement raise NotImplementedError at LSSolver
    construction when set to anything but their default."""

    mode: str = "elasticity"
    method: str = "cg"
    gamma_scheme: str = "auto"
    tol: float = 1e-4
    tol_red: float = math.sqrt(np.finfo(np.float64).eps)
    abs_tol: float = float(np.finfo(np.float64).eps)
    bc_tol: float = 1e-3
    maxiter: int = 10000
    update_ref: str = "loadstep"
    ref_scale: float = 1.0
    newton_relax: float = 1.0
    basic_relax: float = 1.0
    bc_relax: float = 1.0
    cg_inner_product: str = "l2"
    cg_reinit: int = 0
    newton_tangent: str = "exact"
    nl_cg_beta_scheme: str = "polak_ribiere"
    nl_cg_c: float = 0.5
    nl_cg_tau: float = 0.5
    nl_cg_alpha: float = 1.0
    error_estimator: str = "epsilon"
    outer_error_estimator: str = "epsilon"
    # CG iterations per host read of the residual history; every
    # iteration's residual is recorded, convergence is acted on per chunk
    check_every: int = 1
    use_pallas: str = "auto"
    use_sweep: str = "auto"
    sharding_fallback: str = "error"
    use_dim2: str = "auto"
    low_mem: str = "auto"
    batch_load_cases: str = "auto"
    step_mode: bool = False
    fft_backend: "str | None" = None
    refine: str = "auto"
    refine_max_sweeps: int = 10
    adaptive_drain: str = "auto"
    refine_inner_tol: float = 1e-5
    g0_solver: str = "fft"
    freq_hack: bool = False
    loadsteps: int = 1
    first_loadstep: int = -1
    loadstep_extrapolation_order: int = 0
    loadstep_extrapolation_method: str = "polynomial"
    max_loadstep_splits: int = 8
    print_mean: bool = False
    print_detF: bool = False
    dtype: str = "float64"
    ref_mu: Optional[float] = None
    ref_lambda: Optional[float] = None

    def resolved_scheme(self) -> str:
        """'auto' resolution (fibergen.cpp:15068-15079)."""
        s = self.gamma_scheme.replace("-", "_")
        return "staggered" if s == "auto" else s


# options implemented for any value; the rest must keep their default or
# take one of the values listed (each listed value behaves like the port's
# one path: no drain, no low-memory step, no 2-D pipeline)
_FREE = {"tol", "tol_red", "abs_tol", "bc_tol", "maxiter", "update_ref",
         "ref_scale", "error_estimator", "check_every", "dtype", "refine",
         "print_mean", "ref_mu", "ref_lambda"}
_ALSO = {"mode": ("heat", "porous", "viscosity"),
         "gamma_scheme": ("staggered",), "adaptive_drain": ("off",),
         "low_mem": ("off",), "use_dim2": ("off",)}


def _check_options(opt: SolverOptions):
    for f in dataclasses.fields(opt):
        if f.name in _FREE:
            continue
        v = getattr(opt, f.name)
        if v != f.default and v not in _ALSO.get(f.name, ()):
            raise NotImplementedError(
                f"SolverOptions.{f.name}={v!r} is not ported yet (the port "
                f"implements the staggered CG of elasticity, heat, porous "
                f"flow and viscosity)")
    if opt.refine not in ("auto", "on", "off"):
        raise ValueError(f"refine must be auto/on/off, got {opt.refine!r}")
    make_estimator(opt.error_estimator)


class LSSolver:
    """FFT-homogenization solver on a periodic voxel grid.

    ``device`` defaults to ``cuda`` and raises without a card; pass
    ``device="cpu"`` for the plain PyTorch path."""

    def __init__(self, grid, material, options: SolverOptions = None,
                 device=None):
        self.device = resolve_device(device)
        self.grid = grid
        self.mat = material
        self.opt = options or SolverOptions()
        _check_options(self.opt)
        self.mode = self.opt.mode
        self.dim = MODE_DIM[self.mode]
        if material.dim != self.dim:
            raise SolverError(
                f"material dim {material.dim} incompatible with mode "
                f"'{self.mode}'")
        if self.mode == "viscosity" and any(
                float(p.law.iso_moduli()[1]) != 0.0 for p in material.phases):
            raise NotImplementedError(
                "viscosity phases that carry a lambda take the JAX package's "
                "generic Delta path, which is not ported yet")
        self.scheme = self.opt.resolved_scheme()
        self.dtype = resolve_dtype(self.opt.dtype)
        self._tiny = float(np.finfo(np.float64 if self.dtype == torch.float64
                                    else np.float32).tiny)
        self.E = np.zeros(self.dim)
        self.mu_0 = (self.opt.ref_mu if self.opt.ref_mu is not None
                     else float("nan"))
        self.lambda_0 = (self.opt.ref_lambda if self.opt.ref_lambda is not None
                         else 0.0)
        self.eps: Optional[torch.Tensor] = None
        self.residuals: List[float] = []
        self.solve_time = 0.0
        self._canceled = False
        self._eig_memo = None
        self._estimator_kind = make_estimator(
            self.opt.error_estimator).metric_kind

    # ------------------------------------------------------------------ API
    def set_strain(self, e):
        """Prescribe the mean strain (setStrain, fibergen.cpp:20692)."""
        e = np.asarray(e, dtype=np.float64).reshape(-1)
        out = np.zeros(self.dim)
        n = min(e.size, self.dim)
        out[:n] = e[:n]
        self.E = out

    def get_field(self, name: str) -> np.ndarray:
        """Solution field as a host numpy array with leading component axis
        (GetField, fibergen.cpp:27179)."""
        if name == "epsilon":
            return self.eps.cpu().numpy()
        raise NotImplementedError(f"field '{name}' is not ported yet")

    def calc_mean_strain(self):
        return fields.mean(self.eps).cpu().numpy()

    def calc_mean_stress(self):
        return self.mat.mean_pk1(self.eps).cpu().numpy()

    # --------------------------------------------------------- ref material
    def calc_ref_material(self):
        """(mu_0, lambda_0) from the per-voxel tangent eigenvalue bounds
        (calcRefMaterial, fibergen.cpp:22283-22313): mu_0 = 0.5 ref_scale
        0.5 (lmin + lmax), lambda_0 = 0.  Linear materials: memoized on the
        identity of the mixed moduli."""
        iso = self.mat._all_iso()
        key = tuple(id(t) for t in iso)
        if self._eig_memo is not None and self._eig_memo[0] == key:
            lmin, lmax = self._eig_memo[1]
        else:
            lmin, lmax = (float(x) for x in self.mat.eig_range(
                zero_trace=self.mode == "viscosity"))
            self._eig_memo = (key, (lmin, lmax))
        if lmin < 0:
            LOG.warn(f"negative tangent eigenvalue ({lmin}); cutting off at 0")
            lmin = 0.0
        self.mu_0 = 0.5 * self.opt.ref_scale * (0.5 * (lmin + lmax))
        self.lambda_0 = 0.0
        LOG.info(f"adjusting mu_ref={self.mu_0:g}, lambda_ref={self.lambda_0:g}")

    # -------------------------------------------------------------- run
    def run(self) -> bool:
        """Full solve (run, fibergen.cpp:21247-21398).  Returns True on
        failure or cancel, False on success, like the reference."""
        self.residuals = []
        self._canceled = False
        g = self.grid
        LOG.info(f"RVE: dims={g.dx}x{g.dy}x{g.dz} voxels={g.nx}x{g.ny}x{g.nz}")
        LOG.info(f"mode: {self.opt.method} {self.scheme} {self.mode} "
                 f"{self.opt.cg_inner_product}")
        LOG.info(f"tolerances: relative={self.opt.tol} "
                 f"absolute={self.opt.abs_tol}")
        for p in self.mat.phases:
            LOG.info(f" - {p.name}: {p.law}")
        self.eps = None
        t0 = time.perf_counter()
        self._best_rel = float("inf")
        self._stall = 0
        if self.opt.update_ref != "never" or not np.isfinite(self.mu_0):
            self.calc_ref_material()
        self._run_cg(self.E)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.solve_time = time.perf_counter() - t0
        if self.opt.print_mean:
            LOG.info(f"mean elastic strain = {self.calc_mean_strain()}")
            LOG.info(f"average elastic stress = {self.calc_mean_stress()}")
        if self._canceled:
            LOG.error("loadsteps canceled")
            return True
        return False

    def _refine_wanted(self) -> bool:
        """Whether the reference would engage mixed-precision refinement
        (fibergen_tpu solvers/ls.py _refine_ok on this path)."""
        o = self.opt
        want = o.refine == "on" or (o.refine == "auto" and o.tol < 3e-7)
        return want and self.dtype == torch.float32

    # ------------------------------------------------------------ CG
    def _metric(self, eps):
        if self._estimator_kind == "epsilon":
            return fields.component_norm(eps)
        return None

    def _krylov(self, eps, mu_x, lam_x, zero):
        """-Gamma (C - C0) eps with zero mean (krylovOperator,
        fibergen.cpp:20583-20587).  Elasticity: K1 init mode, G0, K2 no-dot
        mode; heat/porous: the plain stress difference and the scalar
        Gamma; viscosity: the Delta operator (its dot is not read)."""
        grid, mu0, lam0 = self.grid, self.mu_0, self.lambda_0
        if self.mode == "viscosity":
            return gammamod.fused_visc(grid, eps, None, None, zero, mu_x,
                                       lam_x, mu0, lam0)[0]
        if self.dim == 3:
            return gammamod.gamma_heat_staggered(
                grid, zero, mu0, self.mat.stress_diff(eps, mu0, lam0))
        f, _ = stress_div_beta(grid, eps, None, None, mu_x, lam_x, mu0, lam0)
        u = green.g0_staggered_fused(grid, mu0, lam0, f)
        w, _ = eps_from_u_dot(grid, zero, u)
        return w

    def _cg_init(self, Ej, mu_x, lam_x, zero):
        """Initial CG state in the shifted form: the direction is built at
        the start of each step, p_k = r_k + (gamma_k/gamma_{k-1}) p_{k-1}
        (the reference's end-of-step update, fibergen.cpp:23227-23229, on
        the same trajectory).  p_prev = 0 and gamma_prev = gamma give
        p_0 = r_0."""
        eps = fields.const_field(self.grid, Ej, self.dtype, self.device)
        r = self._krylov(eps, mu_x, lam_x, zero)
        r += Ej.reshape(-1, 1, 1, 1) - eps
        gamma0 = fields.inner_l2(r, r) + self._tiny
        return eps, r, torch.zeros_like(r), gamma0, gamma0, self._metric(eps)

    def _cg_step(self, eps, r, p_prev, gamma, gamma_prev, mu_x, lam_x, zero):
        """One CG step; eps and r are updated in place."""
        grid, mu0, lam0 = self.grid, self.mu_0, self.lambda_0
        beta = (gamma, gamma_prev)
        if self.mode == "elasticity":
            f, p = stress_div_beta(grid, r, p_prev, beta, mu_x, lam_x, mu0,
                                   lam0)
            u = green.g0_staggered_fused(grid, mu0, lam0, f)
            del f
            w, dot_raw = eps_from_u_dot(grid, zero, u, p)
            del u
            denom = dot_raw / grid.nxyz
        elif self.mode == "viscosity":
            w, p, dot_raw = gammamod.fused_visc(grid, r, p_prev, beta, zero,
                                                mu_x, lam_x, mu0, lam0)
            denom = dot_raw / grid.nxyz
        else:
            p = r + (gamma / gamma_prev) * p_prev
            w = self._krylov(p, mu_x, lam_x, zero)
            denom = fields.inner_l2_diff(p, p, w)
        alpha = gamma / (denom + self._tiny)
        eps.addcmul_(p, alpha)                 # eps + alpha p
        met = self._metric(eps)
        r.addcmul_(w.sub_(p), alpha)           # r - alpha (p - w)
        delta = fields.inner_l2(r, r) + self._tiny
        return eps, r, p, delta, gamma, met

    def _run_cg(self, E):
        """Linear CG on (I + Gamma(C-C0)) eps = E (runCGElasticity,
        fibergen.cpp:23153-23247) in chunks of ``check_every`` iterations:
        the chunk's residual history reaches the host in one read, and each
        iteration's entry goes through the convergence test in order."""
        if self._refine_wanted():
            raise NotImplementedError(
                "mixed-precision refinement (float32 with tol < 3e-7) is not "
                "ported yet; use dtype='float64' or refine='off'")
        self._current_E = np.asarray(E, dtype=np.float64)
        ee = make_estimator(self.opt.error_estimator)
        mu_x, lam_x = self.mat.iso_moduli(self.dtype, self.device)
        Ej = torch.as_tensor(E, dtype=self.dtype, device=self.device)
        zero = torch.zeros(self.dim, dtype=self.dtype, device=self.device)
        K = max(1, int(self.opt.check_every))

        eps, r, p, gamma, gamma_prev, met0 = self._cg_init(Ej, mu_x, lam_x,
                                                           zero)
        self.eps = eps
        gamma0 = None
        it = 0
        done = False
        while not done:
            gs, ms = [], []
            for _ in range(K):
                gs.append(gamma)
                eps, r, p, gamma, gamma_prev, met = self._cg_step(
                    eps, r, p, gamma, gamma_prev, mu_x, lam_x, zero)
                ms.append(met)
            if gamma0 is None:
                ee.start(None if met0 is None else met0.cpu().numpy())
                gamma0 = float(gs[0])
            gs = torch.stack(gs).cpu().numpy()
            ms = None if ms[0] is None else torch.stack(ms).cpu().numpy()
            for k in range(K):
                if ee.metric_kind == "residual":
                    ee.update_cg(float(gs[k]), gamma0)
                else:
                    ee.update(None if ms is None else ms[k])
                it, done = self._converged(it, ee.abs_error(), ee.rel_error())
                if done:
                    break

    # --------------------------------------------------------- convergence
    def _converged(self, it, abs_err, rel_err, patience=50):
        """(converged, fibergen.cpp:21164-21244) with the stagnation guard
        of the JAX package.  Returns (next_it, done).  The boundary
        condition error is identically zero for pure strain control."""
        LOG.info(f"# Iteration {it}: {self.opt.error_estimator} error "
                 f"abs. = {abs_err:g} rel. = {rel_err:g}")
        if math.isnan(rel_err):
            self._canceled = True
            LOG.error("NaN detected in solution. Aborting.")
            return it, True
        self.residuals.append(rel_err)
        tol = self.opt.tol
        if rel_err < self._best_rel * (1.0 - self.opt.tol_red):
            self._best_rel = rel_err
            self._stall = 0
        else:
            self._stall += 1
            if self._stall >= patience:
                LOG.warn(
                    f"No progress for {self._stall} iterations at rel. "
                    f"error {rel_err:g} (tolerance {tol:g}): "
                    "stopping at the precision floor.")
                return it, True
        if it >= self.opt.maxiter:
            LOG.info("Maximum number of iterations reached.")
            return it, True
        if rel_err <= tol or abs_err <= self.opt.abs_tol:
            LOG.info("Boundary condition error = 0")
            LOG.info("Converged.")
            return it, True
        return it + 1, False
