"""Lippmann-Schwinger solver: linear CG, basic and polarization schemes,
and Newton-Krylov for finite strain.

Port of fibergen_tpu/solvers/ls.py (the reference's LSSolver,
fibergen.cpp:14643-24741) in five modes, on the staggered and the
collocated grid, with mixed boundary conditions (solvers/bc.py: the
strain-control projector P and the prescribed mean stress S), the
loadstep loop with solution extrapolation, and the batched multi-RHS CG
(``run_batched``) behind the effective-property load cases.
On a card each step runs hand-written kernels, on the CPU their plain
twins.  Staggered grid:

* elasticity, a material on the isotropic route (Voigt or Reuss mixing of
  isotropic linear phases, ``MixedMaterial.iso_route``): K1
  (ops/stencil_kernels.py), the K3 G0 chain (ops/spectral_kernels.py, with
  its own transforms), K2; any other linear material (general,
  transversely isotropic, the other mixing rules): the plain stress
  difference and stencils around K3 (ops/gamma.py gamma_staggered);
* heat and porous flow: plain stencils around the scalar K4 chain
  (ops/gamma.py gamma_heat_staggered);
* viscosity (the Delta dual scheme): K1 tau-sum mode, K3 with the dual
  constants, K2 Delta mode (ops/gamma.py fused_visc) for isotropic
  phases with lambda = 0 on the isotropic route without mixed BCs; any
  other material, lambda phases and mixed BCs take the plain stress
  difference and stencils around K3 with the dual constants (ops/gamma.py
  delta_staggered).

``half_staggered`` and ``full_staggered`` take the staggered operators;
what sets them apart is their material, the doubly-fine-grid
``materials/dfg.DfgMaterial`` (``DfgMaterial(convert.material_from_numpy(
...))``), which the caller passes.

Collocated grid: the plain stress difference, then the K5 collocated Gamma
chain (elasticity, heat, porous flow) or the K6 zero-trace chain
(viscosity).  ``method="polarization"`` (Eyre-Milton) runs on the
collocated grid.  Hyperelasticity (``method="cg"``) is Newton-Krylov
(solvers/newton.py) inside the loadstep loop with its divergence split;
its Gamma is K3 with the full-gradient constants (staggered) or K5 at
C = 9 (collocated).

CG: the scalars gamma, gamma_prev and beta stay on the device; the host
reads the residual history once per ``check_every`` iterations.  The basic
and polarization schemes read their metric once per iteration.  Under a
projector that is not the identity every Gamma application corrects its
mean on the device (ops/gamma.py; on the staggered elasticity path K2
takes the corrected mean as its E, and staggered viscosity takes the
generic Delta path); sharded solves refuse it.

Sharded (``LSSolver(..., sharding=parallel.field_sharding(mesh))``, the
x-slab solve of the JAX package's ``sharding=NamedSharding(mesh,
P(None, "x", None, None))``): one process drives the slabs of a mesh of
devices (``parallel/``).  The fields are lists of x-slabs, the scalars
lists with the value on every slab's device; CG and basic run in
elasticity, heat and porous flow on both grids and in viscosity on the
collocated grid: K1 and K2 in halo mode around the kz-slab K3 chain
(staggered elasticity), the plain halo stencils around the kz-slab K4
chain (staggered heat), the per-slab stress difference and the kz-slab
K5 or K6 chain (collocated).  Polarization runs on slabs in elasticity,
heat and porous flow (kz-slab K5), Newton-Krylov in hyperelasticity on
both grids (the per-slab full-gradient halo stencils around the kz-slab
K3 chain; the kz-slab K5 at C = 9).  Reductions add per-slab partials in
slab order.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from ..core import fields, voigt
from ..core.device import resolve_device, resolve_dtype
from ..materials import laws
from ..ops import gamma as gammamod
from ..ops import green
from ..ops.stencil_kernels import (eps_from_u_dot, eps_from_u_dot_slabs,
                                   stress_div_beta, stress_div_beta_slabs)
from ..parallel import comm, slabs
from ..parallel.fft import slab_fft_for, slab_reject_reason
from ..utils.logging import LOG
from . import bc as bcmod
from . import newton
from .estimators import make_estimator

MODE_DIM = {"elasticity": 6, "heat": 3, "porous": 3, "viscosity": 6,
            "hyperelasticity": 9}


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
        """'auto' resolution (fibergen.cpp:15068-15079): collocated for the
        polarization method, which also forces it over a staggered
        scheme."""
        s = self.gamma_scheme.replace("-", "_")
        if s == "auto":
            s = "collocated" if self.method == "polarization" else "staggered"
        if self.method == "polarization" and "staggered" in s:
            LOG.warn("switching to collocated discretization for "
                     "polarization method")
            s = "collocated"
        return s


# options implemented for any value; the rest must keep their default or
# take one of the values listed (each listed value behaves like the port's
# one path: no drain, no low-memory step, no 2-D pipeline)
_FREE = {"tol", "tol_red", "abs_tol", "bc_tol", "maxiter", "update_ref",
         "ref_scale", "error_estimator", "check_every", "dtype", "refine",
         "print_mean", "ref_mu", "ref_lambda", "newton_relax",
         "outer_error_estimator", "loadsteps", "first_loadstep",
         "max_loadstep_splits", "loadstep_extrapolation_order",
         "loadstep_extrapolation_method", "bc_relax"}
_ALSO = {"mode": ("heat", "porous", "viscosity", "hyperelasticity"),
         "method": ("basic", "polarization"),
         "gamma_scheme": ("staggered", "collocated", "half_staggered",
                          "full_staggered"),
         "newton_tangent": ("frozen_iso",),
         "adaptive_drain": ("off",),
         "low_mem": ("off",), "use_dim2": ("off",),
         "batch_load_cases": ("off",)}


# options whose value is a choice: a value off the list is an error, not
# an option still to be ported
_CHOICES = {"refine": ("auto", "on", "off"),
            "batch_load_cases": ("auto", "off")}


def _check_options(opt: SolverOptions):
    for name, allowed in _CHOICES.items():
        v = getattr(opt, name)
        if v not in allowed:
            raise ValueError(f"Unknown {name} '{v}' (expected "
                             f"{', '.join(allowed[:-1])} or {allowed[-1]})")
    hyper = opt.mode == "hyperelasticity"
    for f in dataclasses.fields(opt):
        if f.name in _FREE:
            continue
        v = getattr(opt, f.name)
        if v != f.default and v not in _ALSO.get(f.name, ()):
            raise NotImplementedError(
                f"SolverOptions.{f.name}={v!r} is not ported yet (the port "
                f"implements CG, basic and polarization on the staggered "
                f"and collocated grids in elasticity, heat, porous flow and "
                f"viscosity, and Newton-Krylov in hyperelasticity)")
    if hyper and opt.method != "cg":
        raise NotImplementedError(
            f"method {opt.method!r} in hyperelasticity is not ported yet "
            f"(Newton-Krylov, method='cg', is)")
    if not hyper and opt.error_estimator in ("sigma", "energy"):
        raise NotImplementedError(
            f"error estimator {opt.error_estimator!r} is ported for "
            f"hyperelasticity only")
    make_estimator(opt.error_estimator)
    make_estimator(opt.outer_error_estimator)


def _agrees(device, mesh_devices):
    """Whether a solver's ``device`` names the mesh's devices (its type,
    and its index where it gives one)."""
    d = torch.device(device)
    return all(m.type == d.type and d.index in (None, m.index)
               for m in mesh_devices)


class LSSolver:
    """FFT-homogenization solver on a periodic voxel grid.

    ``device`` defaults to ``cuda`` and raises without a card; pass
    ``device="cpu"`` for the plain PyTorch path.  ``sharding`` (a
    ``parallel.NamedSharding``, e.g. ``parallel.field_sharding(mesh)``)
    splits the fields into x-slabs over its mesh, whose devices the solve
    then runs on; a ``device`` that disagrees with them raises.

    The phases' fields may be set after construction (the front end builds
    the solver before it voxelizes); a solve refuses phases without one.
    ``convergence_callback`` (no arguments) is called at every convergence
    test, on the host values of the chunk already read, and ends the solve
    when it returns true; ``loadstep_callback`` is called after each
    loadstep and ends the run, which then returns True, when it returns
    true; :meth:`cancel` ends the running solve at its next convergence
    test, and the run returns True."""

    def __init__(self, grid, material, options: SolverOptions = None,
                 device=None, sharding=None):
        self.sharding = sharding
        if sharding is not None:
            mesh_devices = sharding.mesh.devices
            if device is not None and not _agrees(device, mesh_devices):
                raise ValueError(
                    f"device {device} disagrees with the sharding's mesh "
                    f"{[str(d) for d in mesh_devices]}; the mesh names the "
                    f"devices of a sharded solve")
            device = mesh_devices[0]
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
        # half/full staggered take the staggered operators: they differ
        # from staggered in their material only (a DfgMaterial,
        # materials/dfg.py)
        self.scheme = self.opt.resolved_scheme()
        # fixed again where a solve starts, the phases' fields set by then
        self._k1_route = None
        if all(p.phi is not None for p in material.phases):
            self._settle_route()    # a rule its laws cannot take raises
        if self.mode == "viscosity" and self.opt.method == "polarization":
            raise NotImplementedError(
                "the polarization method in viscosity is not ported yet")
        self.dtype = resolve_dtype(self.opt.dtype)
        self._tiny = float(np.finfo(np.float64 if self.dtype == torch.float64
                                    else np.float32).tiny)
        self._id = voigt.identity_vec(self.dim)
        # prescribed boundary conditions (Voigt vectors of the mode's dim)
        self.E = np.zeros(self.dim)
        self.S = np.zeros(self.dim)
        self.P = voigt.id4(self.dim)
        self._bc: Optional[bcmod.BCProjector] = None
        self._current_E = self.E
        self._current_S = self.S
        self.mu_0 = (self.opt.ref_mu if self.opt.ref_mu is not None
                     else float("nan"))
        self.lambda_0 = (self.opt.ref_lambda if self.opt.ref_lambda is not None
                         else 0.0)
        self.eps: Optional[torch.Tensor] = None
        self.residuals: List[float] = []
        self.solve_time = 0.0
        self.convergence_callback: Optional[Callable[[], bool]] = None
        self.loadstep_callback: Optional[Callable[[], bool]] = None
        self._canceled = False
        self._diverged = False
        self.newton_iterations = [0, 0]     # outer, inner (hyperelasticity)
        self._eig_memo = None
        self._estimator_kind = make_estimator(
            self.opt.error_estimator).metric_kind
        self.par = self._slab_layout(sharding)
        self._mod_halo = None

    def _settle_route(self):
        """Refuse phases without phi; then fix ``_k1_route``, whether the
        step fuses into K1 and K2, which read the isotropic moduli planes:
        staggered elasticity on the isotropic route, and staggered
        viscosity there when every phase has lambda = 0 (K1's tau sum and
        K2's Delta term are the scalar law's), as in the JAX package's
        fused viscosity sweep (ls.py:384-412); mixed BCs move viscosity off
        it (_gamma).  The rest of staggered viscosity, and half/full
        staggered whatever the material, take the generic Delta path
        (gammamod.delta_staggered)."""
        if any(p.phi is None for p in self.mat.phases) \
                and not getattr(self.mat, "_phi_dropped", False):
            raise SolverError(
                "a phase has no volume-fraction field phi: set the phases' "
                "fields (FG.init_phase) before solving")
        self._k1_route = self.scheme == "staggered" \
            and self.mat.iso_route() and (
                self.mode == "elasticity"
                or (self.mode == "viscosity"
                    and all(float(p.law.iso_moduli()[1]) == 0.0
                            for p in self.mat.phases)))

    def cancel(self):
        """End the running solve at its next convergence test; the run
        returns True."""
        self._canceled = True

    def _slab_layout(self, sharding):
        """The x-slab layout of a sharded solve (parallel.fft.SlabPar), None
        unsharded or on a replicated sharding.  Refuses, as the JAX package
        does (ls.py:303-322), a sharding that cannot take the slab path, and
        the paths not ported to slabs."""
        if sharding is None:
            return None
        par = slab_fft_for(sharding, self.grid)
        if par is None:
            if sharding.is_fully_replicated:
                return None
            raise SolverError(
                f"sharded solve cannot use the slab FFT: "
                f"{slab_reject_reason(sharding, self.grid)}. Use a grid "
                f"whose nx and ny divide the mesh (the port has no "
                f"replicated fallback: sharding_fallback='warn' is not "
                f"ported).")
        if self.mode == "viscosity" and self.scheme != "collocated":
            raise NotImplementedError(
                "staggered viscosity (the JAX package's generic Delta path "
                "on slabs) on a sharded mesh is not ported yet; the sharded "
                "solve runs CG, basic and polarization in elasticity, heat "
                "and porous flow on both grids, in viscosity on the "
                "collocated grid, and Newton-Krylov in hyperelasticity")
        if self.mat.rule != "voigt" or (self.dim != 9
                                        and not self.mat.iso_route()):
            raise NotImplementedError(
                f"a sharded solve of a material off the isotropic Voigt "
                f"route ({self.mat}: phases without isotropic moduli, or "
                f"another mixing rule) is not ported yet (ROADMAP.md, Queue "
                f"1 item 8)")
        return par

    # ------------------------------------------------------------------ API
    def set_strain(self, e):
        """Prescribe the mean strain (setStrain, fibergen.cpp:20692)."""
        self.E = self._fit_vec(e)

    def set_stress(self, s):
        """Prescribe the mean stress (setStress, fibergen.cpp:20668)."""
        self.S = self._fit_vec(s)

    def set_bc_projector(self, P):
        """Prescribe the strain-control projector (setBCProjector); its
        matrices are built once mu_0 is known."""
        self.P = np.asarray(P, dtype=np.float64)
        if np.isfinite(self.mu_0):
            self._make_bc()

    def _make_bc(self):
        self._bc = bcmod.make_bc_projector(self.P, self.mu_0, self.lambda_0,
                                           self.opt.bc_relax)

    def _fit_vec(self, e):
        """A Voigt vector of the mode's dim: cut or padded with zeros; six
        values in dim 9 mirror their shear entries."""
        e = np.asarray(e, dtype=np.float64).reshape(-1)
        out = np.zeros(self.dim)
        if e.size == 6 and self.dim == 9:
            out[:6] = e
            out[6:9] = e[3:6]
        else:
            n = min(e.size, self.dim)
            out[:n] = e[:n]
        return out

    def get_field(self, name: str) -> np.ndarray:
        """Solution field as a host numpy array with leading component axis
        (GetField, fibergen.cpp:27179); a sharded solve's slabs gathered."""
        if name == "epsilon":
            return slabs.whole(self.eps, "cpu").numpy()
        raise NotImplementedError(f"field '{name}' is not ported yet")

    def calc_mean_strain(self):
        return slabs.local(fields.mean(self.eps)).cpu().numpy()

    def calc_mean_stress(self):
        """Mean stress; the mean first Piola-Kirchhoff stress in
        hyperelasticity."""
        return slabs.local(self.mat.mean_pk1(self.eps)).cpu().numpy()

    def calc_mean_cauchy(self):
        return slabs.local(self.mat.mean_cauchy(self.eps)).cpu().numpy()

    def calc_mean_energy(self):
        return float(slabs.local(self.mat.mean_w(self.eps)))

    def calc_min_det_f(self):
        """min det F over the voxels (over the slabs of a sharded solve)."""
        return float(slabs.fold(torch.minimum, slabs.smap(
            lambda F: laws.det3_comp(F).min(), self.eps)))

    # --------------------------------------------------------- ref material
    def calc_ref_material(self):
        """(mu_0, lambda_0) from the per-voxel tangent eigenvalue bounds
        (calcRefMaterial, fibergen.cpp:22283-22313): mu_0 = 0.5 ref_scale
        0.5 (lmin + lmax), or 0.5 ref_scale sqrt(lmin lmax) for the
        polarization method; lambda_0 = 0.  Linear materials: memoized on
        the identity of the tensors the material reads (``state()``: phi,
        orientation fields, the mixed moduli).  Hyperelasticity: the bounds
        of the tangent at the current ``eps``, recomputed at every call
        (Newton calls it at the shifted F)."""
        if self.mode == "hyperelasticity":
            lmin, lmax = (float(x) for x in self.mat.eig_range(self.eps))
        else:
            key = self.mat.state()
            if self._eig_memo is None or len(self._eig_memo[0]) != len(key) \
                    or not all(a is b for a, b in zip(self._eig_memo[0], key)):
                self._eig_memo = (key, tuple(
                    float(x) for x in self.mat.eig_range(
                        zero_trace=self.mode == "viscosity",
                        devices=None if self.par is None
                        else self.par.devices)))
            lmin, lmax = self._eig_memo[1]
        if lmin < 0:
            LOG.warn(f"negative tangent eigenvalue ({lmin}); cutting off at 0")
            lmin = 0.0
        if self.opt.method == "polarization":
            mu = math.sqrt(lmin * lmax)
        else:
            mu = 0.5 * (lmin + lmax)
        self.mu_0 = 0.5 * self.opt.ref_scale * mu
        self.lambda_0 = 0.0
        LOG.info(f"adjusting mu_ref={self.mu_0:g}, lambda_ref={self.lambda_0:g}")
        self._make_bc()

    def _maybe_update_ref(self):
        if self.opt.update_ref != "never" or not np.isfinite(self.mu_0):
            self.calc_ref_material()
        elif self._bc is None:
            self._make_bc()

    def _bca(self):
        """The projector when it corrects the mean (None for P == Id)."""
        return None if self._bc is None or self._bc.is_trivial else self._bc

    def _bc_mean(self, E, S):
        return np.asarray(bcmod.calc_bc_mean(self._bc, E, S), dtype=np.float64)

    # -------------------------------------------------------------- run
    def run(self) -> bool:
        """Full solve over all loadsteps (run, fibergen.cpp:21247-21398).
        Returns True on failure or cancel, False on success, like the
        reference."""
        self._settle_route()
        self.residuals = []
        self._canceled = False
        self._diverged = False
        self.newton_iterations = [0, 0]
        g = self.grid
        LOG.info(f"RVE: dims={g.dx}x{g.dy}x{g.dz} voxels={g.nx}x{g.ny}x{g.nz}")
        LOG.info(f"mode: {self.opt.method} {self.scheme} {self.mode} "
                 f"{self.opt.cg_inner_product}")
        LOG.info(f"tolerances: relative={self.opt.tol} "
                 f"absolute={self.opt.abs_tol}")
        for p in self.mat.phases:
            LOG.info(f" - {p.name}: {p.law}")

        # BC compatibility checks (fibergen.cpp:21352-21364)
        Q = voigt.id4(self.dim) - self.P
        eps_m = math.sqrt(np.finfo(np.float64).eps)
        nS, nE = voigt.norm_2(self.S), voigt.norm_2(self.E)
        if nS > 0 and voigt.norm_2(voigt.dyad4_mv(self.P, self.S)) > eps_m * nS:
            raise SolverError("Incompatible stress boundary condition specified")
        if nE > 0 and voigt.norm_2(voigt.dyad4_mv(Q, self.E)) > eps_m * nE:
            raise SolverError("Incompatible strain boundary condition specified")
        if np.any(Q) or nS > 0:
            self._refuse_mixed()

        # initial field (fibergen.cpp:21368-21380)
        self.eps = self._seed()
        if np.isfinite(self.mu_0) and self._bc is None:
            self._make_bc()
        t0 = time.perf_counter()
        self._reset_stall()
        failed = self._run_loadstepping(self.E, self.S)
        self._sync()
        self.solve_time = time.perf_counter() - t0
        return failed

    def _refuse_mixed(self):
        """The mixed-BC paths the port does not run yet."""
        if self.par is not None:
            raise NotImplementedError(
                "mixed boundary conditions (a projector other than the "
                "identity, or a prescribed stress) on a sharded mesh are not "
                "ported yet")

    def _seed(self):
        """The initial field: Id in hyperelasticity, zero otherwise."""
        return self._const(self._id if self.mode == "hyperelasticity"
                           else np.zeros(self.dim))

    def _sync(self):
        devices = [self.device] if self.par is None else self.par.devices
        for d in dict.fromkeys(devices):
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def _reset_stall(self):
        """Reset the stagnation tracker: per solve phase (each loadstep and
        each Newton inner solve), since relative errors restart near 1
        there."""
        self._best_rel = float("inf")
        self._stall = 0

    def _loadstep_params(self):
        n = max(1, int(self.opt.loadsteps))
        params = [i / n for i in range(n + 1)]
        first = self.opt.first_loadstep
        if first < 0:
            first = 0 if len(params) > 2 else 1
        return params, first

    def _run_loadstepping(self, Emax, Smax) -> bool:
        """Loadstep loop with solution extrapolation (runLoadsteppingSolver,
        fibergen.cpp:21584-21685) and the JAX package's divergence
        recovery: on NaN or an indefinite operator the state at the last
        converged loadstep is restored and the midpoint loadstep parameter
        inserted, up to ``max_loadstep_splits`` times.  E(t) = t Emax (+ (1
        - t) P:Id in hyperelasticity), S(t) = t Smax.  Returns True when it
        gives up."""
        params, first = self._loadstep_params()
        history = []                    # (t, eps) for the extrapolation
        order = self.opt.loadstep_extrapolation_order
        splits = 0
        istep = first
        while istep < len(params):
            t = params[istep]
            E = t * np.asarray(Emax)
            S = t * np.asarray(Smax)
            if self.mode == "hyperelasticity":
                E = E + (1 - t) * voigt.dyad4_mv(self.P, self._id)
            if len(params) > 2:
                LOG.info(f"*** loadstep {istep}/{len(params) - 1} parameter "
                         f"{t} ***")
            # at the first loadstep eps is the constant seed: keep the
            # recipe (None), not a second field
            eps_entry = None if istep == first else self.eps
            history_entry = list(history)
            if order > 0 and istep > first:
                history.append((params[istep - 1], self.eps))
                history = history[-(order + 1):]
                if len(history) >= 2:
                    self.eps = _extrapolate(
                        history, t, self.opt.loadstep_extrapolation_method,
                        self.dim)
            self._diverged = False
            self.run_solver(E, S)
            if self._diverged:
                if not (self.opt.max_loadstep_splits > 0
                        and splits < self.opt.max_loadstep_splits
                        and istep >= 1):
                    LOG.error("loadsteps canceled")
                    return True
                mid = 0.5 * (params[istep] + params[istep - 1])
                LOG.warn(f"loadstep {t:g} diverged: restoring state at "
                         f"{params[istep - 1]:g} and splitting at parameter "
                         f"{mid:g} (split {splits + 1}/"
                         f"{self.opt.max_loadstep_splits})")
                params.insert(istep, mid)
                splits += 1
                self.eps = self._seed() if eps_entry is None else eps_entry
                history = history_entry
                self._canceled = False
                self._diverged = False
                continue
            if self._canceled:
                LOG.error("loadsteps canceled")
                return True
            if self.loadstep_callback and self.loadstep_callback():
                LOG.info("Loadstep callback break request.")
                return True
            istep += 1
        return False

    def run_solver(self, E, S):
        """Method dispatch (runSolver, fibergen.cpp:21401-21433)."""
        self._reset_stall()
        self._current_E = np.asarray(E)
        self._current_S = np.asarray(S)
        if self.opt.method == "basic":
            self._run_basic(E, S)
        elif self.opt.method == "polarization":
            self._run_polarization(E, S)
        else:
            self._run_cg(E, S)
        if self.opt.print_mean:
            self._print_mean_values()

    def _print_mean_values(self):
        """Log the mean strain and stress under the mode's names
        (after each run_solver call, as the JAX package does)."""
        names = {
            "elasticity": ("elastic strain", "average elastic stress"),
            "hyperelasticity": ("deformation gradient",
                                "1st Piola-Kirchhoff stress"),
            "viscosity": ("fluid stress", "fluid shear"),
            "heat": ("temperature gradient", "heat flux"),
            "porous": ("pressure gradient", "volumetric flux"),
        }[self.mode]
        LOG.info(f"mean {names[0]} = {self.calc_mean_strain()}")
        LOG.info(f"mean {names[1]} = {self.calc_mean_stress()}")

    def _refuse_refinement(self):
        """Raise where the reference would engage mixed-precision
        refinement (fibergen_tpu solvers/ls.py _refine_ok on this path)."""
        o = self.opt
        want = o.refine == "on" or (o.refine == "auto" and o.tol < 3e-7)
        if want and self.dtype == torch.float32:
            raise NotImplementedError(
                "mixed-precision refinement (float32 with tol < 3e-7) is not "
                "ported yet; use dtype='float64' or refine='off'")

    # ------------------------------------------------------------ CG
    def _metric(self, eps):
        if self._estimator_kind == "epsilon":
            return fields.component_norm(eps)
        return None

    def _host_metric(self, eps):
        m = self._metric(eps)
        return None if m is None else slabs.local(m).cpu().numpy()

    # ------------------------------------------- values of a sharded solve
    def _vector(self, values):
        """A (n,) vector on the solve's device, or, sharded, on every slab's
        device."""
        v = torch.as_tensor(values, dtype=self.dtype, device=self.device)
        return v if self.par is None else comm.replicate(v, self.par.devices)

    def _const(self, values):
        """A constant field of ``values`` (a vector, or one replicated over
        the slabs): one tensor, or the x-slabs of a sharded solve."""
        if self.par is None:
            return fields.const_field(self.grid, values, self.dtype,
                                      self.device)
        nx = self.grid.nx // self.par.n_devices
        return [fields.const_field(self.grid, slabs.local(values), self.dtype,
                                   d, nx=nx) for d in self.par.devices]

    def _moduli(self):
        """(mu(x), lam(x)) for K1 and K2: tensors, or x-slabs whose halo
        planes (for K1) are exchanged here, once per solve; (None, None) on
        the paths that read the material through its stress difference."""
        if not self._k1_route:
            return None, None
        if self.par is None:
            return self.mat.iso_moduli(self.dtype, self.device)
        mu_x, lam_x = self.mat.iso_moduli_slabs(self.dtype, self.par.devices)
        if self.scheme != "collocated" and self.dim == 6:
            self._mod_halo = (comm.halo_x(mu_x), comm.halo_x(lam_x))
        return mu_x, lam_x

    def _gamma(self, eps, E, mu_x, lam_x, bc=None):
        """E - Gamma (C - C0) eps with mean E: the basic scheme's step
        (basic_step) and, with E = 0, the CG operator (krylovOperator,
        fibergen.cpp:20583-20587); ``bc`` corrects the mean.  Staggered
        elasticity: K1 init mode, G0, K2 no-dot mode; heat/porous: the
        plain stress difference and the scalar Gamma; viscosity: the fused
        Delta operator (its dot is not read) on the K1 route without
        ``bc``, else the plain stress difference and the generic Delta
        operator (div_staggered, K3 with the dual constants,
        eps_staggered); elasticity off the isotropic route: the plain
        stress difference, div_staggered, K3, eps_staggered.  Collocated:
        the plain stress difference, then K5 (K6 in viscosity)."""
        grid, mu0, lam0, par = self.grid, self.mu_0, self.lambda_0, self.par
        if self.scheme == "collocated":
            tau = self.mat.stress_diff(eps, mu0, lam0)
            if self.mode == "viscosity":
                return gammamod.delta_collocated(grid, E, mu0, tau, par=par,
                                                 bc=bc)
            return gammamod.gamma_collocated(grid, E, mu0, lam0, tau,
                                             par=par, bc=bc)
        if self.mode == "viscosity":
            if self._k1_route and bc is None:
                return gammamod.fused_visc(grid, eps, None, None, E, mu_x,
                                           lam_x, mu0, lam0)[0]
            return gammamod.delta_staggered(
                grid, E, mu0, self.mat.stress_diff(eps, mu0, lam0), bc=bc)
        if self.dim == 3:
            return gammamod.gamma_heat_staggered(
                grid, E, mu0, self.mat.stress_diff(eps, mu0, lam0), par=par,
                bc=bc)
        if not self._k1_route:
            return gammamod.gamma_staggered(
                grid, E, mu0, lam0, self.mat.stress_diff(eps, mu0, lam0),
                bc=bc)
        return self._k1_k3_k2(eps, None, None, E, mu_x, lam_x, bc)[0]

    def _k1_k3_k2(self, r, p_prev, beta, E, mu_x, lam_x, bc=None):
        """Staggered elasticity's fused operator: K1, the K3 chain, K2.  In
        step mode (``p_prev``, ``beta``) (w, p, dot_raw), in init mode (w,
        None, None).  Sharded, K1 and K2 run in halo mode around the
        kz-slab chain (the JAX package's ls.py:653-665) and the dot is a
        psum.  Under ``bc`` K2 takes E + alpha R as its mean, R from the
        mean of the stress difference K1 formed (one reduction over p and
        the moduli): the JAX package's generic path adds alpha R to
        eps_staggered(E, u), which is eps_staggered(E + alpha R, u)."""
        grid, mu0, lam0, par = self.grid, self.mu_0, self.lambda_0, self.par
        if par is None:
            f, p = stress_div_beta(grid, r, p_prev, beta, mu_x, lam_x, mu0,
                                   lam0)
        else:
            f, p = stress_div_beta_slabs(grid, r, p_prev, beta, mu_x, lam_x,
                                         mu0, lam0, self._mod_halo)
        if bc is not None:
            F0 = gammamod.stress_diff_mean(r if p is None else p, mu_x,
                                           lam_x, mu0, lam0)
            E = E - bcmod.bc_correction(bc, F0)
        u = green.g0_staggered_fused(grid, mu0, lam0, f, par=par)
        del f
        k2 = eps_from_u_dot if par is None else eps_from_u_dot_slabs
        w, dot_raw = k2(grid, E, u, p)
        return w, p, dot_raw

    def _cg_init(self, Ej, mu_x, lam_x, zero, bc=None):
        """Initial CG state in the shifted form: the direction is built at
        the start of each step, p_k = r_k + (gamma_k/gamma_{k-1}) p_{k-1}
        (the reference's end-of-step update, fibergen.cpp:23227-23229, on
        the same trajectory).  p_prev = 0 and gamma_prev = gamma give
        p_0 = r_0.  Sharded, the fields are x-slabs and the scalars
        replicated over them."""
        eps = self._const(Ej)
        r = self._gamma(eps, zero, mu_x, lam_x, bc)
        slabs.smap(lambda r, e, x: r.add_(e.reshape(-1, 1, 1, 1) - x), r, Ej,
                   eps)
        gamma0 = slabs.smap(lambda g: g + self._tiny, fields.inner_l2(r, r))
        return (eps, r, slabs.smap(torch.zeros_like, r), gamma0, gamma0,
                self._metric(eps))

    def _cg_step(self, eps, r, p_prev, gamma, gamma_prev, mu_x, lam_x, zero,
                 bc=None):
        """One CG step; eps and r are updated in place.  The staggered
        elasticity and viscosity steps on the K1 route (viscosity without
        ``bc``) fuse the direction update into K1; the others form p, apply
        the operator and take the denominator <p, p - w> in PyTorch (the
        JAX package's generic step).  Sharded, each slab takes the same step
        (``slabs.smap``)."""
        grid, tiny = self.grid, self._tiny
        beta = slabs.smap(lambda g, gp: (g, gp), gamma, gamma_prev)
        fused = self._k1_route
        if fused and self.mode == "elasticity":
            w, p, dot_raw = self._k1_k3_k2(r, p_prev, beta, zero, mu_x, lam_x,
                                           bc)
            denom = slabs.smap(lambda d: d / grid.nxyz, dot_raw)
        elif fused and self.mode == "viscosity" and bc is None:
            w, p, dot_raw = gammamod.fused_visc(grid, r, p_prev, beta, zero,
                                                mu_x, lam_x, self.mu_0,
                                                self.lambda_0)
            denom = dot_raw / grid.nxyz
        else:
            p = slabs.smap(lambda r, pp, g, gp: r + (g / gp) * pp, r, p_prev,
                           gamma, gamma_prev)
            w = self._gamma(p, zero, mu_x, lam_x, bc)
            denom = fields.inner_l2_diff(p, p, w)
        alpha = slabs.smap(lambda g, d: g / (d + tiny), gamma, denom)
        slabs.smap(torch.Tensor.addcmul_, eps, p, alpha)   # eps + alpha p
        met = self._metric(eps)
        slabs.smap(lambda r, w, p, a: r.addcmul_(w.sub_(p), a), r, w, p,
                   alpha)                              # r - alpha (p - w)
        delta = slabs.smap(lambda d: d + tiny, fields.inner_l2(r, r))
        return eps, r, p, delta, gamma, met

    def _run_cg(self, E0, S0):
        """Linear CG on (I + Gamma(C-C0)) eps = E (runCGElasticity,
        fibergen.cpp:23153-23247) from eps = E, the mixed-BC mean of (E0,
        S0), in chunks of ``check_every`` iterations: the chunk's residual
        history reaches the host in one read, and each iteration's entry
        goes through the convergence test in order.  Hyperelasticity:
        Newton-Krylov (solvers/newton.py)."""
        if self.mode == "hyperelasticity":
            return newton.run_newton_cg(self, E0, S0)
        self._refuse_refinement()
        self.eps = None                 # the CG builds its own from E
        self._maybe_update_ref()
        E = self._bc_mean(E0, S0)
        bc = self._bca()
        ee = make_estimator(self.opt.error_estimator)
        mu_x, lam_x = self._moduli()
        Ej = self._vector(E)
        zero = self._vector(np.zeros(self.dim))
        K = max(1, int(self.opt.check_every))

        eps, r, p, gamma, gamma_prev, met0 = self._cg_init(Ej, mu_x, lam_x,
                                                           zero, bc)
        self.eps = eps
        gamma0 = None
        it = 0
        done = False
        while not done:
            gs, ms = [], []
            for _ in range(K):
                gs.append(slabs.local(gamma))
                eps, r, p, gamma, gamma_prev, met = self._cg_step(
                    eps, r, p, gamma, gamma_prev, mu_x, lam_x, zero, bc)
                ms.append(None if met is None else slabs.local(met))
            if gamma0 is None:
                ee.start(None if met0 is None else
                         slabs.local(met0).cpu().numpy())
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

    # ------------------------------------------------------ batched CG
    def run_batched(self, Es, pallas_mid="auto") -> bool:
        """B pure-strain load cases (the rows of ``Es``) against the one
        operator, advanced in lockstep by the linear CG (the JAX package's
        run_batched, ls.py:2008-2136): each right-hand side has its own
        (eps, r, p, gamma, gamma_prev) and takes the single solve's step,
        so the kernels launch once per right-hand side and step.  Each
        chunk of ``check_every`` steps reads the (K, B) gamma and metric
        history to the host once; one estimator runs per right-hand side,
        and the batch stops at the chunk in which the worst of them
        converges.  The boundary conditions are pure strain whatever P and
        S say, as in the JAX package.

        On success ``eps_batch`` holds (B, dim, nx, ny, nz) and ``eps`` the
        last case (``eps_batch[-1]``); calc_mean_stress_batched() gives the
        (B, dim) mean stresses.  Returns True on failure, False on success
        (run() semantics).  ``pallas_mid`` (the JAX package's choice of its
        batched chain) is accepted and has no effect: the port launches
        its chain once per right-hand side."""
        if self.opt.method != "cg" or self.mode == "hyperelasticity":
            raise SolverError("run_batched requires the linear CG")
        if self.sharding is not None and self.par is None:
            raise SolverError(
                "run_batched on a mesh requires the slab-FFT layout "
                "(x-slab NamedSharding with mesh-divisible nx, ny)")
        if self.par is not None:
            raise NotImplementedError(
                "run_batched on a sharded mesh is not ported yet")
        self._settle_route()
        self._refuse_refinement()
        t0 = time.perf_counter()
        Es = np.asarray(Es, dtype=np.float64)
        B = Es.shape[0]
        self.residuals = []
        self._canceled = False
        self._diverged = False
        self._reset_stall()
        self._current_E = Es[-1]
        self._current_S = np.zeros(self.dim)
        self.eps = None
        self._maybe_update_ref()
        mu_x, lam_x = self._moduli()
        zero = self._vector(np.zeros(self.dim))
        K = max(1, int(self.opt.check_every))
        ests = [make_estimator(self.opt.error_estimator) for _ in range(B)]

        eps_b = torch.empty((B, self.dim) + self.grid.shape, dtype=self.dtype,
                            device=self.device)
        states, g0, m0 = [], [], []
        for b in range(B):
            eps, r, p, gamma, gamma_prev, met0 = self._cg_init(
                self._vector(Es[b]), mu_x, lam_x, zero)
            eps_b[b].copy_(eps)
            del eps
            states.append([eps_b[b], r, p, gamma, gamma_prev])
            g0.append(gamma)
            m0.append(met0)
        self.eps = eps_b[-1]
        g0 = torch.stack(g0).cpu().numpy().astype(np.float64)
        for b, e in enumerate(ests):
            e.start(None if m0[b] is None else m0[b].cpu().numpy())
        del m0
        it, done = 0, False
        while not done:
            gs, ms = [], []
            for _ in range(K):
                gs.append(torch.stack([st[3] for st in states]))
                mk = []
                for st in states:
                    out = self._cg_step(*st, mu_x, lam_x, zero)
                    st[:] = out[:5]             # eps, r, p, gamma, gamma_prev
                    mk.append(out[5])
                ms.append(None if mk[0] is None else torch.stack(mk))
            gs = torch.stack(gs).cpu().numpy().astype(np.float64)  # (K, B)
            ms = None if ms[0] is None else torch.stack(ms).cpu().numpy()
            for k in range(K):
                for b, e in enumerate(ests):
                    if e.metric_kind == "residual":
                        e.update_cg(gs[k, b], g0[b])
                    else:
                        e.update(None if ms is None else ms[k, b])
                it, done = self._converged(
                    it, max(e.abs_error() for e in ests),
                    max(e.rel_error() for e in ests))
                if done:
                    break
        del states
        self.eps_batch = eps_b
        self.eps = eps_b[-1]
        self._sync()
        self.solve_time = time.perf_counter() - t0
        return bool(self._canceled or self._diverged)

    def calc_mean_stress_batched(self):
        """(B, dim) mean stresses of the last run_batched."""
        return torch.stack([self.mat.mean_pk1(e) for e in self.eps_batch]
                           ).cpu().numpy()

    # ------------------------------------------------- basic, polarization
    def _run_basic(self, E0, S0):
        """Fixed-point scheme eps <- E - Gamma (C - C0) eps from the current
        eps (runBasic, fibergen.cpp:21716-21805), E the mixed-BC mean of
        (E0, S0)."""
        self._maybe_update_ref()
        E = self._bc_mean(E0, S0)
        bc = self._bca()
        ee = make_estimator(self.opt.error_estimator)
        mu_x, lam_x = self._moduli()
        Ej = self._vector(E)
        ee.start(self._host_metric(self.eps))
        it, done = 1, False
        while not done:
            self.eps = self._gamma(self.eps, Ej, mu_x, lam_x, bc)
            ee.update(self._host_metric(self.eps))
            it, done = self._converged(it, ee.abs_error(), ee.rel_error())

    def _run_polarization(self, E0, S0):
        """Eyre-Milton scheme on the collocated grid (runPolarization,
        fibergen.cpp:21808-21851, polarizationScheme :20536-20554): from
        eps = 4 mu_0 E (E the mixed-BC mean of (E0, S0)), tau = P(eps),
        eps <- -4 mu_0 Gamma tau + tau with mean <tau> + 4 mu_0 E (a device
        vector, corrected under a projector); at the end eps <- (C +
        C0)^{-1} eps."""
        self._maybe_update_ref()
        E = self._bc_mean(E0, S0)
        bc = self._bca()
        ee = make_estimator(self.opt.error_estimator)
        mu0, lam0 = self.mu_0, self.lambda_0
        P0 = self._vector(4.0 * mu0 * E)
        self.eps = self._const(P0)
        ee.start(self._host_metric(self.eps))
        it, done = 1, False
        while not done:
            tau = self.mat.polarization(mu0, self.eps)
            self.eps = gammamod.gamma_collocated(
                self.grid, slabs.smap(torch.add, fields.mean(tau), P0), mu0,
                lam0, tau, alpha=-4.0 * mu0, beta=1.0, par=self.par, bc=bc)
            del tau
            ee.update(self._host_metric(self.eps))
            # the boundary condition is not tested here, as in the JAX
            # package (solvers/ls.py _run_polarization)
            it, done = self._converged(it, ee.abs_error(), ee.rel_error(),
                                       check_bc=False)
        self.eps = self.mat.polarization(mu0, self.eps, inv=True)

    # --------------------------------------------------------- convergence
    def _converged(self, it, abs_err, rel_err, check_bc=True, patience=50):
        """(converged, fibergen.cpp:21164-21244) with the stagnation guard
        of the JAX package.  Returns (next_it, done).  Below tolerance the
        solve ends once the boundary condition error is at most
        ``bc_tol``; ``check_bc=False`` (the Newton inner CG, polarization)
        does not test it.  NaN cancels the solve and marks it diverged,
        which the loadstep loop answers with a split."""
        LOG.info(f"# Iteration {it}: {self.opt.error_estimator} error "
                 f"abs. = {abs_err:g} rel. = {rel_err:g}")
        if math.isnan(rel_err):
            self._canceled = True
            self._diverged = True
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
        if self.convergence_callback and self.convergence_callback():
            LOG.info("Custom convergence test returned true.")
            return it, True
        if self._canceled:
            LOG.info("Solve canceled.")
            return it, True
        if it >= self.opt.maxiter:
            LOG.info("Maximum number of iterations reached.")
            return it, True
        if rel_err <= tol or abs_err <= self.opt.abs_tol:
            bc_err = 0.0
            if check_bc:
                bc_err = self.bc_error()
                LOG.info(f"Boundary condition error = {bc_err:g}")
            if bc_err <= self.opt.bc_tol:
                LOG.info("Converged.")
                return it, True
        return it + 1, False

    def bc_error(self) -> float:
        """Relative mixed-BC error of the current field (bc_error,
        fibergen.cpp:21129-21161).  Zero without reading the field under
        pure strain control (P == Id, S == 0), where every scheme keeps
        mean(eps) == E exactly, as the JAX package does."""
        if ((self._bc is None or self._bc.is_trivial)
                and voigt.norm_2(self._current_S) == 0.0):
            return 0.0
        Emean = self.calc_mean_strain().astype(np.float64)
        Smean = self.calc_mean_stress().astype(np.float64)
        Q = voigt.id4(self.dim) - self.P
        P_E = voigt.dyad4_mv(self.P, Emean)
        Q_S = voigt.dyad4_mv(Q, Smean)
        PE_target = voigt.dyad4_mv(self.P, self._current_E)
        if self.dim == 9:
            PE_target = PE_target - voigt.dyad4_mv(self.P, self._id)
        norm_E = voigt.norm_2(PE_target)
        norm_S = voigt.norm_2(self._current_S)
        err_F = voigt.norm_2(P_E - self._current_E) / (
            1.0 if norm_E < self.opt.bc_tol else norm_E)
        err_S = voigt.norm_2(Q_S - self._current_S) / (
            1.0 if norm_S < self.opt.bc_tol else norm_S)
        return float(max(err_F, err_S))


# ------------------------------------------------------ extrapolation
def _extrapolate(history, t, method="polynomial", dim=6):
    """Loadstep solution extrapolation (extrapolateLoadstep,
    fibergen.cpp:21454-21466) from the (t, eps) ``history``; a sharded
    history is extrapolated slab by slab.  Unknown methods raise, as the
    reference's BOOST_THROW."""
    ts = [h[0] for h in history]
    if method == "polynomial":
        def fn(*es):
            return _extrapolate_polynomial(list(zip(ts, es)), t)
    elif method == "transformation":
        def fn(*es):
            return _extrapolate_transformation(list(zip(ts, es)), dim)
    else:
        raise SolverError(
            f"Unknown loadstep extrapolation method '{method}'")
    return slabs.smap(fn, *[e for _, e in history])


def _extrapolate_polynomial(history, t):
    """The Lagrange polynomial through the history, at t
    (extrapolateLoadstepPolynomial, fibergen.cpp:21468-21517)."""
    ts = [h[0] for h in history]
    out = None
    for i, (_, e) in enumerate(history):
        w = 1.0
        for j in range(len(ts)):
            if i != j:
                w *= (t - ts[j]) / (ts[i] - ts[j])
        out = w * e if out is None else out + w * e
    return out


def _mat9(F):
    """(9, ...) -> (..., 3, 3) in the dim-9 component order."""
    rows = [[0, 5, 4], [8, 1, 3], [7, 6, 2]]
    return torch.stack([torch.stack([F[k] for k in r], dim=-1) for r in rows],
                       dim=-2)


def _voigt9(M):
    """(..., 3, 3) -> (9, ...)."""
    return torch.stack([M[..., i, j] for i, j in (
        (0, 0), (1, 1), (2, 2), (1, 2), (0, 2), (0, 1), (2, 1), (2, 0),
        (1, 0))])


def _extrapolate_transformation(history, dim):
    """SVD-transformation extrapolation (extrapolateLoadstepTransformation,
    fibergen.cpp:21519-21582): per voxel, the transfer tensor between the
    last two fields TR = F2 F1^{-1} raised through its SVD to the
    reference's fixed exponent log(3)/log(2) - 1, and F = TR^tt F2.  Meant
    for the deformation gradient; a field of dim < 9 is mirrored to nine
    components ([i] = [i - 3]) as in the reference."""
    (_, e1), (_, e2) = history[-2], history[-1]

    def to9(e):
        comps = [e[i] if i < dim else None for i in range(9)]
        for i in range(9):
            if comps[i] is None:
                comps[i] = comps[i - 3]
        return torch.stack(comps)

    F1, F2 = _mat9(to9(e1)), _mat9(to9(e2))
    TR = F2 @ torch.linalg.inv(F1)
    tt = math.log(3.0) / math.log(2.0) - 1.0
    U, s, Vh = torch.linalg.svd(TR)
    Fi = ((U * (s ** tt)[..., None, :]) @ Vh) @ F2
    return _voigt9(Fi)[:dim].contiguous()
