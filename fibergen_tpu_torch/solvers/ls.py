"""Lippmann-Schwinger solver: linear CG, the basic, Nesterov, basic+EL and
polarization schemes, and Newton-Krylov and nonlinear CG for finite
strain.

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
(viscosity); under ``freq_hack`` the collocated elasticity Gamma averages
over the Nyquist sign flips of even axes (``torch.fft``, no chain).
``gamma_scheme="willot"``: Willot's rotated Gamma in elasticity and the
viscosity Delta operator (``torch.fft``, no chain).
``method="polarization"`` (Eyre-Milton) runs on the collocated grid (or
Willot's).  The basic step (:meth:`LSSolver._gamma`) also carries
nesterov and basic+el, and CG's ``cg_reinit`` exact residual.
Hyperelasticity: ``method="cg"`` is Newton-Krylov and ``"nl_cg"``
nonlinear CG (solvers/newton.py), inside the loadstep loop with its
divergence split; basic, nesterov and basic+el take the nine-component
basic step.  Its Gamma is K3 with the full-gradient constants
(staggered) or K5 at C = 9 (collocated).

CG: the scalars gamma, gamma_prev and beta stay on the device; the host
reads the residual history once per ``check_every`` iterations.  A
float32 CG below tol 3e-7 (or with ``refine="on"``) ends with the
mixed-precision refinement sweeps (solvers/refine.py: float64 residuals on
the solver's device, float32 correction solves).  ``low_mem`` runs the
staggered elasticity and viscosity CG without the operator's output field
(solvers/lowmem.py: the lm6 tuple state, the stacked low-memory step).
``g0_solver="multigrid"`` applies the staggered elasticity G0 by multigrid
Poisson solves (solvers/multigrid.py, plain PyTorch, no kernel).  The basic
and polarization schemes read their metric once per iteration.  Under a
projector that is not the identity every Gamma application corrects its
mean on the device (ops/gamma.py; on the staggered elasticity path K2
takes the corrected mean as its E, and staggered viscosity takes the
generic Delta path).

Sharded (``LSSolver(..., sharding=parallel.field_sharding(mesh))``, the
x-slab solve of the JAX package's ``sharding=NamedSharding(mesh,
P(None, "x", None, None))``): one process drives the slabs of a mesh of
devices (``parallel/``).  The fields are lists of x-slabs, the scalars
lists with the value on every slab's device.  Every linear path of the
unsharded solver runs so, in every method, with mixed BCs and in
``run_batched``: K1 and K2 in halo mode around the kz-slab K3 chain
(staggered elasticity on the isotropic route; K1 tau-sum and K2 Delta
mode in staggered viscosity), the plain halo stencils around the kz-slab
K3 or K4 chain (any other staggered material, the generic Delta path,
heat), the per-slab stress difference and the kz-slab K5 or K6 chain
(collocated), the plain slab transforms around Willot's Gamma and the
``freq_hack`` apply; Newton-Krylov and nonlinear CG in hyperelasticity on
both grids (the per-slab full-gradient halo stencils around the kz-slab
K3 chain; the kz-slab K5 at C = 9).  The materials off the Voigt rule run
on per-slab views (materials/sharded.py), the doubly-fine grid on fine
x-slabs.  Reductions add per-slab partials in slab order, the mixed-BC
means among them, and ``g0_solver="multigrid"`` runs the slab multigrid
(solvers/multigrid.py).  Refinement and the low-memory CG stay unsharded,
as in the JAX package.  A mesh whose nx or ny does not divide it raises a
``SolverError``; under ``sharding_fallback="warn"`` it warns and solves
whole on the mesh's first device.

Spans (``utils.logging.span``: host events in the trace of a recording
``torch.profiler``, free without one): ``fg.run`` and ``fg.run_batched``
over the entries, ``fg.mean_stress`` over calc_mean_stress(_batched),
``fg.cg.init`` over the CG's init, ``fg.cg.step`` over each step launched
(one a batch step, whichever path its cases take), within a step
``fg.cg.update.kernel`` or ``fg.cg.update.plain`` over each vector update
(``ops/vector_kernels.py``: the kernel or the plain twin; one a case and a
slab), ``fg.cg.test`` over the host's convergence test of a chunk, and
``fg.sync.<why>`` over every point where the host waits for the device:
``residuals`` (a chunk's history read), ``gamma0``, ``metric0``,
``metric`` (the basic schemes' read), ``upload`` (a pageable host-to-device
copy: ``_vector``, the seed, the Voigt weights of ``fields.inner_l2``),
``end`` (the closing synchronize), ``mean_stress``, ``mean_strain``,
``bc_error`` and ``ref_material`` (the eigenvalue bounds, once per material
state).
"""
from __future__ import annotations

import dataclasses
import functools
import math
import sys
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from ..core import fields, voigt
from ..core.device import resolve_device, resolve_dtype
from ..materials import laws
from ..materials.sharded import for_slabs
from ..ops import gamma as gammamod
from ..ops import green, spectral_kernels, vector_kernels
from ..ops.stencil_kernels import (eps_from_u_dot, eps_from_u_dot_slabs,
                                   stress_div_beta, stress_div_beta_slabs)
from ..parallel import comm, shard_field, slabs
from ..parallel.fft import slab_fft_for, slab_reject_reason
from ..utils.logging import LOG, span
from . import bc as bcmod
from . import lowmem, newton
from . import refine as refinemod
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
        scheme; ``Willot_R`` is ``willot``."""
        s = _scheme_name(self.gamma_scheme)
        if s == "auto":
            s = "collocated" if self.method == "polarization" else "staggered"
        if self.method == "polarization" and "staggered" in s:
            LOG.warn("switching to collocated discretization for "
                     "polarization method")
            s = "collocated"
        return s


def _scheme_name(scheme):
    """A gamma_scheme value with '-' read as '_' and the ``Willot_R``
    alias as ``willot`` (the JAX package's resolved_scheme,
    ls.py:182-183)."""
    s = scheme.replace("-", "_")
    return "willot" if s.lower() == "willot_r" else s


# options implemented for any value; the rest must keep their default or
# take one of the values listed (each listed value behaves like the port's
# one path: no drain; ``use_dim2`` picks one of the JAX package's TPU
# programs, and the port's 3-D operators give the same answer on a
# one-voxel-thick cell).  nl_cg_c and nl_cg_tau set the reference's
# backtracking line search, which is dead code there (fibergen.cpp:22597)
# and in both packages; print_detF is read by no code of the JAX package,
# nor here.
_FREE = {"tol", "tol_red", "abs_tol", "bc_tol", "maxiter", "update_ref",
         "ref_scale", "error_estimator", "check_every", "dtype", "refine",
         "refine_max_sweeps", "refine_inner_tol", "low_mem", "g0_solver",
         "print_mean", "ref_mu", "ref_lambda", "newton_relax",
         "outer_error_estimator", "loadsteps", "first_loadstep",
         "max_loadstep_splits", "loadstep_extrapolation_order",
         "loadstep_extrapolation_method", "bc_relax", "cg_reinit",
         "nl_cg_alpha", "nl_cg_c", "nl_cg_tau", "nl_cg_beta_scheme",
         "step_mode", "print_detF", "sharding_fallback"}
_ALSO = {"mode": ("heat", "porous", "viscosity", "hyperelasticity"),
         "method": ("basic", "polarization", "nesterov", "basic+el",
                    "nl_cg"),
         "gamma_scheme": ("staggered", "collocated", "half_staggered",
                          "full_staggered", "willot"),
         "freq_hack": (True,),
         "newton_tangent": ("frozen_iso",),
         "adaptive_drain": ("off",), "use_dim2": ("off",),
         "batch_load_cases": ("off",)}


# options whose value is a choice: a value off the list is an error, not
# an option still to be ported
_CHOICES = {"refine": ("auto", "on", "off"),
            "low_mem": ("auto", "on", "off"),
            "g0_solver": ("fft", "multigrid"),
            "sharding_fallback": ("error", "warn"),
            "batch_load_cases": ("auto", "off"),
            "nl_cg_beta_scheme": ("steepest_descent", "polak_ribiere",
                                  "fletcher_reeves", "hestenes_stiefel",
                                  "day_yuan")}


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
        if f.name == "gamma_scheme":
            v = _scheme_name(v)
        if v != f.default and v not in _ALSO.get(f.name, ()):
            raise NotImplementedError(
                f"SolverOptions.{f.name}={v!r} is not ported yet (the port "
                f"implements every method and gamma scheme of the JAX "
                f"package in elasticity, heat, porous flow, viscosity and "
                f"hyperelasticity)")
    if hyper and opt.method == "polarization":
        raise NotImplementedError(
            "the polarization method in hyperelasticity: the hyperelastic "
            "laws have no polarization, as in the JAX package "
            "(materials/laws.py)")
    if opt.method == "nl_cg" and not hyper:
        raise SolverError("nl_cg requires hyperelasticity mode")
    if _scheme_name(opt.gamma_scheme) == "willot" and opt.mode not in (
            "elasticity", "viscosity"):
        raise ValueError(f"Unknown gamma scheme 'willot' for mode "
                         f"'{opt.mode}'")
    make_estimator(opt.error_estimator)
    make_estimator(opt.outer_error_estimator)


def _agrees(device, mesh_devices):
    """Whether a solver's ``device`` names the mesh's devices (its type,
    and its index where it gives one)."""
    d = torch.device(device)
    return all(m.type == d.type and d.index in (None, m.index)
               for m in mesh_devices)


def _spanned(name):
    """A method run inside the span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def _read(x, why):
    """The tensor ``x`` on the host as a numpy array, inside the span
    ``fg.sync.<why>``: the host waits there for the device."""
    with span("fg.sync." + why):
        return x.cpu().numpy()


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
    true; ``loadstep_writer`` (the loadstep's index) is called after each
    loadstep before it (the solution VTK of <write_loadsteps>);
    :meth:`cancel` ends the running solve at its next convergence test, and
    the run returns True."""

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
        # the float64 solution of a refined solve (solvers/refine.py) and
        # its float64 twin of the solver; the means read them when present
        self.eps64: Optional[torch.Tensor] = None
        self._refiner = None
        self.refine_sweeps = 0
        self.refine_inner_iters = 0
        self.refine_log = []
        # the tolerance of the running solve phase: max(tol, 1e-6) for the
        # float32 CG that refinement finishes
        self._tol_active = self.opt.tol
        # the low-memory route of the last linear CG (lowmem.route) and its
        # tuple state while an lm6 solve runs
        self._route = None
        self._lm6_eps_t = None
        self.residuals: List[float] = []
        self.solve_time = 0.0
        self.convergence_callback: Optional[Callable[[], bool]] = None
        self.loadstep_callback: Optional[Callable[[], bool]] = None
        self.loadstep_writer: Optional[Callable[[int], None]] = None
        # applications of each spectral chain in the last solve
        self._chain_calls = {}
        self._canceled = False
        self._diverged = False
        self.newton_iterations = [0, 0]     # outer, inner (hyperelasticity)
        self._eig_memo = None
        self._estimator_kind = make_estimator(
            self.opt.error_estimator).metric_kind
        self.par = self._slab_layout(sharding)
        if self.par is not None:
            self.mat = for_slabs(material)
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
                (self.mode == "elasticity" and self.opt.g0_solver == "fft")
                or (self.mode == "viscosity"
                    and all(float(p.law.iso_moduli()[1]) == 0.0
                            for p in self.mat.phases)))

    def cancel(self):
        """End the running solve at its next convergence test; the run
        returns True."""
        self._canceled = True

    def _slab_layout(self, sharding):
        """The x-slab layout of a sharded solve (parallel.fft.SlabPar), None
        unsharded or on a replicated sharding.  A sharding that cannot
        take the slab path raises, as in the JAX package (ls.py:303-322);
        under ``sharding_fallback="warn"`` it logs the JAX package's
        warning and the solve runs whole on the mesh's first device (the
        counterpart of the JAX package's replicated solve: the unsharded
        path, its kernels K1-K6 on that card)."""
        if sharding is None:
            return None
        par = slab_fft_for(sharding, self.grid)
        if par is None and not sharding.is_fully_replicated:
            reason = slab_reject_reason(sharding, self.grid)
            if self.opt.sharding_fallback != "warn":
                raise SolverError(
                    f"sharded solve cannot use the slab FFT: {reason}. Use "
                    f"a grid whose nx and ny divide the mesh, or set "
                    f"SolverOptions(sharding_fallback='warn') to solve it "
                    f"whole on the mesh's first device.")
            LOG.warn(
                f"sharded solve cannot use the slab FFT: {reason}. "
                "Without it GSPMD lowers every FFT to a full-field "
                "all-gather (each device computes the whole transform; "
                "neither memory nor ICI traffic scales with the mesh). "
                "Use a grid whose nx and ny divide the mesh, or set "
                "SolverOptions(sharding_fallback='warn') to proceed "
                "with replicated FFTs anyway.")
            LOG.warn(f"sharding_fallback='warn': the port solves this "
                     f"{self.grid.nx}x{self.grid.ny}x{self.grid.nz} mesh "
                     f"whole on its first device, {self.device}")
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
        """Mean strain; a refined solve's from its float64 solution."""
        return self._mean_strain("mean_strain")

    def _mean_strain(self, why):
        if self.eps64 is not None:
            return self._refiner.mean_strain(self.eps64)
        return _read(slabs.local(fields.mean(self.eps)), why)

    @_spanned("fg.mean_stress")
    def calc_mean_stress(self):
        """Mean stress; the mean first Piola-Kirchhoff stress in
        hyperelasticity.  A refined solve's comes from its float64
        solution through the float64 material (the float32 reduction
        would drop the digits the refinement bought)."""
        return self._mean_stress("mean_stress")

    def _mean_stress(self, why):
        if self.eps64 is not None:
            return self._refiner.mean_stress(self.eps64)
        return _read(slabs.local(self.mat.mean_pk1(self.eps)), why)

    def calc_mean_cauchy(self):
        if self.eps64 is not None:
            return self._refiner.mean_stress(self.eps64)
        return slabs.local(self.mat.mean_cauchy(self.eps)).cpu().numpy()

    def calc_mean_energy(self):
        if self.eps64 is not None:
            return self._refiner.mean_energy(self.eps64)
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
            with span("fg.sync.ref_material"):
                lmin, lmax = (float(x) for x in self.mat.eig_range(self.eps))
        else:
            key = self.mat.state()
            if self._eig_memo is None or len(self._eig_memo[0]) != len(key) \
                    or not all(a is b for a, b in zip(self._eig_memo[0], key)):
                with span("fg.sync.ref_material"):
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
        if self.mode == "viscosity":
            self._warn_singular_trace()
        self._make_bc()

    def _warn_singular_trace(self):
        """Warn where a viscosity phase makes the Delta operator singular or
        indefinite on the trace: mu_0 comes from bounds without the trace
        row and column (zero_trace), as in the JAX package, so a phase with
        2 mu + 3 lambda >= 4 mu_0 takes the trace factor 1 - (2 mu + 3
        lambda - 2 mu_0) / (2 mu_0) to zero or below.  Only rounding lives
        on the trace of a traceless loading, but it grows from iteration to
        iteration there; the mean stress is not affected."""
        for p in self.mat.phases:
            f = getattr(p.law, "iso_moduli", None)
            if f is None:
                continue
            mu, lam = (float(v) for v in f())
            if 2.0 * mu + 3.0 * lam >= 4.0 * self.mu_0:
                LOG.warn(f"viscosity phase '{p.name}': 2 mu + 3 lambda = "
                         f"{2.0 * mu + 3.0 * lam:g} >= 4 mu_0 = "
                         f"{4.0 * self.mu_0:g}, the Delta operator is "
                         f"singular or indefinite on the trace: rounding "
                         f"there grows each iteration (the mean stress is "
                         f"not affected)")

    def _maybe_update_ref(self):
        if self.opt.update_ref != "never" or not np.isfinite(self.mu_0):
            self.calc_ref_material()
        elif self._bc is None:
            self._make_bc()

    def _bca(self):
        """The projector when it corrects the mean (None for P == Id);
        refuses a bc_relax it cannot honour (:func:`bc.check_relax`)."""
        if self._bc is None or self._bc.is_trivial:
            return None
        bcmod.check_relax(self._bc, self.mode)
        return self._bc

    @staticmethod
    def _relaxed(E, bc, x, alpha=-1.0):
        """E + alpha (R's term in F00 = mean(x)): the mean that a Gamma
        application to ``x`` with ``alpha`` takes under a relaxed projector
        (:func:`bc.relax_term`); E itself without one."""
        if bc is None or bc.bc_relax == 1.0:
            return E
        return slabs.smap(lambda E, m: torch.as_tensor(
            E, dtype=m.dtype, device=m.device) + alpha * bcmod.relax_term(
                bc, m), E, fields.mean(x))

    def _bc_mean(self, E, S):
        return np.asarray(bcmod.calc_bc_mean(self._bc, E, S), dtype=np.float64)

    # -------------------------------------------------------------- run
    @_spanned("fg.run")
    def run(self) -> bool:
        """Full solve over all loadsteps (run, fibergen.cpp:21247-21398).
        Returns True on failure or cancel, False on success, like the
        reference."""
        self._settle_route()
        self.residuals = []
        self._canceled = False
        self._diverged = False
        self.newton_iterations = [0, 0]
        self.eps64 = None
        self._refiner = None
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

        # initial field (fibergen.cpp:21368-21380)
        self.eps = self._seed()
        if np.isfinite(self.mu_0) and self._bc is None:
            self._make_bc()
        t0 = time.perf_counter()
        calls0 = dict(spectral_kernels.calls)
        self._reset_stall()
        failed = self._run_loadstepping(self.E, self.S)
        self._sync()
        self.solve_time = time.perf_counter() - t0
        self._chain_calls = _since(calls0)
        return failed

    def _seed(self):
        """The initial field: Id in hyperelasticity, zero otherwise."""
        with span("fg.sync.upload"):
            return self._const(self._id if self.mode == "hyperelasticity"
                               else np.zeros(self.dim))

    def _sync(self):
        devices = [self.device] if self.par is None else self.par.devices
        with span("fg.sync.end"):
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
            # the loadstep's solution VTK (performLoadstepActions,
            # fibergen.cpp:21434-21439)
            if self.loadstep_writer is not None:
                self.loadstep_writer(istep)
            if self.loadstep_callback and self.loadstep_callback():
                LOG.info("Loadstep callback break request.")
                return True
            istep += 1
        return False

    def run_solver(self, E, S):
        """Method dispatch (runSolver, fibergen.cpp:21401-21433)."""
        self._reset_stall()
        self._tol_active = self.opt.tol
        self._current_E = np.asarray(E)
        self._current_S = np.asarray(S)
        m = self.opt.method
        if m == "basic":
            self._run_basic(E, S)
        elif m == "polarization":
            self._run_polarization(E, S)
        elif m == "nesterov":
            self._run_nesterov(E, S)
        elif m == "basic+el":
            self._run_basic_el(E, S)
        elif m == "nl_cg":
            newton.run_nlcg(self, E, S)
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

    def _refine_ok(self, bc) -> bool:
        """Whether mixed-precision refinement (solvers/refine.py) engages
        after this CG (the JAX package's _refine_ok, ls.py:1811-1837): a
        float32 linear CG with ``refine="on"`` or tol < 3e-7, trivial BCs,
        no prescribed stress, unsharded.  Where a deep tolerance asks for
        it and it cannot engage (hyperelasticity, mixed BCs, a prescribed
        stress, a sharded solve) it warns, and the stagnation guard stops
        the solve at the float32 floor."""
        o = self.opt
        if o.refine == "off" or o.method != "cg":
            return False
        if not (o.refine == "on" or o.tol < 3e-7) \
                or self.dtype != torch.float32:
            return False
        why = None
        if self.mode == "hyperelasticity":
            why = "hyperelastic Newton is out of refinement scope"
        elif bc is not None:
            why = "mixed BCs are out of refinement scope"
        elif voigt.norm_2(self._current_S) != 0.0:
            why = "prescribed stress is out of refinement scope"
        elif self.sharding is not None:
            why = "sharded solves are out of refinement scope"
        if why is not None:
            LOG.warn(f"tolerance {o.tol:g} is below the f32 floor but "
                     f"mixed-precision refinement cannot engage: {why}; "
                     "the stagnation guard will stop at the floor")
            return False
        return True

    def _solve_correction(self, rhs):
        """The float32 correction of one refinement sweep
        (refine._solve_correction): (d, inner iterations)."""
        return refinemod._solve_correction(self, rhs)

    # ------------------------------------------------------------ CG
    def _metric(self, eps):
        """The estimator's device metric of a field (the JAX package's
        ``metric``, ls.py:287-294): the component norms, the mean stress
        (sigma) or the mean energy; None for the residual and none
        kinds."""
        return newton.metric_for(self.mat, self._estimator_kind)(eps)

    def _host_metric(self, eps):
        m = self._metric(eps)
        return None if m is None else _read(slabs.local(m), "metric")

    # ------------------------------------------- values of a sharded solve
    def _vector(self, values):
        """A (n,) vector on the solve's device, or, sharded, on every slab's
        device."""
        with span("fg.sync.upload"):
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
        if not (self._k1_route and self.mode == "elasticity"):
            E = self._relaxed(E, bc, eps)      # K1/K3/K2 takes F00 itself
        if self.mode == "hyperelasticity":
            return gammamod.gamma_hyper(
                grid, self.scheme, E, mu0, lam0,
                self.mat.stress_diff(eps, mu0, lam0), par=par, bc=bc)
        if self.scheme in ("collocated", "willot"):
            return self._gamma_apply(E, self.mat.stress_diff(eps, mu0, lam0),
                                     bc=bc)
        if self.mode == "viscosity":
            if self._k1_route and bc is None:
                return gammamod.fused_visc(grid, eps, None, None, E, mu_x,
                                           lam_x, mu0, lam0, par=par,
                                           mod_halo=self._mod_halo)[0]
            return gammamod.delta_staggered(
                grid, E, mu0, self.mat.stress_diff(eps, mu0, lam0), bc=bc,
                par=par)
        if self.dim == 3:
            return gammamod.gamma_heat_staggered(
                grid, E, mu0, self.mat.stress_diff(eps, mu0, lam0), par=par,
                bc=bc)
        if not self._k1_route:
            return gammamod.gamma_staggered(
                grid, E, mu0, lam0, self.mat.stress_diff(eps, mu0, lam0),
                bc=bc, g0_solver=self.opt.g0_solver, par=par)
        return self._k1_k3_k2(eps, None, None, E, mu_x, lam_x, bc)[0]

    def _gamma_apply(self, E, tau, alpha=-1.0, beta=0.0, bc=None):
        """alpha Gamma tau + beta tau with mean E on the collocated grid
        (K5; K6 for viscosity's Delta operator) or with Willot's Gamma
        (``torch.fft``), the collocated elasticity Gamma symmetrized at the
        Nyquist bins under ``freq_hack``."""
        grid, mu0, lam0, par = self.grid, self.mu_0, self.lambda_0, self.par
        if self.mode == "viscosity":
            if self.scheme == "willot":
                return gammamod.delta_willot(grid, E, mu0, tau, alpha, beta,
                                             bc=bc, par=par)
            return gammamod.delta_collocated(grid, E, mu0, tau, alpha,
                                             par=par, bc=bc, beta=beta)
        if self.scheme == "willot":
            return gammamod.gamma_willot(grid, E, mu0, lam0, tau, alpha, beta,
                                         bc=bc, par=par)
        return gammamod.gamma_collocated(grid, E, mu0, lam0, tau, alpha, beta,
                                         par=par, bc=bc,
                                         freq_hack=self.opt.freq_hack)

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
            F0 = slabs.vmean(lambda x, m, lm: gammamod.stress_diff_mean(
                x, m, lm, mu0, lam0), r if p is None else p, mu_x, lam_x)
            E = slabs.smap(lambda E, F0: E - bcmod.bc_correction(bc, F0), E,
                           F0)
            E = self._relaxed(E, bc, r if p is None else p)
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

    def _cg_reinit(self, eps, Ej, mu_x, lam_x, zero, bc=None):
        """The exact residual r = krylov(eps) + E - eps and delta = <r, r>
        (the cg_reinit path, fibergen.cpp:23231-23245; the JAX package's
        ls.py:1042-1049), taken on the device after every ``cg_reinit``-th
        step, as the JAX package's loop takes it after the iteration of
        that number (ls.py:1695-1698); the next step builds its direction
        r + (delta / gamma) p from it."""
        r = self._gamma(eps, zero, mu_x, lam_x, bc)
        slabs.smap(lambda r, e, x: r.add_(e.reshape(-1, 1, 1, 1) - x), r, Ej,
                   eps)
        return r, slabs.smap(lambda d: d + self._tiny, fields.inner_l2(r, r))

    def _cg_step(self, eps, r, p_prev, gamma, gamma_prev, mu_x, lam_x, zero,
                 bc=None, metric=True):
        """One CG step; eps and r are updated in place.  The staggered
        elasticity and viscosity steps on the K1 route (viscosity without
        ``bc``) fuse the direction update into K1; the others form p, apply
        the operator and take the denominator <p, p - w> in PyTorch (the
        JAX package's generic step).  Sharded, each slab takes the same step
        (``slabs.smap``).  ``metric=False`` skips the estimator's metric
        (None in its place)."""
        grid = self.grid
        beta = slabs.smap(lambda g, gp: (g, gp), gamma, gamma_prev)
        fused = self._k1_route
        if fused and self.mode == "elasticity":
            w, p, dot_raw = self._k1_k3_k2(r, p_prev, beta, zero, mu_x, lam_x,
                                           bc)
            denom = slabs.smap(lambda d: d / grid.nxyz, dot_raw)
        elif fused and self.mode == "viscosity" and bc is None:
            w, p, dot_raw = gammamod.fused_visc(
                grid, r, p_prev, beta, zero, mu_x, lam_x, self.mu_0,
                self.lambda_0, par=self.par, mod_halo=self._mod_halo)
            denom = slabs.smap(lambda d: d / grid.nxyz, dot_raw)
        else:
            p = _direction(r, p_prev, gamma, gamma_prev)
            w = self._gamma(p, zero, mu_x, lam_x, bc)
            denom = fields.inner_l2_diff(p, p, w)
        return self._cg_update(eps, r, p, w, denom, gamma, metric)

    def _cg_update(self, eps, r, p, w, denom, gamma, metric=True):
        """The end of a CG step from the direction p, its operator image w
        and the denominator <p, p - w>: eps and r are updated in place by
        ``vector_kernels.cg_update`` (one pass on the card; a launch a slab
        when sharded); returns (eps, r, p, delta, gamma, metric)."""
        update = vector_kernels.cg_update_slabs if slabs.sharded(eps) else \
            vector_kernels.cg_update
        delta = update(eps, r, p, w, gamma, denom, self._tiny)
        met = self._metric(eps) if metric else None
        return eps, r, p, delta, gamma, met

    def _run_cg(self, E0, S0):
        """Linear CG on (I + Gamma(C-C0)) eps = E (runCGElasticity,
        fibergen.cpp:23153-23247) from eps = E, the mixed-BC mean of (E0,
        S0), in chunks of ``check_every`` iterations: the chunk's residual
        history reaches the host in one read, and each iteration's entry
        goes through the convergence test in order.  The step is the plain
        one or a low-memory route's (lowmem.route); a float32 solve that
        refinement finishes runs to max(tol, 1e-6) and then takes the
        refinement sweeps.  Hyperelasticity: Newton-Krylov
        (solvers/newton.py)."""
        if self.mode == "hyperelasticity":
            self._refine_ok(None)       # warns where a deep tol asks for it
            return newton.run_newton_cg(self, E0, S0)
        self.eps = None                 # the CG builds its own from E
        self._maybe_update_ref()
        E = self._bc_mean(E0, S0)
        bc = self._bca()
        refine = self._refine_ok(bc)
        if refine:
            self._tol_active = max(self.opt.tol, 1e-6)
        ee = make_estimator(self.opt.error_estimator)
        mu_x, lam_x = self._moduli()
        Ej = self._vector(E)
        zero = self._vector(np.zeros(self.dim))
        K = max(1, int(self.opt.check_every))
        route = self._route = lowmem.route(self, bc, K)

        if route == "lm6":
            with span("fg.cg.init"):
                eps, r, p, gamma, gamma_prev, met0 = lowmem.lm6_init(self, Ej,
                                                                     bc)
            self._lm6_eps_t = eps

            def step(*a):
                return lowmem.lm6_step(self, *a, bc=bc)

            def reinit(eps):
                return lowmem.lm6_reinit(self, eps, Ej, bc)
        else:
            with span("fg.cg.init"):
                eps, r, p, gamma, gamma_prev, met0 = self._cg_init(
                    Ej, mu_x, lam_x, zero, bc)
            self.eps = eps

            if route == "stacked":
                def step(*a):
                    return lowmem.stacked_step(self, *a)
            else:
                def step(*a):
                    return self._cg_step(*a, mu_x, lam_x, zero, bc)

            def reinit(eps):
                return self._cg_reinit(eps, Ej, mu_x, lam_x, zero, bc)
        reinit_every = max(0, int(self.opt.cg_reinit))
        gamma0 = None
        it = 0
        steps = 0
        done = False
        while not done:
            gs, ms = [], []
            for _ in range(K):
                gs.append(slabs.local(gamma))
                with span("fg.cg.step"):
                    eps, r, p, gamma, gamma_prev, met = step(eps, r, p, gamma,
                                                             gamma_prev)
                ms.append(None if met is None else slabs.local(met))
                steps += 1
                if reinit_every and steps % reinit_every == 0:
                    r, gamma = reinit(eps)
            if gamma0 is None:
                ee.start(None if met0 is None else
                         _read(slabs.local(met0), "metric0"))
                with span("fg.sync.gamma0"):
                    gamma0 = float(gs[0])
            gs = _read(torch.stack(gs), "residuals")
            ms = None if ms[0] is None else _read(torch.stack(ms), "residuals")
            with span("fg.cg.test"):
                for k in range(K):
                    if ee.metric_kind == "residual":
                        ee.update_cg(float(gs[k]), gamma0)
                    else:
                        ee.update(None if ms is None else ms[k])
                    it, done = self._converged(it, ee.abs_error(),
                                               ee.rel_error())
                    if done:
                        break
        if route == "lm6":
            # the r and p components go before eps is stacked
            del r, p
            self._lm6_eps_t = None
            self.eps = torch.stack(eps)
            del eps
        if refine and not (self._canceled or self._diverged):
            refinemod.refine(self, E)

    # ------------------------------------------------------ batched CG
    def _batched_chain(self):
        """Whether run_batched steps its cases through one batched chain:
        every whole-field path whose operator reaches a chain (K3, K4, K5,
        K6).  Willot's Gamma and ``freq_hack`` (torch.fft) and the
        multigrid G0 (plain PyTorch) launch no chain, and on the x-slab
        mesh each case takes its kz-slab chain, as the JAX package's
        sharded batched program runs no Pallas kernel (ls.py:961): those
        keep the per-case loop."""
        return (self.par is None and self.scheme != "willot"
                and not (self.opt.freq_hack and self.scheme == "collocated"
                         and self.mode == "elasticity")
                and not (self.opt.g0_solver == "multigrid"
                         and self.mode == "elasticity"
                         and self.scheme != "collocated"))

    def _stress_diffs(self, xs):
        """(C(x) - C0) : x of each field of ``xs`` as one (B, ...) batch,
        each case's formed in turn into its row."""
        tau = None
        for b, x in enumerate(xs):
            t = self.mat.stress_diff(x, self.mu_0, self.lambda_0)
            if tau is None:
                tau = t.new_empty((len(xs),) + tuple(t.shape))
            tau[b] = t
        return tau

    def _k1_batched(self, rs, p_prevs, betas, E, mu_x, lam_x):
        """The K1 route's fused operator on B right-hand sides (K1 and K2
        per case around one batched K3): (ws, ps, dots), as
        ``gammamod.k1_k3_k2_batched`` or ``fused_visc_batched`` give
        them."""
        op = gammamod.k1_k3_k2_batched if self.mode == "elasticity" else \
            gammamod.fused_visc_batched
        return op(self.grid, rs, p_prevs, betas, E, mu_x, lam_x, self.mu_0,
                  self.lambda_0)

    def _gamma_batched(self, xs, E, mu_x, lam_x):
        """:meth:`_gamma` (pure strain) of each of the B fields ``xs`` with
        one batched chain: the case-wise stage before it (K1, or the stress
        difference and its stencil), the chain, the case-wise stage after
        it (``gammamod``'s ``*_batched`` forms).  A list of the B
        results."""
        grid, mu0, lam0 = self.grid, self.mu_0, self.lambda_0
        if self._k1_route:
            return self._k1_batched(xs, None, None, E, mu_x, lam_x)[0]
        tau = self._stress_diffs(xs)
        if self.scheme == "collocated":
            if self.mode == "viscosity":
                return gammamod.delta_collocated_batched(grid, E, mu0, tau)
            return gammamod.gamma_collocated_batched(grid, E, mu0, lam0, tau)
        if self.mode == "viscosity":
            return gammamod.delta_staggered_batched(grid, E, mu0, tau)
        if self.dim == 3:
            return gammamod.gamma_heat_staggered_batched(grid, E, mu0, tau)
        return gammamod.gamma_staggered_batched(grid, E, mu0, lam0, tau)

    def _cg_init_batched(self, Es, cases, mu_x, lam_x, zero):
        """:meth:`_cg_init` of every case of a batch with one batched
        chain: case b's strain, the constant field of ``Es[b]``, is formed
        in its row ``cases[b]``.  Returns the cases' states [eps, r, p,
        gamma, gamma_prev] and their initial metrics."""
        Ejs = [self._vector(E) for E in Es]
        for eps, Ej in zip(cases, Ejs):
            eps.copy_(Ej.reshape(-1, 1, 1, 1).expand_as(eps))
        rs = self._gamma_batched(cases, zero, mu_x, lam_x)
        states, mets = [], []
        for eps, r, Ej in zip(cases, rs, Ejs):
            r.add_(Ej.reshape(-1, 1, 1, 1) - eps)
            gamma0 = fields.inner_l2(r, r) + self._tiny
            states.append([eps, r, torch.zeros_like(r), gamma0, gamma0])
            mets.append(self._metric(eps))
        return states, mets

    def _cg_step_batched(self, states, mu_x, lam_x, zero):
        """One CG step of every case of a batch with one batched chain.
        Each case's state [eps, r, p, gamma, gamma_prev] is updated in
        place, with the direction, scalars, vector updates and reductions
        that :meth:`_cg_step` forms.  Returns the cases' metrics."""
        grid = self.grid
        if self._k1_route:
            ws, ps, dots = self._k1_batched(
                [st[1] for st in states], [st[2] for st in states],
                [(st[3], st[4]) for st in states], zero, mu_x, lam_x)
            denoms = [d / grid.nxyz for d in dots]
        else:
            ps = [_direction(*st[1:]) for st in states]
            ws = self._gamma_batched(ps, zero, mu_x, lam_x)
            denoms = [fields.inner_l2_diff(p, p, w) for p, w in zip(ps, ws)]
        mets = []
        for st, p, w, d in zip(states, ps, ws, denoms):
            out = self._cg_update(st[0], st[1], p, w, d, st[3])
            st[:] = out[:5]                 # eps, r, p, gamma, gamma_prev
            mets.append(out[5])
        return mets

    @_spanned("fg.run_batched")
    def run_batched(self, Es, pallas_mid="auto") -> bool:
        """B pure-strain load cases (the rows of ``Es``) against the one
        operator, advanced in lockstep by the linear CG (the JAX package's
        run_batched, ls.py:2008-2136): each right-hand side has its own
        (eps, r, p, gamma, gamma_prev) and the single solve's step.  Each
        step (and the init) applies the operator to all B cases with one
        batched chain (``_cg_step_batched``: one launch of K3, K4, K5 or
        K6 for the batch, as the JAX package's vmapped program runs one
        Pallas middle for all cases; K1 and K2 once per case, as its
        manual-DMA sweeps have no batching rule), and each case's scalars,
        vector updates and reductions are formed as run() forms them.
        Willot's Gamma, ``freq_hack``, the multigrid G0 and the x-slab mesh
        step case by case (``_batched_chain``).  Each chunk of
        ``check_every`` steps reads the (K, B) gamma and metric history to
        the host once; one estimator runs per right-hand side, and the batch
        stops at the chunk in which the worst of them converges.  The
        boundary conditions are pure strain whatever P and S say, as in the
        JAX package.

        On success ``eps_batch`` holds (B, dim, nx, ny, nz) and ``eps`` the
        last case (``eps_batch[-1]``); calc_mean_stress_batched() gives the
        (B, dim) mean stresses.  Sharded, each right-hand side steps on the
        slabs as run() steps them, and ``eps_batch`` is the list of the
        slabs' (B, dim, nx/D, ny, nz) blocks.  Returns True on failure,
        False on success (run() semantics).  ``pallas_mid`` (the JAX
        package's choice of its batched chain) is accepted and has no
        effect: the port takes its batched chain wherever the path has
        one."""
        if self.opt.method != "cg" or self.mode == "hyperelasticity":
            raise SolverError("run_batched requires the linear CG")
        if self.sharding is not None and self.par is None:
            raise SolverError(
                "run_batched on a mesh requires the slab-FFT layout "
                "(x-slab NamedSharding with mesh-divisible nx, ny)")
        self._settle_route()
        t0 = time.perf_counter()
        calls0 = dict(spectral_kernels.calls)
        Es = np.asarray(Es, dtype=np.float64)
        B = Es.shape[0]
        self.residuals = []
        self._canceled = False
        self._diverged = False
        self._reset_stall()
        self._current_E = Es[-1]
        self._current_S = np.zeros(self.dim)
        self.eps = None
        self.eps64 = None
        self._refiner = None
        self._tol_active = self.opt.tol
        self._maybe_update_ref()
        mu_x, lam_x = self._moduli()
        zero = self._vector(np.zeros(self.dim))
        K = max(1, int(self.opt.check_every))
        ests = [make_estimator(self.opt.error_estimator) for _ in range(B)]

        if self.par is None:
            eps_b = torch.empty((B, self.dim) + self.grid.shape,
                                dtype=self.dtype, device=self.device)
        else:
            nxl = self.grid.nx // self.par.n_devices
            eps_b = [torch.empty((B, self.dim, nxl, self.grid.ny,
                                  self.grid.nz), dtype=self.dtype, device=d)
                     for d in self.par.devices]
        cases = _batch_cases(eps_b)
        batched = self._batched_chain()
        with span("fg.cg.init"):
            if batched:
                states, m0 = self._cg_init_batched(Es, cases, mu_x, lam_x,
                                                   zero)
            else:
                states, m0 = [], []
                for b in range(B):
                    eps, r, p, gamma, gamma_prev, met0 = self._cg_init(
                        self._vector(Es[b]), mu_x, lam_x, zero)
                    slabs.smap(torch.Tensor.copy_, cases[b], eps)
                    del eps
                    states.append([cases[b], r, p, gamma, gamma_prev])
                    m0.append(met0)
        g0 = [slabs.local(st[3]) for st in states]
        self.eps = cases[-1]
        g0 = _read(torch.stack(g0), "gamma0").astype(np.float64)
        for b, e in enumerate(ests):
            e.start(None if m0[b] is None else
                    _read(slabs.local(m0[b]), "metric0"))
        del m0
        it, done = 0, False
        while not done:
            gs, ms = [], []
            for _ in range(K):
                gs.append(torch.stack([slabs.local(st[3]) for st in states]))
                with span("fg.cg.step"):
                    if batched:
                        mk = self._cg_step_batched(states, mu_x, lam_x, zero)
                    else:
                        mk = []
                        for st in states:
                            out = self._cg_step(*st, mu_x, lam_x, zero)
                            st[:] = out[:5]   # eps, r, p, gamma, gamma_prev
                            mk.append(out[5])
                ms.append(None if mk[0] is None else
                          torch.stack([slabs.local(m) for m in mk]))
            gs = _read(torch.stack(gs), "residuals").astype(np.float64)
            ms = None if ms[0] is None else _read(torch.stack(ms), "residuals")
            with span("fg.cg.test"):                       # gs: (K, B)
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
        self.eps = cases[-1]
        self._sync()
        self.solve_time = time.perf_counter() - t0
        self._chain_calls = _since(calls0)
        return bool(self._canceled or self._diverged)

    # ------------------------------------------------------- the FFT time
    def get_fft_time(self) -> float:
        """The seconds the last solve (run or run_batched) spent in its
        spectral chains, estimated (the reference keeps FFTW's seconds,
        fibergen.cpp:15392-15393): one application of each chain the solve
        ran (K3, K4, K5, K6 or their kz-slab forms) is timed on a field of
        the solve's shape, dtype and device, and multiplied by the chain's
        applications in that solve (``spectral_kernels.calls``).  On the
        card the application is a kernel launch timed with CUDA events (the
        least of three after a warm-up); on the CPU it is the plain twin
        (``torch.fft`` around the apply) on the host clock, the least of
        three runs, so that a busy host inflates the estimate less.  A chain holds
        the transforms and the spectral apply together: its time is both."""
        return sum(n * self._chain_seconds(name, ncomp)
                   for (name, ncomp), n in self._chain_calls.items())

    def _chain_seconds(self, name, ncomp, reps=3):
        """Seconds of one application of the chain wrapper ``name`` on an
        ``ncomp``-component field of the solve's layout."""
        fn = getattr(spectral_kernels, name)
        gen = torch.Generator().manual_seed(0)
        # a batched chain on a batch of the last run_batched's size
        lead = (self.eps_batch.shape[0],) if name.endswith("_batched") \
            else ()
        f = torch.randn(lead + (ncomp,) + self.grid.shape, generator=gen,
                        dtype=self.dtype).to(self.device)
        args = (self.grid, f)
        if self.par is not None:
            args = (self.par, self.grid, shard_field(f, self.sharding.mesh))
        if "gamma" in name:
            E = torch.zeros(ncomp, dtype=self.dtype, device=self.device)
            if self.par is not None:
                E = comm.replicate(E, self.par.devices)
            consts = (0.5, -0.25, E, 0.0)
        else:
            consts = (-1.0,) if "heat" in name else (-1.0, -0.5)
        run = lambda: fn(*args, *consts)
        run()                                   # warm-up (and the build)
        times = []
        if self.device.type == "cuda":
            self._sync()
            for _ in range(reps):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                run()
                b.record()
                b.synchronize()
                times.append(a.elapsed_time(b) / 1e3)
            return min(times)
        for _ in range(reps):
            t0 = time.perf_counter()
            run()
            times.append(time.perf_counter() - t0)
        return min(times)

    # ---------------------------------------------------------- checkpoint
    def save_state(self, path: str):
        """Checkpoint the solver state (the field, the BCs and the reference
        material) in the JAX package's ``.npz`` keys, so that either package
        loads the other's."""
        eps = np.zeros(0) if self.eps is None else \
            slabs.whole(self.eps, "cpu").numpy()
        np.savez_compressed(
            path if path.endswith(".npz") else path + ".npz",
            eps=eps, E=self.E, S=self.S, P=self.P,
            mu_0=self.mu_0, lambda_0=self.lambda_0,
            residuals=np.asarray(self.residuals, dtype=np.float64),
            mode=np.array(self.mode), scheme=np.array(self.scheme))

    def load_state(self, path: str):
        """Resume from a checkpoint of :meth:`save_state` (of either
        package); a checkpoint of another mode raises."""
        d = np.load(path if path.endswith(".npz") else path + ".npz",
                    allow_pickle=False)
        if str(d["mode"]) != self.mode:
            raise SolverError(
                f"checkpoint mode '{d['mode']}' != solver mode '{self.mode}'")
        if d["eps"].size:
            eps = torch.as_tensor(d["eps"], dtype=self.dtype,
                                  device=self.device)
            self.eps = eps if self.par is None else \
                shard_field(eps, self.sharding.mesh)
            self.eps64 = None
            self._refiner = None
        self.E, self.S, self.P = d["E"], d["S"], d["P"]
        self.mu_0 = float(d["mu_0"])
        self.lambda_0 = float(d["lambda_0"])
        self.residuals = [float(v) for v in d["residuals"]]
        if np.isfinite(self.mu_0):
            self._make_bc()

    @_spanned("fg.mean_stress")
    def calc_mean_stress_batched(self):
        """(B, dim) mean stresses of the last run_batched."""
        return _read(torch.stack([slabs.local(self.mat.mean_pk1(e))
                                  for e in _batch_cases(self.eps_batch)]),
                     "mean_stress")

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
        """Eyre-Milton scheme on the collocated grid or with Willot's Gamma
        (runPolarization, fibergen.cpp:21808-21851, polarizationScheme
        :20536-20554): from eps = 4 mu_0 E (E the mixed-BC mean of (E0,
        S0)), tau = P(eps), eps <- -4 mu_0 Gamma tau + tau with mean
        <tau> + 4 mu_0 E (a device vector, corrected under a projector); at
        the end eps <- (C + C0)^{-1} eps.  In viscosity Gamma is the Delta
        operator (K6) and the + tau term is kept: the JAX package's
        delta_operator drops it (fibergen_tpu/ops/gamma.py:52-54), which
        leaves its iteration off the Lippmann-Schwinger solution."""
        self._maybe_update_ref()
        E = self._bc_mean(E0, S0)
        bc = self._bca()
        ee = make_estimator(self.opt.error_estimator)
        mu0 = self.mu_0
        P0 = self._vector(4.0 * mu0 * E)
        self.eps = self._const(P0)
        ee.start(self._host_metric(self.eps))
        it, done = 1, False
        while not done:
            tau = self.mat.polarization(mu0, self.eps)
            E = slabs.smap(torch.add, fields.mean(tau), P0)
            if bc is not None and bc.bc_relax != 1.0:
                E = self._relaxed(E, bc, self.mat.polarization(
                    mu0, self.eps, inv=True), -4.0 * mu0)
            self.eps = self._gamma_apply(E, tau, alpha=-4.0 * mu0, beta=1.0,
                                         bc=bc)
            del tau
            ee.update(self._host_metric(self.eps))
            # the boundary condition is not tested here, as in the JAX
            # package (solvers/ls.py _run_polarization)
            it, done = self._converged(it, ee.abs_error(), ee.rel_error(),
                                       check_bc=False)
        self.eps = self.mat.polarization(mu0, self.eps, inv=True)

    def _run_nesterov(self, E0, S0):
        """Nesterov-accelerated basic scheme (runNesterov,
        fibergen.cpp:21999-22043; the JAX package's ls.py:2179-2217) on the
        basic step (:meth:`_gamma`), with the restart when the step's norm
        q = <tau, tau> |cell| grows after five iterations.  One host read
        per iteration: the metric and q together."""
        self._maybe_update_ref()
        E = self._bc_mean(E0, S0)
        bc = self._bca()
        ee = make_estimator(self.opt.error_estimator)
        mu_x, lam_x = self._moduli()
        Ej = self._vector(E)
        ee.start(self._host_metric(self.eps))
        cell = self.grid.dx * self.grid.dy * self.grid.dz
        tau = eps = self.eps
        q, n, n_min = 0.0, 0, 5
        it, done = 1, False
        while not done:
            n += 1
            tau = self._gamma(tau, Ej, mu_x, lam_x, bc)
            met = self._metric(tau)
            eps = slabs.smap(torch.sub, eps, tau)
            q2 = slabs.local(fields.inner_l2(tau, tau)).reshape(1)
            host = torch.cat([q2] if met is None else
                             [slabs.local(met).reshape(-1), q2]).cpu().numpy()
            q_old, q = q, float(host[-1]) * cell
            if q_old > q and n > n_min:
                n = 0
                eps = tau
            else:
                c = (n - 1.0) / (n + 2.0)
                eps = slabs.smap(lambda t, e: t + c * e, tau, eps)
                tau, eps = eps, tau
            self.eps = tau
            ee.update(None if met is None else
                      host[:-1].reshape(slabs.local(met).shape))
            it, done = self._converged(it, ee.abs_error(), ee.rel_error())

    def _run_basic_el(self, E0, S0):
        """The basic scheme with an exact line search (runBasicEL,
        fibergen.cpp:21918-21996): from eps = E (E the mixed-BC mean of
        (E0, S0)), d = basic(eps) - eps, the residual of the
        Lippmann-Schwinger equation, and eps <- eps + alpha d with alpha
        minimizing the energy along d (:meth:`_line_step`).  The JAX
        package (ls.py:2219-2246) takes d <- -Gamma (C - C0) d after each
        step, the residual's change for alpha = 1 only, and so ends off
        the solution."""
        self._maybe_update_ref()
        E = self._bc_mean(E0, S0)
        bc = self._bca()
        ee = make_estimator(self.opt.error_estimator)
        mu_x, lam_x = self._moduli()
        Ej = self._vector(E)
        if self.mode == "hyperelasticity":
            # the current field shifted to the mean E
            self.eps = slabs.smap(lambda e, m, E: e + (E - m).reshape(
                -1, 1, 1, 1), self.eps, fields.mean(self.eps), Ej)
        else:
            self.eps = self._const(Ej)
        ee.start(self._host_metric(self.eps))
        it, done = 1, False
        while not done:
            d = slabs.smap(torch.Tensor.sub_,
                           self._gamma(self.eps, Ej, mu_x, lam_x, bc),
                           self.eps)
            alpha = self._line_step(self.eps, d)
            self.eps = slabs.smap(lambda e, d, a: e.addcmul(d, a), self.eps,
                                  d, alpha)
            del d
            ee.update(self._host_metric(self.eps))
            it, done = self._converged(it, ee.abs_error(), ee.rel_error())

    def _line_step(self, eps, d):
        """alpha minimizing <W(eps + alpha d)> - S:<eps + alpha d> along d
        (calcStep, fibergen.cpp:21853-21914), on the device: -(<P(eps), d>
        - S:<d>) / <d, dP(eps)[d]>, one Newton step on the line, exact for
        linear laws, where it is -(<eps, C d> - S:<d>) / <d, C d>; 0 where
        the denominator is 0.  S is the prescribed mean stress (0 under
        pure strain control)."""
        mat = self.mat
        if self.mode == "hyperelasticity":
            s1 = fields.inner_l2(mat.pk1(eps), d)
            s2 = fields.inner_l2(d, mat.dpk1(eps, d))
        else:
            Sd = mat.pk1(d)
            s1 = fields.inner_l2(eps, Sd)
            s2 = fields.inner_l2(d, Sd)
            del Sd
        S = voigt.weights(self.dim) * np.asarray(self._current_S)
        if np.any(S):
            s1 = slabs.smap(lambda a, m: a - (m * torch.as_tensor(
                S, dtype=m.dtype, device=m.device)).sum(), s1, fields.mean(d))
        return slabs.smap(lambda a, b: torch.where(
            b == 0, torch.zeros_like(b), -a / b), s1, s2)

    def calc_min_eig_h(self):
        """The largest asymmetry of the per-voxel tangent dP/dF over the
        grid (calcMinEigH, fibergen.cpp:17813-17867; the JAX package's
        ls.py:2396-2417): max |dP - dP^T|_F, the columns dP[e_j] taken
        one unit direction at a time."""
        dim = self.dim
        eye = torch.eye(dim, dtype=self.dtype, device=self.device)

        def one(F):
            cols = [self.mat.dpk1(F, eye[j].reshape(dim, 1, 1, 1)
                                  .expand(F.shape)) for j in range(dim)]
            r2 = None
            for i in range(dim):
                for j in range(i + 1, dim):
                    t = 2.0 * (cols[j][i] - cols[i][j]) ** 2
                    r2 = t if r2 is None else r2 + t
            return torch.sqrt(r2).max()
        return float(slabs.fold(torch.maximum, slabs.smap(one, self.eps)))

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
        tol = self._tol_active
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
        if self.opt.step_mode and sys.stdin is not None \
                and sys.stdin.isatty():
            # interactive stepping (the reference's step_mode,
            # fibergen.cpp:21168-21172), never when stdin is not a terminal
            LOG.info("Press the ENTER key")
            sys.stdin.readline()
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
        if self.eps is None and self._lm6_eps_t is not None:
            # an lm6 solve's tuple state (lowmem.lm6_means)
            Emean, Smean = (_read(t, "bc_error").astype(np.float64) for t in
                            lowmem.lm6_means(self, self._lm6_eps_t))
        else:
            Emean = self._mean_strain("bc_error").astype(np.float64)
            Smean = self._mean_stress("bc_error").astype(np.float64)
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


def _direction(r, p_prev, gamma, gamma_prev):
    """The CG direction p = r + (gamma / gamma_prev) p_prev (slab by slab
    on a mesh)."""
    return slabs.smap(lambda r, pp, g, gp: r + (g / gp) * pp, r, p_prev,
                      gamma, gamma_prev)


def _batch_cases(eps_batch):
    """The fields of a batch, one per right-hand side: the (B, dim, ...)
    tensor's rows, or of the slabs' blocks each case's list of slabs."""
    if slabs.sharded(eps_batch):
        return [[x[b] for x in eps_batch]
                for b in range(eps_batch[0].shape[0])]
    return list(eps_batch)


def _since(calls0):
    """The chain applications counted since the snapshot ``calls0``."""
    return {k: v - calls0.get(k, 0)
            for k, v in spectral_kernels.calls.items()
            if v > calls0.get(k, 0)}


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
