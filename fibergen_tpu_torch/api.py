"""FG, the project-level scripting API of the port.

Port of fibergen_tpu/api.py (the reference's FG orchestrator + FGProject +
PyFG bindings, fibergen.cpp:24742-27197): FG owns the XML project tree, the
fibre generator and the Lippmann-Schwinger solver, evaluates XML attributes
as Python expressions and interprets the ``<actions>`` list.  The project
runs on the card unless ``FG(device="cpu")``: the fibres are generated on
the host, voxelized on the solver's device (geometry/discretize.py), and
solved there.  ``<datatype>double</datatype>``, the default, is float64 on
any device; ``float`` is float32.

The TPU-only solver knobs of a project (``fft_backend``, ``use_pallas``,
``use_sweep``, ``adaptive_drain``, ``low_mem``, ``use_dim2``) are checked as
the JAX package checks them and have no effect.  The actions that write or
read files of the I/O slice, mesh primitives, fibre detection and the
solver checkpoints raise NotImplementedError naming their ROADMAP.md item.

:data:`VISCOSITY_CASES` and :func:`effective_viscosity` hold the arithmetic
of ``calc_effective_properties`` in viscosity (FG._effective_viscosity,
fibergen.cpp:26252-26399).
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .config.xmlproject import ExpressionEngine, SettingsReader, XMLProject
from .core import voigt as voigtmod
from .core.device import resolve_device
from .core.grid import Grid
from .geometry import discretize
from .geometry import distributions as distmod
from .geometry.generator import FiberGenerator, GeneratorSettings
from .geometry.primitives import Capsule, Cylinder, HalfSpace
from .materials import convert, laws
from .materials.dfg import DfgMaterial, fine_grid
from .materials.mixing import Phase, make_mixed
from .solvers.ls import MODE_DIM, LSSolver, SolverOptions
from .utils.logging import LOG, TIMINGS, timer

# the five traceless unit cases as rows (Voigt, tensor shears):
# e_xx - e_yy, e_yy - e_zz, e_yz, e_xz, e_xy
VISCOSITY_CASES = np.array([[1.0, -1, 0, 0, 0, 0], [0, 1.0, -1, 0, 0, 0],
                            [0, 0, 0, 1.0, 0, 0], [0, 0, 0, 0, 1.0, 0],
                            [0, 0, 0, 0, 0, 1.0]])


@dataclasses.dataclass
class EffectiveViscosity:
    """``C55``: the effective viscosity "2 eta" on the five traceless
    components (yy, zz, yz, xz, xy); ``C``: the 6x6 in Voigt notation
    (shear columns halved); ``alpha``, ``beta``: the Nunan-Keller
    coefficients, the means over the six off-diagonal index pairs, and
    ``alpha_std``, ``beta_std`` their spreads."""

    C55: np.ndarray
    C: np.ndarray
    alpha: float
    beta: float
    alpha_std: float = 0.0
    beta_std: float = 0.0


def effective_viscosity(S, matrix_fluidity) -> EffectiveViscosity:
    """The effective viscosity from the (5, 6) mean stresses ``S`` (Voigt,
    tensor shears) of :data:`VISCOSITY_CASES` in order, and the Nunan-Keller
    alpha and beta against the matrix phase's law fluidity
    ``matrix_fluidity`` (the law's ``mu``; a project file's viscosity
    ``mu`` is scaled by 0.5 when the law is made, and 0.5 / mu is the
    matrix viscosity "2 eta")."""
    E = VISCOSITY_CASES.T
    S = np.asarray(S, dtype=np.float64).T
    C55 = E[1:6] @ np.linalg.inv(S[1:6])
    C = np.zeros((6, 6))
    C[1:6, 1:6] = C55
    for i in range(5):
        if S[0, i] != 0:
            for j in range(1, 6):
                C[j, 0] = (E[j, i] - C[j, 1:6] @ S[1:6, i]) / S[0, i]
            break
    C[0, :] = -(C[1, :] + C[2, :])
    for i in range(6):
        C[i, 0:3] -= C[i, 0:3].min()
    C[:, 3:6] *= 0.5
    v = [[0, 5, 4], [5, 1, 3], [4, 3, 2]]
    mu0 = 0.5 / matrix_fluidity
    alphas, betas = [], []
    for i in range(3):
        for j in range(3):
            if i != j:
                betas.append(C[v[i][j]][v[i][j]] / mu0 - 1.0)
                alphas.append(0.5 * C[v[i][i]][v[i][i]] / mu0
                              - 0.5 * C[v[i][i]][v[j][j]] / mu0 - 1.0)
    return EffectiveViscosity(C55, C, float(np.mean(alphas)),
                              float(np.mean(betas)), float(np.std(alphas)),
                              float(np.std(betas)))


class FGError(RuntimeError):
    pass


_MESH = "ROADMAP.md, Queue 1 item 6: mesh primitives"
_IO = "ROADMAP.md, Queue 1 item 6: file I/O"
_FRONT = "ROADMAP.md, Queue 1 item 7"
# actions of the JAX package's FG that the port does not run yet
NOT_PORTED = {
    **{a: _IO for a in ("write_vtk", "write_vtk2", "write_vtk_phase",
                        "write_lss_vtk", "write_raw_data", "read_raw_data",
                        "write_png", "write_pvpy", "write_voxel_data",
                        "write_fiber_data", "write_fo_data")},
    **{a: _MESH for a in ("place_triangle", "place_tetrahedron", "place_stl",
                          "place_tetvtk", "place_tetdolfin")},
    "detect_fibers": "ROADMAP.md, Queue 1 item 6: fibre detection",
    "save_state": f"{_FRONT}: solver checkpoints",
    "load_state": f"{_FRONT}: solver checkpoints",
}
# the values the JAX package accepts for its TPU-only solver knobs, which
# choose among its TPU programs: checked here, then left out of the port's
# options (SolverOptions checks the options the port takes)
_KNOBS = {"use_pallas": ("auto", "on", "off"),
          "use_sweep": ("auto", "on", "off"),
          "adaptive_drain": ("auto", "on", "off"),
          "low_mem": ("auto", "on", "off"),
          "use_dim2": ("auto", "off"),
          "fft_backend": ("auto", "xla", "matmul")}


def _sync(device):
    """Wait for the card, so that the host timers hold the device's work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _not_ported(what, item):
    raise NotImplementedError(f"{what} is not ported yet ({item})")


class FG:
    """The fibergen solver class (PyFG, fibergen.cpp:26785-27140).
    ``FG(project_xml_path, device=None)``: ``device`` defaults to ``cuda``
    and raises without a card; ``device="cpu"`` runs the plain PyTorch
    path."""

    def __init__(self, *args, device=None):
        self.device = resolve_device(device)
        self.project = XMLProject()
        self.engine = ExpressionEngine()
        self._reset_state()
        if args and isinstance(args[0], str):
            self.load_xml(args[0])

    # ------------------------------------------------------------- lifecycle
    def _reset_state(self):
        self.gen: Optional[FiberGenerator] = None
        self.solver: Optional[LSSolver] = None
        self._phases_initialized = False
        self._fibers_initialized = False
        self._material_index: Dict[str, int] = {}
        self._matrix_material = 0
        self._Ceff: Optional[np.ndarray] = None
        self._error = False
        self._cancel = False
        self._convergence_callback = None
        self._loadstep_callback = None
        self._dtype = None
        self._gfields_cache = None
        # seconds of the last init_phase (voxelization, and the geometry
        # fields it needs) and of the last geometry-field sweep, on the
        # host clock after the device finished
        self.phase_time = self.geometry_time = 0.0
        # get_distance_evals counts this instance's voxelization work
        self._dist_evals0 = int(discretize.DIST_EVALS)

    def reset(self):
        """Reset the solver state and unload the project (PyFG::reset)."""
        self.project = XMLProject()
        self.engine = ExpressionEngine()
        self._reset_state()

    # ------------------------------------------------------------ project xml
    def load_xml(self, filename: str):
        self.project.load_xml(filename)
        self._xml_dir = os.path.dirname(os.path.abspath(filename))

    def set_xml(self, text: str):
        self.project.set_xml(text)

    def get_xml(self) -> str:
        return self.project.get_xml()

    def set_xml_precision(self, digits: int):
        self.project.xml_precision = digits

    def get_xml_precision(self) -> int:
        return self.project.xml_precision

    def set(self, path: str, *args, **kwargs):
        """set('a.b..attr', value) or set('path', x=1, y=2)
        (fibergen.cpp:27157-27161)."""
        if kwargs:
            for k, v in kwargs.items():
                self.project.set(path + ".." + k, v)
            return
        self.project.set(path, args[0] if args else None)

    def get(self, path: str) -> str:
        return self.project.get(path)

    def erase(self, path: str):
        self.project.erase(path)

    def set_variable(self, name: str, value):
        self.engine.add_local(name, value)

    def get_variable(self, name: str):
        return self.engine.locals.get(name)

    def set_log_file(self, filename: str):
        LOG.set_log_file(filename)

    def set_py_enabled(self, enabled: bool):
        self.engine.enabled = bool(enabled)

    # --------------------------------------------------------------- readers
    def _settings(self) -> SettingsReader:
        return SettingsReader(self.engine, self.project.root)

    def _init_python(self):
        """Load <variables> and execute the <python> blocks
        (FG::init_python, fibergen.cpp:24873-24930)."""
        self.engine.add_local("fg", self)
        for v in self._settings().child("variables").children():
            typ = v.get("type", "object")
            raw = v.get("value", "")
            if typ == "str":
                val = raw
            elif typ == "int":
                val = int(self.engine.eval(raw))
            elif typ == "float":
                val = float(self.engine.eval(raw))
            else:
                val = self.engine.eval(raw) if raw else None
            self.engine.add_local(v.tag, val)
        for p in self.project.root.findall("python"):
            if p.text and p.text.strip():
                self.engine.exec_code(p.text)

    def _dtype_str(self):
        """<datatype>: double (the default) is float64 on any device, any
        other value float32, as in the JAX package."""
        if self._dtype is None:
            want = self._settings().value("datatype", "double", str)
            self._dtype = "float64" if want == "double" else "float32"
        return self._dtype

    # ------------------------------------------------------------- init_lss
    def init_lss(self):
        """Create the LSSolver from the <solver> settings (FG::init_lss,
        fibergen.cpp:24990-25017 + LSSolver::readSettings,
        fibergen.cpp:15044-15362).  The phases get their fields in
        :meth:`init_phase`."""
        if self.solver is not None:
            return
        s = self._settings()
        sol = s.child("solver")
        if sol.elem is None:
            raise FGError("No <solver> section in project")

        n = sol.attr("n", 0, int)
        mult = sol.attr("mult", 1, int)
        nx = sol.attr("nx", n, int) * mult
        ny = sol.attr("ny", n, int) * mult
        nz = sol.attr("nz", n, int) * mult
        # <dim>2</dim>: a one-voxel-thick periodic cell, solved by the 3-D
        # operators (a periodic size-1 axis has zero derivative)
        if s.value("dim", 3, int) == 2:
            nz = 1
        if min(nx, ny, nz) < 1:
            raise FGError("Invalid solver resolution")
        grid = Grid(nx, ny, nz, s.value("dx", 1.0), s.value("dy", 1.0),
                    s.value("dz", 1.0),
                    (s.value("x0", 0.0), s.value("y0", 0.0),
                     s.value("z0", 0.0)))

        for knob, allowed in _KNOBS.items():
            v = sol.value(knob, "auto", str)
            if v not in allowed:
                raise FGError(f"Unknown {knob} '{v}' (expected "
                              f"{', '.join(allowed[:-1])} or {allowed[-1]})")
        opt = SolverOptions(
            mode=sol.value("mode", "elasticity", str),
            method=sol.value("method", "cg", str),
            gamma_scheme=sol.value("gamma_scheme", "auto", str),
            tol=sol.value("tol", 1e-4),
            tol_red=sol.value("tol_red", SolverOptions.tol_red),
            abs_tol=sol.value("abs_tol", SolverOptions.abs_tol),
            bc_tol=sol.value("bc_tol", 1e-3),
            step_mode=sol.value("step_mode", False, bool),
            maxiter=sol.value("maxiter", 10000, int),
            update_ref=sol.value("update_ref", "loadstep", str),
            ref_scale=sol.value("ref_scale", 1.0),
            newton_relax=sol.value("newton_relax", 1.0),
            newton_tangent=sol.value("newton_tangent", "exact", str),
            basic_relax=sol.value("basic_relax", 1.0),
            bc_relax=sol.value("bc_relax", 1.0),
            cg_inner_product=sol.value("cg_inner_product", "l2", str),
            cg_reinit=sol.value("cg_reinit", 0, int),
            nl_cg_beta_scheme=sol.value("nl_cg_beta_scheme", "polak_ribiere",
                                        str),
            nl_cg_c=sol.value("nl_cg_c", 0.5),
            nl_cg_tau=sol.value("nl_cg_tau", 0.5),
            nl_cg_alpha=sol.value("nl_cg_alpha", 1.0),
            error_estimator=sol.value("error_estimator", "epsilon", str),
            outer_error_estimator=sol.value("outer_error_estimator",
                                            "epsilon", str),
            first_loadstep=sol.value("first_loadstep", -1, int),
            loadstep_extrapolation_order=sol.value(
                "loadstep_extrapolation_order", 0, int),
            loadstep_extrapolation_method=sol.value(
                "loadstep_extrapolation_method", "polynomial", str),
            max_loadstep_splits=sol.value("max_loadstep_splits", 8, int),
            print_mean=sol.value("print_mean", False, bool),
            print_detF=sol.value("print_detF", False, bool),
            g0_solver=sol.value("G0_solver", "fft", str),
            freq_hack=sol.value("freq_hack", False, bool),
            check_every=sol.value("check_every", 1, int),
            sharding_fallback=sol.value("sharding_fallback", "error", str),
            batch_load_cases=sol.value("batch_load_cases", "auto", str),
            refine=sol.value("refine", "auto", str),
            refine_max_sweeps=sol.value("refine_max_sweeps", 10, int),
            refine_inner_tol=sol.value("refine_inner_tol", 1e-5),
            dtype=self._dtype_str(),
        )
        opt.loadsteps = max(1, sol.value("loadsteps", 1, int))
        self._smooth_levels = sol.value("smooth_levels", -1, int)
        if sol.value("write_loadsteps", False, bool):
            _not_ported("write_loadsteps (the per-loadstep VTK files)", _IO)

        # materials (fibergen.cpp:15182-15305)
        mode = opt.mode
        phases: List[Phase] = []
        matrix_set = False
        ref_mu = ref_lambda = None
        mats = sol.child("materials")
        if mats.elem is None:
            raise FGError("No materials specified")
        for m in mats.children():
            name = m.tag
            r = SettingsReader(self.engine, m)
            if name in ("ref", "reference"):
                c = self._read_constants(r)
                ref_mu, ref_lambda = c["mu"], c["lam"]
                continue
            law = self._make_law(mode, r.attr("law", "iso", str), r)
            if name == "matrix" or r.attr("matrix", 0, int):
                if matrix_set:
                    raise FGError("Matrix material already specified")
                matrix_set = True
                self._matrix_material = len(phases)
            self._material_index[name] = len(phases)
            phases.append(Phase(name, law, None))
        if not phases:
            raise FGError("No materials specified")
        if not matrix_set:
            self._matrix_material = 0
            LOG.warn(f"selecting '{phases[0].name}' as matrix material")
        if ref_mu is not None:
            opt.ref_mu, opt.ref_lambda = ref_mu, ref_lambda
            opt.update_ref = "never"

        material = make_mixed(sol.value("mixing_rule", "voigt", str), phases,
                              dim=MODE_DIM[mode])
        if opt.resolved_scheme() in ("half_staggered", "full_staggered"):
            material = DfgMaterial(material)   # phases on the fine grid
        try:
            self.solver = LSSolver(grid, material, opt, device=self.device)
        except ValueError as e:     # an option's value off its list
            raise FGError(str(e)) from None
        # cancel() ends the solve at its next convergence test, and the
        # loadstep callback then ends the run (the reference cancels
        # through set_exception from the callbacks, fibergen.cpp:25190)
        self.set_convergence_callback(self._convergence_callback)
        self.set_loadstep_callback(self._loadstep_callback)

    def _read_constants(self, r: SettingsReader) -> dict:
        kw = {}
        for c in ("K", "E", "lambda", "mu", "nu", "M"):
            if r.has_attr(c):
                kw[c] = r.attr(c, None, float)
        return convert.elastic_constants(**kw)

    def _make_law(self, mode, law_name, r: SettingsReader):
        """The material law of a <materials> entry, by mode
        (fibergen.cpp:15211-15294)."""
        if mode == "elasticity":
            if law_name == "iso":
                c = self._read_constants(r)
                return laws.LinearIsotropic(mu=c["mu"], lam=c["lam"])
            if law_name == "general":
                C = np.zeros((6, 6))
                for i in range(6):
                    for j in range(6):
                        C[i, j] = r.attr(f"c{i+1}{j+1}", 0.0, float) or 0.0
                return laws.LinearGeneral(C=C)
            if law_name == "tiso":
                a = np.array([r.attr("ax", 0.0, float),
                              r.attr("ay", 0.0, float),
                              r.attr("az", 0.0, float)])
                return laws.LinearTransverselyIsotropic(
                    E=r.attr("E", None, float), nu=r.attr("nu", None, float),
                    E_a=r.attr("E_a", None, float),
                    G_a=r.attr("G_a", None, float),
                    nu_a=r.attr("nu_a", None, float),
                    a=a if np.linalg.norm(a) != 0 else None)
        elif mode in ("heat", "porous"):
            if law_name == "iso":
                return laws.ScalarLinearIsotropic(mu=r.attr("mu", 1.0, float),
                                                  dim=3)
            if law_name == "aniso":
                K = np.zeros((3, 3))
                for i in range(3):
                    for j in range(3):
                        K[i, j] = r.attr(f"c{i+1}{j+1}",
                                         1.0 if i == j else 0.0, float)
                return laws.MatrixLinearAnisotropic(K=K)
        elif mode == "viscosity":
            if law_name == "iso":
                # the dual quantity: the law's fluidity is half the
                # project's mu (fibergen.cpp:15237)
                return laws.ScalarLinearIsotropic(
                    mu=0.5 * r.attr("mu", 1.0, float), dim=6)
        elif mode == "hyperelasticity":
            if law_name in laws.GOLDBERG_LAWS:
                cls = laws.GOLDBERG_LAWS[law_name]
                return cls(**{f.name: r.attr(f.name, None, float)
                              for f in dataclasses.fields(cls)
                              if r.has_attr(f.name)})
            c = self._read_constants(r)
            if law_name in ("iso", "sv", "svk"):
                return laws.SaintVenantKirchhoff(mu=c["mu"], lam=c["lam"])
            if law_name == "nh":
                return laws.NeoHooke(mu=c["mu"], lam=c["lam"])
            if law_name == "nh2":
                return laws.NeoHooke2(mu=c["mu"], K=c["K"])
        raise FGError(f"Unknown material law '{law_name}' for mode '{mode}'")

    # ------------------------------------------------------------ geometry
    def init_gen(self):
        """Create the fibre generator from the top-level settings
        (FiberGenerator::readSettings)."""
        if self.gen is not None:
            return
        s = self._settings()
        gs = GeneratorSettings(
            fiber_type=s.value("type", "capsule", str) or "capsule",
            length=s.value("length", 0.1),
            radius=s.value("radius", 0.01),
            target_volume=s.value("v", 0.0) or 0.0,
            target_count=s.value("n", 0, int) or 0,
            max_iter=s.value("m", 10000, int),
            dmin=s.value("dmin", 0.0),
            intersecting=s.value("intersecting", False, bool),
            seed=s.value("seed", 0, int),
            x0=(s.value("x0", 0.0), s.value("y0", 0.0), s.value("z0", 0.0)),
            dims=(s.value("dx", 1.0), s.value("dy", 1.0), s.value("dz", 1.0)),
        )
        per = s.child("periodic")
        if per.elem is not None:
            base = self.engine.get(per.text("1") or "1", bool)
            gs.periodic_x = per.attr("x", base, bool)
            gs.periodic_y = per.attr("y", base, bool)
            gs.periodic_z = per.attr("z", base, bool)
            gs.periodic_fast = per.attr("fast", False, bool)
        pl = s.child("planar")
        if pl.elem is not None:
            gs.planar_x = pl.attr("x", False, bool)
            gs.planar_y = pl.attr("y", False, bool)
            gs.planar_z = pl.attr("z", False, bool)
            # a planar direction is not periodic
            gs.periodic_x = gs.periodic_x and not gs.planar_x
            gs.periodic_y = gs.periodic_y and not gs.planar_y
            gs.periodic_z = gs.periodic_z and not gs.planar_z
        self.gen = FiberGenerator(gs)

    def init_fibers(self):
        """Generate the random geometry if the settings set a target
        (FG::init_fibers, fibergen.cpp:25019)."""
        self.init_gen()
        if self._fibers_initialized:
            return
        self._fibers_initialized = True
        gs = self.gen.s
        if (gs.target_count or gs.target_volume) and not self.gen.fibers:
            self.gen.run()

    def init_phase(self):
        """Voxelize the geometry into the phases' fields on the solver's
        device (FG::init_phase -> initPhi, fibergen.cpp:25026, 17489), and
        give the interface rules their normals and the tiso laws without
        an axis their orientation field.  ``phase_time`` holds its
        seconds, the generation of the fibres excluded."""
        if self._phases_initialized:
            return
        self.init_lss()
        self.init_fibers()
        dtype, device = self.solver.dtype, self.solver.device
        # <smooth_levels>: interface refinement levels of the composite
        # voxels (integratePhiVoxel's recursion depth,
        # fibergen.cpp:16622-16760); -1, the default, is one level
        sl = self._smooth_levels
        ss = 2 if sl < 0 else max(1, 2 ** min(sl, 3))
        phase_grid = self.solver.grid
        if isinstance(self.solver.mat, DfgMaterial):
            phase_grid = fine_grid(phase_grid)  # initFullStageredRawPhases
        t0 = time.perf_counter()
        with timer("phase initialization", log=True):
            phis = discretize.voxelize(
                phase_grid, self.gen.all_fibers(),
                n_materials=len(self.solver.mat.phases),
                matrix_material=self._matrix_material, supersample=ss,
                dtype=dtype, device=device)
            _sync(device)
        for p, phi in zip(self.solver.mat.phases, phis):
            p.phi = phi
        tiso = [p for p in self.solver.mat.phases
                if isinstance(p.law, laws.LinearTransverselyIsotropic)
                and p.law.a is None]
        if hasattr(self.solver.mat, "normals") or tiso:
            gfields = self._geometry_fields(phase_grid)
            if hasattr(self.solver.mat, "normals"):
                self.solver.mat.normals = gfields["normals"]
            for p in tiso:
                p.law.orientation = gfields["orientation"]
        self.phase_time = time.perf_counter() - t0
        self._phases_initialized = True

    def _geometry_fields(self, grid):
        """:func:`discretize.geometry_fields` in the solver's dtype on its
        device, kept for the fibre list it was made from: the fibres are
        not changed once placed (every action makes new Fiber objects), so
        the identities of the list's fibres key it."""
        self.init_lss()
        self.init_fibers()
        fibers = self.gen.all_fibers()
        dtype, device = self.solver.dtype, self.solver.device
        key = (grid.shape, (grid.dx, grid.dy, grid.dz), tuple(grid.x0),
               dtype, device, tuple(id(f) for f in fibers))
        if self._gfields_cache is not None and self._gfields_cache[0] == key:
            return self._gfields_cache[1]
        t0 = time.perf_counter()
        with timer("geometry fields"):
            gf = discretize.geometry_fields(grid, fibers, dtype=dtype,
                                            device=device)
            _sync(device)
        self.geometry_time = time.perf_counter() - t0
        self._gfields_cache = (key, gf)
        return gf

    # ------------------------------------------------------------------ run
    def run(self, path: str = "actions") -> int:
        """Run the actions list (FG::run, fibergen.cpp:25195-25295);
        returns 0 on success."""
        self._error = False
        self._cancel = False
        try:
            self._init_python()
            pp = self._settings().value("print_precision", None, int)
            if pp is not None:
                np.set_printoptions(precision=pp)
            elem = self.project.root.find(path) if path else None
            if elem is None:
                raise FGError(f"No <{path}> section in project")
            if self.run_actions(elem) and self._cancel:
                self._error = True      # canceled mid-run
        except Exception as e:  # noqa: BLE001 - reported, then raised
            LOG.error(f"{type(e).__name__}: {e}")
            self._error = True
            raise
        return 1 if self._error else 0

    def run_actions(self, elem) -> int:
        """Interpret an action list (run_actions,
        fibergen.cpp:25297-26489)."""
        for action in elem:
            if not isinstance(action.tag, str):
                continue                # a comment
            if self._cancel:
                LOG.info("run canceled")
                return 1
            r = SettingsReader(self.engine, action)
            if r.attr("skip", 0, int):
                continue
            with timer(f"action {action.tag}"):
                ret = self._dispatch_action(action.tag, action, r)
            if ret:
                return ret
        return 0

    def _dispatch_action(self, name, action, r: SettingsReader) -> int:
        if name.startswith("group-"):
            return self.run_actions(action)
        if name in NOT_PORTED:
            _not_ported(f"the {name} action", NOT_PORTED[name])
        handler = getattr(self, "_action_" + name, None)
        if handler is None:
            raise FGError(f"Unknown action '{name}'")
        return handler(action, r) or 0

    # ------------------------------------------------------ geometry actions
    def _action_python(self, action, r):
        if action.text and action.text.strip():
            self.engine.exec_code(action.text)

    def _action_select_material(self, action, r):
        self.init_gen()
        self.init_lss()
        name = r.attr("name", "", str)
        if name not in self._material_index:
            raise FGError(f"Unknown material '{name}'")
        self.gen.select_material(self._material_index[name], name)

    def _action_place_fiber(self, action, r):
        """place_fiber (fibergen.cpp:25788-25822): a capsule (a sphere at
        L = 0), a cylinder or a half space; ``V`` sets the radius from the
        volume."""
        self.init_gen()
        s = self._settings()
        dx, dy, dz = s.value("dx", 1.0), s.value("dy", 1.0), s.value("dz", 1.0)
        typ = r.attr("type", "", str) or self.gen.s.fiber_type or "capsule"
        L = r.attr("L", 0.0, float)
        R = r.attr("R", 0.25 * dx, float)
        V = r.attr("V", -1.0, float)
        c = np.array([r.attr("cx", 0.5 * dx, float),
                      r.attr("cy", 0.5 * dy, float),
                      r.attr("cz", 0.5 * dz, float)])
        a = np.array([r.attr("ax", 1.0, float), r.attr("ay", 0.0, float),
                      r.attr("az", 0.0, float)])
        a = a / np.linalg.norm(a)
        if V > 0:
            # radius from the volume (capsule: pi R^2 L + 4/3 pi R^3)
            if typ == "cylinder":
                R = np.sqrt(V / (np.pi * max(L, 1e-30)))
            elif L == 0:
                R = (3 * V / (4 * np.pi)) ** (1 / 3)
            else:
                R = float(np.roots([4 / 3 * np.pi, np.pi * L, 0, -V])[-1].real)
        if typ == "halfspace":
            f = HalfSpace(point=c, normal=a)
        elif typ == "cylinder":
            f = Cylinder(center=c, axis=a, length=L, radius=R)
        else:
            f = Capsule(center=c, axis=a, length=L, radius=R)
        self.gen.add_fiber(f)
        self._phases_initialized = False

    def _read_distribution_list(self, action) -> distmod.Distribution:
        parts = []
        for d in action:
            if not isinstance(d.tag, str):
                continue
            r = SettingsReader(self.engine, d)
            w = r.attr("weight", 1.0, float)
            if d.tag == "dirac":
                val = np.array([r.attr("x", 0.0, float),
                                r.attr("y", 0.0, float),
                                r.attr("z", 0.0, float)])
                if np.linalg.norm(val) == 0:
                    val = np.array([r.attr("value", 0.0, float)])
                p = distmod.Dirac(val, weight=w)
            elif d.tag == "uniform":
                if r.has_attr("a") or r.has_attr("b"):
                    p = distmod.UniformInterval(r.attr("a", 0.0, float),
                                                r.attr("b", 1.0, float),
                                                weight=w)
                else:
                    p = distmod.UniformSphere(weight=w)
            elif d.tag == "normal":
                if r.has_attr("mu"):
                    p = distmod.NormalScalar(r.attr("mu", 0.0, float),
                                             r.attr("sigma", 1.0, float),
                                             weight=w)
                else:
                    p = distmod.NormalSphere(
                        np.array([r.attr("x", 0.0, float),
                                  r.attr("y", 0.0, float),
                                  r.attr("z", 0.0, float)]),
                        r.attr("sigma", 1.0, float), weight=w)
            elif d.tag == "acg":
                g = lambda k, v=0.0: r.attr(k, v, float)
                A = np.array([[g("axx", 1 / 3), g("axy"), g("axz")],
                              [g("axy"), g("ayy", 1 / 3), g("ayz")],
                              [g("axz"), g("ayz"), g("azz", 1 / 3)]])
                p = distmod.ACG(A=A, weight=w)
            elif d.tag == "list":
                vecs = []
                for v in d:
                    rv = SettingsReader(self.engine, v)
                    vecs.append([rv.attr("x", 0.0, float),
                                 rv.attr("y", 0.0, float),
                                 rv.attr("z", 0.0, float)])
                p = distmod.ListDistribution(np.asarray(vecs), weight=w)
            elif d.tag == "composite":
                p = self._read_distribution_list(d)
                p.weight = w
            else:
                raise FGError(f"Unknown distribution '{d.tag}'")
            parts.append(p)
        if len(parts) == 1:
            return parts[0]
        return distmod.Composite(parts)

    def _action_set_fiber_distribution(self, action, r):
        self.init_gen()
        self.gen.orientation_distribution = self._read_distribution_list(
            action)

    _action_set_orientation_distribution = _action_set_fiber_distribution

    def _action_set_length_distribution(self, action, r):
        self.init_gen()
        self.gen.length_distribution = self._read_distribution_list(action)

    def _action_set_radius_distribution(self, action, r):
        self.init_gen()
        self.gen.radius_distribution = self._read_distribution_list(action)

    def _action_generate_fibers(self, action, r):
        self.init_gen()
        im = r.attr("intersecting_materials", "", str)
        im_ids = None
        if im:
            self.init_lss()
            im_ids = {self._material_index[name.strip()]
                      for name in im.split(",") if name.strip()}
        self.gen.run(V=r.attr("v", 0.0, float) or 0.0,
                     N=r.attr("n", 0, int) or 0,
                     M=r.attr("m", 0, int) or 0,
                     dmin=r.attr("dmin", None, float),
                     intersecting=r.attr("intersecting", None, bool),
                     intersecting_materials=im_ids)
        self._fibers_initialized = True
        self._phases_initialized = False

    def _action_init_fibers(self, action, r):
        self.init_fibers()

    def _action_init_phase(self, action, r):
        # the normals / orientations attributes compute the geometry
        # fields ahead of the phases (fibergen.cpp:25575-25583)
        if r.attr("normals", False, bool) or r.attr("orientations", False,
                                                     bool):
            self.init_lss()
            self._geometry_fields(self.solver.grid)
        self.init_phase()

    # --------------------------------------------------------- solve actions
    def _action_run_load_case(self, action, r):
        """run_load_case (fibergen.cpp:25919-26028)."""
        if r.attr("outfile", "", str):
            _not_ported("run_load_case's outfile (the VTK solution file)",
                        _IO)
        self.init_lss()
        self.init_phase()
        lss = self.solver
        dim = lss.dim
        E = np.zeros(dim)
        S = np.zeros(dim)
        # e1..e3 and the Voigt names e11, e23, ... (read_voigt_vector,
        # fibergen.cpp:1126-1137)
        names = ["11", "22", "33", "23", "13", "12", "32", "31", "21"][:dim]
        for k in range(min(3, dim)):
            if r.has_attr(f"e{k+1}"):
                E[k] = r.attr(f"e{k+1}", 0.0, float)
            if r.has_attr(f"s{k+1}"):
                S[k] = r.attr(f"s{k+1}", 0.0, float)
        for k, nm in enumerate(names):
            if r.has_attr("e" + nm):
                E[k] = r.attr("e" + nm, 0.0, float)
            if r.has_attr("s" + nm):
                S[k] = r.attr("s" + nm, 0.0, float)
        # the projector: 1-based p{i}{j}, symmetric (read_matrix,
        # fibergen.cpp:1101-1119)
        P = voigtmod.id4(dim)
        for i in range(dim):
            for j in range(dim):
                if r.has_attr(f"p{i+1}{j+1}"):
                    P[i, j] = P[j, i] = r.attr(f"p{i+1}{j+1}", 0.0, float)
        if lss.mode == "hyperelasticity":
            E = E + voigtmod.dyad4_mv(P, voigtmod.identity_vec(9))
        if lss.mode == "viscosity":
            tol = 100 * np.finfo(np.float64).eps
            if abs(E[0] + E[1] + E[2]) > tol:
                raise FGError("Prescribed fluid stress has non-zero trace")
            if abs(S[0] + S[1] + S[2]) > tol:
                raise FGError("Prescribed fluid strain has non-zero trace")
        lss.set_bc_projector(P)
        lss.set_strain(E)
        lss.set_stress(S)
        if lss.run():
            self._error = True
            return 1
        return 0

    def _solve_load_cases(self, Es):
        """The (B, dim) mean stresses of B pure-strain load cases (the rows
        of ``Es``), or None when a solve fails.  One batched CG
        (LSSolver.run_batched) takes them all where the solver qualifies
        and the batch's ~4 fields stay under 8e9 bytes (the JAX package's
        gate); else they run one after the other (the reference's loop,
        fibergen.cpp:26044-26066)."""
        lss = self.solver
        Es = np.asarray(Es, dtype=np.float64)
        B = Es.shape[0]
        deep_tol = (lss.opt.refine != "off" and lss.dtype == torch.float32
                    and (lss.opt.refine == "on" or lss.opt.tol < 3e-7))
        batch_ok = (lss.opt.batch_load_cases != "off"
                    and lss.opt.method == "cg"
                    and lss.mode != "hyperelasticity"
                    and int(lss.opt.loadsteps) <= 1 and not deep_tol)
        if batch_ok:
            itemsize = torch.empty((), dtype=lss.dtype).element_size()
            batch_ok = (4 * B * lss.dim * float(np.prod(lss.grid.shape))
                        * itemsize) < 8e9
        if batch_ok:
            lss.set_bc_projector(voigtmod.id4(lss.dim))
            lss.set_strain(Es[-1])
            lss.set_stress(np.zeros(lss.dim))
            if lss.run_batched(Es):
                return None
            return lss.calc_mean_stress_batched()
        Sb = np.zeros((B, lss.dim))
        for i in range(B):
            lss.set_bc_projector(voigtmod.id4(lss.dim))
            lss.set_strain(Es[i])
            lss.set_stress(np.zeros(lss.dim))
            if lss.run():
                return None
            Sb[i] = lss.calc_mean_stress()
        return Sb

    def _action_calc_effective_properties(self, action, r):
        """calc_effective_properties (fibergen.cpp:26030-26403)."""
        if r.attr("outdir", "", str):
            _not_ported("calc_effective_properties' outdir (the VTK "
                        "solution files)", _IO)
        self.init_lss()
        self.init_phase()
        mode = self.solver.mode
        if mode == "viscosity":
            return self._effective_viscosity()
        if mode not in ("elasticity", "heat", "porous"):
            raise FGError(
                f"calc_effective_properties not implemented for '{mode}'")
        Sb = self._solve_load_cases(np.eye(self.solver.dim))
        if Sb is None:
            self._error = True
            return 1
        C = Sb.T                        # columns: the load cases, E = I
        if mode != "elasticity":
            self._Ceff = C
            what = "conductivity" if mode == "heat" else "permeability"
            LOG.info(f"Effective {what} matrix:\n{C}")
            return 0
        Cv = C.copy()
        Cv[:, 3:6] *= 0.5
        self._Ceff = Cv
        LOG.info(f"Effective stiffness matrix (Voigt notation):\n{Cv}")
        # isotropic least-squares fit (fibergen.cpp:26092-26113)
        S1, S2 = C[0:3, 0:3].sum(), np.trace(C)
        lam_eff = (2 * S1 - S2) / 15.0
        mu_eff = (3 * S2 - S1) / 30.0
        Cfit = np.zeros((6, 6))
        Cfit[0:3, 0:3] = lam_eff
        np.fill_diagonal(Cfit[0:3, 0:3], lam_eff + 2 * mu_eff)
        Cfit[3, 3] = Cfit[4, 4] = Cfit[5, 5] = 2 * mu_eff
        LOG.info(f"  K_eff      = {lam_eff + 2.0 / 3.0 * mu_eff:g}")
        LOG.info(f"  mu_eff     = {mu_eff:g}")
        LOG.info(f"  lambda_eff = {lam_eff:g}")
        LOG.info(f"  relative error of fit = "
                 f"{np.linalg.norm(C - Cfit) / np.linalg.norm(C):g}")
        return 0

    def _effective_viscosity(self):
        """The five traceless cases, the fluidity inversion and the
        Nunan-Keller alpha and beta (fibergen.cpp:26252-26399)."""
        Sb = self._solve_load_cases(VISCOSITY_CASES)
        if Sb is None:
            self._error = True
            return 1
        law = self.solver.mat.phases[self._matrix_material].law
        ev = effective_viscosity(Sb, law.mu)
        LOG.info(f'Effective fluidity matrix "0.5*f" (5x5):\n'
                 f'{np.linalg.inv(ev.C55)}')
        LOG.info(f'Effective viscosity matrix "2*eta" (5x5):\n{ev.C55}')
        LOG.info(f'Effective viscosity matrix "2*eta" (Voigt notation):\n'
                 f'{ev.C}')
        self._Ceff = ev.C
        self._nunan_keller = (ev.alpha, ev.beta)
        LOG.info(f"alpha mean: {ev.alpha:g} (std {ev.alpha_std:g})")
        LOG.info(f"beta mean: {ev.beta:g} (std {ev.beta_std:g})")
        return 0

    def _action_calc_isotropic_laminate(self, action, r):
        """The closed-form laminate of isotropic materials
        (calc_isotropic_laminate, Milton Eq. 9.9,
        fibergen.cpp:26405-26474)."""
        mats = []
        for m in action:
            if not isinstance(m.tag, str):
                continue
            rm = SettingsReader(self.engine, m)
            c = self._read_constants(rm)
            mats.append((c["mu"], c["lam"], rm.attr("phi", 0.0, float)))
        self._Ceff = isotropic_laminate_stiffness(mats)
        LOG.info(f"Laminate stiffness matrix (Voigt notation):\n{self._Ceff}")

    def _action_calc_HS_bounds(self, action, r):
        mu1, mu2 = r.attr("mu1", 1.0, float), r.attr("mu2", 1.0, float)
        lam1 = r.attr("lambda1", 0.0, float)
        lam2 = r.attr("lambda2", 0.0, float)
        self.init_lss()
        self.init_phase()
        phis = [float(p.phi.mean()) for p in self.solver.mat.phases]
        kl, mul, ku, muu = convert.hashin_shtrikman_bounds(
            mu1, lam1, phis[0], mu2, lam2,
            phis[1] if len(phis) > 1 else 1 - phis[0])
        self._hs_bounds = (kl, mul, ku, muu)
        LOG.info(f"HS lower bounds: K={kl:g} mu={mul:g}")
        LOG.info(f"HS upper bounds: K={ku:g} mu={muu:g}")

    def _action_inv_ellint_rd(self, action, r):
        """Tabulate the Carlson R_D moment inversion along a line
        (inv_ellint_rd, fibergen.cpp:25659)."""
        nt = r.attr("nt", 100, int)
        with open(r.attr("filename", "rd_inversion.txt", str), "w") as fp:
            fp.write("# a1 a2 a3 b1 b2 b3\n")
            for i in range(nt):
                t = (i + 0.5) / nt
                a = np.array([t, (1 - t) / 2, (1 - t) / 2])
                b = distmod.acg_b_from_moments(a)
                fp.write(" ".join(f"{v:.12g}" for v in [*a, *b]) + "\n")

    def _action_print_A2(self, action, r):
        self.init_fibers()
        LOG.info(f"A2 =\n{self.gen.get_A2()}")

    def _action_print_timings(self, action, r):
        LOG.info(TIMINGS.report())

    def _action_exit(self, action, r):
        raise SystemExit(r.attr("code", 0, int))

    def _action_tune_num_threads(self, action, r):
        LOG.info("tune_num_threads: no-op (the device runs its own "
                 "parallelism)")

    def write_vtk_solution(self, path: str):
        _not_ported("the VTK solution file", _IO)

    # ---------------------------------------------------------------- getters
    def get_phase_names(self) -> List[str]:
        self.init_lss()
        return [p.name for p in self.solver.mat.phases]

    def get_volume_fraction(self, name: str) -> float:
        self.init_phase()
        return float(self.solver.mat.phases[self._material_index[name]]
                     .phi.mean())

    def get_real_volume_fraction(self, name: str) -> float:
        self.init_fibers()
        return self.gen.volume_fraction(self._material_index[name])

    def get_solve_time(self) -> float:
        return self.solver.solve_time if self.solver else 0.0

    def get_fft_time(self) -> float:
        _not_ported("get_fft_time", f"{_FRONT}: the FFT time")

    def get_distance_evals(self) -> int:
        """Fibre-distance evaluations of the voxelizer since this FG was
        made or reset (get_distance_evals, fibergen.cpp:25087 + 27168):
        one per primitive per (supersampled) voxel."""
        return int(discretize.DIST_EVALS) - self._dist_evals0

    def get_residuals(self) -> List[float]:
        return list(self.solver.residuals) if self.solver else []

    def get_effective_property(self):
        return None if self._Ceff is None else self._Ceff.tolist()

    def get_rve_dims(self):
        s = self._settings()
        return (s.value("x0", 0.0), s.value("y0", 0.0), s.value("z0", 0.0),
                s.value("dx", 1.0), s.value("dy", 1.0), s.value("dz", 1.0))

    def get_A2(self):
        self.init_fibers()
        return self.gen.get_A2().tolist()

    def get_A4(self):
        self.init_fibers()
        return self.gen.get_A4().tolist()

    def get_B_from_A(self, A):
        A = np.asarray(A, dtype=np.float64)
        evals, evecs = np.linalg.eigh(A / np.trace(A))
        b = distmod.acg_b_from_moments(evals)
        return (evecs @ np.diag(b) @ evecs.T).tolist()

    def get_error(self) -> bool:
        return self._error

    def get_mean_stress(self):
        return self.solver.calc_mean_stress().tolist()

    def get_mean_strain(self):
        return self.solver.calc_mean_strain().tolist()

    def get_mean_cauchy_stress(self):
        return self.solver.calc_mean_cauchy().tolist()

    def get_mean_energy(self):
        return self.solver.calc_mean_energy()

    def get_field(self, name: str) -> np.ndarray:
        """A solution or geometry field as a numpy array with a leading
        component axis (GetField, fibergen.cpp:27179 + get_raw_field,
        15396-15695)."""
        lss = self.solver
        host = lambda t: t.detach().cpu().numpy()
        if name == "epsilon":
            return host(lss.eps)
        if name == "sigma":
            return host(lss.mat.pk1(lss.eps))
        if name == "phi":
            return np.stack([host(p.phi) for p in lss.mat.phases])
        if name in self._material_index:
            return host(lss.mat.phases[self._material_index[name]].phi)[None]
        if name in ("u", "p"):
            _not_ported(f"the field '{name}' (displacement, velocity and "
                        f"pressure recovery)", _FRONT)
        if name in ("orientation", "normals", "distance", "fiber_id",
                    "material_id", "fiber_translation"):
            arr = host(self._geometry_fields(lss.grid)[name])
            return arr if arr.ndim == 4 else arr[None]
        raise FGError(f"Unknown field '{name}'")

    # ---------------------------------------------------------------- control
    def cancel(self):
        """Request cancellation: the running solve ends at its next
        convergence test, the remaining actions are skipped and run()
        returns nonzero (PyFG cancel via set_exception,
        fibergen.cpp:25190)."""
        self._cancel = True

    def set_convergence_callback(self, func):
        """A callback at every convergence test; the solve ends when it
        returns true, or once cancel() was called, whenever the callback
        was set."""
        self._convergence_callback = func
        if self.solver:
            self.solver.convergence_callback = (
                lambda: self._cancel or bool(func and func()))

    def set_loadstep_callback(self, func):
        """A callback after each loadstep; the run ends (and fails) when it
        returns true, or once cancel() was called."""
        self._loadstep_callback = func
        if self.solver:
            self.solver.loadstep_callback = (
                lambda: self._cancel or bool(func and func()))


def isotropic_laminate_stiffness(mats) -> np.ndarray:
    """The closed-form stiffness of a layered laminate of isotropic phases
    with layer normal e_x (calc_isotropic_laminate / Milton, The Theory of
    Composites Eq. 9.9; fibergen.cpp:26405-26474).  ``mats``: a list of
    (mu, lambda, phi).  Returns the 6x6 Voigt matrix."""

    def avg(f):
        return sum(p * f(mu, lam) for mu, lam, p in mats)

    c1 = avg(lambda mu, lam: 1.0 / (lam + 2 * mu))
    c2 = avg(lambda mu, lam: 1.0 / mu)
    c3 = avg(lambda mu, lam: mu)
    c4 = avg(lambda mu, lam: lam / (lam + 2 * mu))
    c5 = avg(lambda mu, lam: 4 * mu * (lam + mu) / (lam + 2 * mu))
    c6 = avg(lambda mu, lam: 2 * mu * lam / (lam + 2 * mu))
    C = np.zeros((6, 6))
    C[0, 0] = 1.0 / c1                       # C1111
    C[1, 1] = C[2, 2] = c5 + c4 * c4 / c1    # C2222 = C3333
    C[3, 3] = c3                             # C2323
    C[4, 4] = C[5, 5] = 1.0 / c2             # C1313 = C1212
    C[0, 1] = C[1, 0] = C[0, 2] = C[2, 0] = c4 / c1   # C1122 = C1133
    C[1, 2] = C[2, 1] = c6 + c4 * c4 / c1    # C2233
    return C
