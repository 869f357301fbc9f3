"""The port's FG front end against the JAX package's, on the CPU in float64.

* Demo projects (tests/_torch_demos.py: hashin at 16, the laminate, heat
  with n = 10 and porous flow with 20 stones at 32, the primitives at 16):
  the same iterations, residual histories within 1e-8 relative or 1e-14
  absolute, the phase
  fields within 1e-12, the mean stress and the effective property within
  1e-10 relative.  On the nz = 1 demos (heat, porous) the JAX package runs
  its 2-D pipeline and the port the 3-D operators; they are held to the
  same bounds.  The port's batched load cases against its sequential ones
  within the solve's tolerance, and the test_demos.py oracles on the
  port.  The JAX package's get_field gives its geometry fields in float32
  whatever the project's datatype; they are compared as the solver's
  dtype computes them (FG._geometry_fields).
* The project API (set, get, erase, variables and <python> blocks, the
  getters, get_field), both callbacks and cancel, the XML's TPU-only knobs,
  datatype float, the memos after a geometry change, the CLI, and every
  action or field not ported yet raising NotImplementedError.
"""
import os

import numpy as np
import pytest

import torch

import fibergen_tpu as fg
import fibergen_tpu_torch as ft
from fibergen_tpu.utils.logging import LOG as JLOG
from fibergen_tpu_torch import cli
from fibergen_tpu_torch.api import NOT_PORTED, FGError
from fibergen_tpu_torch.solvers.ls import SolverError
from fibergen_tpu_torch.utils.logging import LOG

import _torch_demos as demos

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _quiet():
    old = (JLOG.enabled, LOG.enabled)
    JLOG.enabled = LOG.enabled = False
    yield
    JLOG.enabled, LOG.enabled = old


SMALL = """<settings>
  <variables><res type="int" value="9" /></variables>
  <python>r_inc = 0.1 + 0.2</python>
  <solver n="res" nz="7">
    <tol>1e-10</tol>
    <materials>
      <matrix mu="1" lambda="1" />
      <inc mu="5" lambda="2" />
    </materials>
  </solver>
  <actions>
    <select_material name="inc" />
    <place_fiber R="r_inc" L="0.3" ax="1" ay="1" />
    <run_load_case e11="1" e23="0.2" />
  </actions>
</settings>"""


def _small(F, **kw):
    f = F(**kw)
    f.set_xml(SMALL)
    return f


def _port(**kw):
    return _small(ft.FG, device="cpu", **kw)


# ------------------------------------------------------------ the demos
@pytest.mark.parametrize("name", ["hashin", "laminate", "heat", "porous"])
def test_demo_matches_jax(name):
    a, b = demos.check_pair(name)
    assert a.solver.mode == b.solver.mode
    assert bool(getattr(a.solver, "_dim2_logged", False)) == (
        name in demos.DIM2)


def test_demo_primitives_matches_jax():
    """No solve: the phases and every geometry field of the capsule, the
    cylinder and the sphere."""
    a, b = demos.check_pair("primitives")
    demos.check_geometry(a, b)
    assert set(np.unique(b.get_field("fiber_id"))) == {1, 2, 3}


@pytest.mark.parametrize("name", ["heat", "porous"])
def test_batched_load_cases_match_sequential(name):
    f = demos.load(ft.FG, name, sequential=False, device="cpu")
    assert f.run() == 0
    _, b = demos.pair(name)
    # the batch stops when its last case converges: the others within the
    # solver's tolerance of their own stops
    assert demos.rel(f.get_effective_property(),
                     b.get_effective_property()) <= f.solver.opt.tol
    assert f.solver.opt.batch_load_cases == "auto"
    assert f.solver.eps_batch.shape[0] == 3


def test_demo_hashin_oracle():
    f = demos.load(ft.FG, "hashin", device="cpu")
    f.set("variables.res..value", 32)
    assert f.run() == 0
    k_eff = np.array(f.get_mean_stress())[:3].sum() / 9.0
    k_star = 3.63867684478 + 2.0 / 3.0
    assert abs(k_eff - k_star) / k_star < 2e-3


def test_demo_laminate_oracle():
    _, f = demos.pair("laminate")
    np.testing.assert_allclose(
        f.get_effective_property(),
        ft.isotropic_laminate_stiffness([(1, 1, 0.5), (5, 2, 0.5)]),
        atol=1e-12)
    np.testing.assert_array_equal(
        ft.isotropic_laminate_stiffness([(1, 1, 0.3), (5, 2, 0.7)]),
        fg.isotropic_laminate_stiffness([(1, 1, 0.3), (5, 2, 0.7)]))


def test_demo_heat_and_porous_oracles():
    K = np.array(demos.pair("heat")[1].get_effective_property())
    assert np.all(np.diag(K)[:2] > 1.0) and np.all(np.diag(K) < 10.0)
    K = np.array(demos.pair("porous")[1].get_effective_property())
    assert np.all(np.diag(K)[:2] > 0) and np.all(np.diag(K)[:2] < 1.0)


# ---------------------------------------------------------- the project API
def test_set_get_erase_and_python_blocks():
    b, a = _port(), _small(fg.FG)
    for f in (a, b):
        f.set("solver.tol", 1e-9)
        f.set("solver.materials.inc", mu=7, **{"lambda": 3})
        f.set("actions.place_fiber..cx", 0.4)
        f.erase("solver.materials.inc..mu")
        f.set_variable("extra", 2.5)
        f.set("python", "r_inc = 0.25 * extra / 2.5")
    for p in ("solver.tol", "solver.materials.inc..lambda",
              "solver.materials.inc..mu", "actions.place_fiber..cx",
              "variables.res..value"):
        assert b.get(p) == a.get(p), p
    assert b.get("solver.materials.inc..lambda") == "3"
    assert b.get_xml() == a.get_xml()
    b.set("solver.materials.inc..mu", 7)
    a.set("solver.materials.inc..mu", 7)
    assert a.run() == 0 and b.run() == 0
    assert b.get_variable("r_inc") == a.get_variable("r_inc") == 0.25
    assert b.get_variable("fg") is b
    assert demos.rel(b.get_mean_stress(), a.get_mean_stress()) <= 1e-10
    assert len(b.get_residuals()) == len(a.get_residuals())


def test_getters_match_jax():
    a, b = _small(fg.FG), _port()
    assert a.run() == 0 and b.run() == 0
    assert b.get_phase_names() == a.get_phase_names() == ["matrix", "inc"]
    for name in ("matrix", "inc"):
        assert abs(b.get_volume_fraction(name)
                   - a.get_volume_fraction(name)) < 1e-14
        assert b.get_real_volume_fraction(name) == \
            a.get_real_volume_fraction(name)
    assert b.get_rve_dims() == a.get_rve_dims()
    np.testing.assert_array_equal(b.get_A2(), a.get_A2())
    np.testing.assert_array_equal(b.get_A4(), a.get_A4())
    A = [[0.5, 0.1, 0], [0.1, 0.3, 0], [0, 0, 0.2]]
    np.testing.assert_allclose(b.get_B_from_A(A), a.get_B_from_A(A),
                               rtol=0, atol=1e-14)
    assert b.get_error() is a.get_error() is False
    assert b.get_distance_evals() == a.get_distance_evals() > 0
    assert b.get_solve_time() > 0
    for g in ("get_mean_stress", "get_mean_strain", "get_mean_cauchy_stress"):
        assert demos.rel(getattr(b, g)(), getattr(a, g)()) <= 1e-10, g
    assert abs(b.get_mean_energy() - float(a.get_mean_energy())) <= \
        1e-10 * abs(float(a.get_mean_energy()))
    np.testing.assert_allclose(b.get_residuals(), a.get_residuals(),
                               rtol=1e-8, atol=1e-14)
    for k in ("epsilon", "sigma", "phi", "inc"):
        want = np.asarray(a.get_field(k))
        got = b.get_field(k)
        assert got.shape == want.shape, k
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-10 * np.abs(want).max(), err_msg=k)
    demos.check_geometry(a, b)
    with pytest.raises(FGError, match="Unknown field"):
        b.get_field("nope")


def test_host_actions_match_jax(tmp_path, monkeypatch):
    """calc_HS_bounds, calc_isotropic_laminate, inv_ellint_rd, print_A2,
    print_timings and tune_num_threads through both front ends."""
    xml = SMALL.replace("<run_load_case e11=\"1\" e23=\"0.2\" />", """
    <calc_HS_bounds mu1="1" lambda1="1" mu2="5" lambda2="2" />
    <calc_isotropic_laminate>
      <a mu="1" lambda="1" phi="0.3" /><b E="3" nu="0.2" phi="0.7" />
    </calc_isotropic_laminate>
    <inv_ellint_rd nt="7" filename="rd.txt" />
    <print_A2 /><print_timings /><tune_num_threads />""")
    out = {}
    for F, kw in ((fg.FG, {}), (ft.FG, {"device": "cpu"})):
        d = tmp_path / F.__module__.split(".")[0]
        d.mkdir()
        monkeypatch.chdir(d)
        f = F(**kw)
        f.set_xml(xml)
        assert f.run() == 0
        out[F] = (f._hs_bounds, f.get_effective_property(),
                  (d / "rd.txt").read_text())
    (ha, Ca, ra), (hb, Cb, rb) = out[fg.FG], out[ft.FG]
    np.testing.assert_allclose(hb, ha, rtol=1e-14)
    np.testing.assert_array_equal(Cb, Ca)
    assert rb == ra


def test_exit_action_raises_system_exit():
    f = _port()
    f.set("actions.exit..code", 3)
    with pytest.raises(SystemExit) as e:
        f.run()
    assert e.value.code == 3


def test_convergence_callback_ends_the_solve():
    a, b = _small(fg.FG), _port()
    calls = {a: 0, b: 0}
    for f in (a, b):
        def cb(f=f):
            calls[f] += 1
            return calls[f] == 3
        f.set_convergence_callback(cb)
        assert f.run() == 0
    assert calls[b] == calls[a] == 3
    assert len(b.get_residuals()) == len(a.get_residuals()) == 3


def test_loadstep_callback_breaks_the_run():
    xml = SMALL.replace("<tol>", "<loadsteps>3</loadsteps><tol>")
    seen = []
    f = ft.FG(device="cpu")
    f.set_xml(xml)
    f.set_loadstep_callback(lambda: seen.append(1) or len(seen) == 2)
    assert f.run() == 1 and f.get_error()
    assert len(seen) == 2
    j = fg.FG()
    j.set_xml(xml)
    seen_j = []
    j.set_loadstep_callback(lambda: seen_j.append(1) or len(seen_j) == 2)
    assert j.run() == 1 and len(seen_j) == 2


@pytest.mark.parametrize("late", [False, True])
def test_cancel_from_a_callback_fails_the_run(late):
    """cancel() ends the solve at the next convergence test and run()
    returns 1, whether the callback was set before the solver existed or
    after; a new run() clears the request."""
    f = _port()
    if late:
        assert f.run() == 0
    calls = [0]

    def cb():
        calls[0] += 1
        if calls[0] == 2:
            f.cancel()
        return False

    f.set_convergence_callback(cb)
    assert f.run() == 1 and f.get_error()
    assert calls[0] == 2
    f.set_convergence_callback(None)
    assert f.run() == 0


def test_solver_cancel_returns_true():
    f = _port()
    f._init_python()
    f.init_phase()
    s = f.solver
    s.set_strain([1, 0, 0, 0, 0, 0])
    s.convergence_callback = lambda: s.cancel() or False
    assert s.run() is True
    assert len(s.residuals) == 1
    s.convergence_callback = None
    assert s.run() is False


def test_solve_before_the_phases_is_refused():
    f = _port()
    f._init_python()
    f.init_lss()
    assert all(p.phi is None for p in f.solver.mat.phases)
    with pytest.raises(SolverError, match="init_phase"):
        f.solver.run()
    with pytest.raises(SolverError, match="init_phase"):
        f.solver.run_batched(np.eye(6))


def test_geometry_change_renews_the_memos():
    """A fibre placed after a solve: the phases, the reference material and
    the geometry fields follow it, as in the JAX package."""
    xml = SMALL.replace("<materials>", "<mixing_rule>laminate</mixing_rule>"
                        "<materials>").replace("</actions>", """</actions>
  <more>
    <place_fiber R="0.15" cx="0.2" cy="0.8" />
    <run_load_case e11="1" />
  </more>""")
    res = []
    # the laminate's normals (the JAX package's get_field takes its
    # geometry fields in float32)
    normals = lambda f: np.asarray(f.solver.mat.normals)
    for F, kw in ((fg.FG, {}), (ft.FG, {"device": "cpu"})):
        f = F(**kw)
        f.set_xml(xml)
        assert f.run() == 0
        n1, mu1 = normals(f), f.solver.mu_0
        assert f.run("more") == 0
        res.append((n1, mu1, normals(f), f.solver.mu_0, f.get_mean_stress(),
                    f.get_field("phi")))
    (n1a, m1a, n2a, m2a, Sa, pa), (n1b, m1b, n2b, m2b, Sb, pb) = res
    assert not np.allclose(n1b, n2b)
    np.testing.assert_allclose(n2b, n2a, rtol=0, atol=1e-12)
    np.testing.assert_allclose(pb, pa, rtol=0, atol=1e-12)
    assert abs(m1b - m1a) <= 1e-12 * m1a and abs(m2b - m2a) <= 1e-12 * m2a
    assert demos.rel(Sb, Sa) <= 1e-10


def test_datatype_float_is_float32():
    f = _port()
    f.set("datatype", "float")
    f.set("solver.tol", 1e-5)
    assert f.run() == 0
    assert f.solver.dtype == torch.float32
    assert all(p.phi.dtype == torch.float32 for p in f.solver.mat.phases)
    g = _port()
    assert g.run() == 0 and g.solver.dtype == torch.float64
    # the float32 solve stops at 1e-5
    assert demos.rel(f.get_mean_stress(), g.get_mean_stress()) < 1e-4


@pytest.mark.parametrize("knob,value", [
    ("use_pallas", "on"), ("use_sweep", "off"), ("adaptive_drain", "on"),
    ("low_mem", "on"), ("use_dim2", "off"), ("fft_backend", "matmul"),
    ("batch_load_cases", "off")])
def test_tpu_knobs_are_accepted(knob, value):
    f = _port()
    f.set(f"solver.{knob}", value)
    assert f.run() == 0
    g, j = _port(), _small(fg.FG)
    g.set(f"solver.{knob}", "bogus")
    j.set(f"solver.{knob}", "bogus")
    with pytest.raises(FGError, match=f"Unknown {knob}") as e:
        g.run()
    with pytest.raises(fg.api.FGError) as ej:
        j.run()
    assert str(e.value) == str(ej.value)


def test_batch_load_cases_off_is_an_option():
    mat = ft.convert.material_from_numpy([("a", 1.0, 1.0, np.ones((3, 3, 3)))],
                                         device="cpu")
    s = ft.LSSolver(ft.Grid(3, 3, 3), mat, ft.SolverOptions(
        batch_load_cases="off"), device="cpu")
    assert s.opt.batch_load_cases == "off"


def test_fg_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ft.FG()
    assert ft.FG(device="cpu").device.type == "cpu"


def test_cli_runs_a_project(tmp_path, capsys):
    p = tmp_path / "project.xml"
    p.write_text(SMALL)
    assert cli.main([str(p), "--device", "cpu"]) == 0
    q = tmp_path / "bad.xml"
    q.write_text(SMALL.replace('value="9"', 'value="3*3"'))
    with pytest.raises(ValueError, match="disabled"):
        cli.main([str(q), "--device", "cpu", "--disable-python"])
    assert cli.main([]) == 1


@pytest.mark.parametrize("action", sorted(NOT_PORTED))
def test_unported_actions_raise(action):
    f = _port()
    f.set(f"actions.{action}..filename", "x")
    with pytest.raises(NotImplementedError, match="ROADMAP.md, Queue 1"):
        f.run()


@pytest.mark.parametrize("what", ["u", "p", "fft_time", "outfile", "outdir",
                                  "write_loadsteps", "write_vtk_solution"])
def test_unported_fields_and_outputs_raise(what, tmp_path):
    f = _port()
    if what == "outfile":
        f.set("actions.run_load_case..outfile", str(tmp_path / "r.vtk"))
    elif what == "outdir":
        f.set("actions.calc_effective_properties..outdir", str(tmp_path))
    elif what == "write_loadsteps":
        f.set("solver.write_loadsteps", 1)
    if what in ("outfile", "outdir", "write_loadsteps"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            f.run()
        return
    assert f.run() == 0
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        if what == "fft_time":
            f.get_fft_time()
        elif what == "write_vtk_solution":
            f.write_vtk_solution(str(tmp_path / "s.vtk"))
        else:
            f.get_field(what)


def test_unknown_action_and_law_raise():
    f = _port()
    f.set("actions.frobnicate", "")
    with pytest.raises(FGError, match="Unknown action"):
        f.run()
    g = _port()
    g.set("solver.materials.inc..law", "weird")
    with pytest.raises(FGError, match="Unknown material law"):
        g.run()


def test_reset_unloads_the_project():
    f = _port()
    assert f.run() == 0
    f.reset()
    assert f.solver is None and f.gen is None
    with pytest.raises(FGError, match="No <actions>"):
        f.run()


def test_demo_empty_runs():
    f = ft.FG(os.path.join(demos.DEMO_DIR, "empty", "project.xml"),
              device="cpu")
    assert f.run() == 0 and f.solver is None


def test_doubly_fine_phases_keep_the_origin():
    """full_staggered with the cell moved by x0, y0: the fine phases are
    voxelized at the moved coordinates, as in the JAX package (the port's
    fine grid once dropped the origin)."""
    res = []
    for F, kw in ((fg.FG, {}), (ft.FG, {"device": "cpu"})):
        f = demos.load(F, "nunan_keller", **kw)
        f.set("solver..n", 8)
        f.set("x0", 0.3)
        f.set("y0", -0.2)
        f.set("actions.calc_effective_properties..skip", 1)
        f.set("actions.init_phase", "")
        assert f.run() == 0
        res.append(np.asarray(f.get_field("phi")))
    np.testing.assert_allclose(res[1], res[0], rtol=0, atol=1e-12)
    assert res[1].shape == (2, 16, 16, 16) and 0.1 < res[1][1].mean() < 0.3
