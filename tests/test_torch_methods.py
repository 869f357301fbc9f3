"""The port's remaining linear methods and Gamma schemes against the JAX
package, in float64 on the CPU (the port's plain path):

* nesterov in every linear mode on both grids, CG with ``cg_reinit`` and
  the sigma and energy estimators, iteration for iteration;
* Willot's Gamma (elasticity and the viscosity Delta operator) and the
  collocated Gamma under ``freq_hack`` applied to a random tau, and CG and
  polarization solves with them;
* the two places where the JAX package leaves the Lippmann-Schwinger
  solution, and the port does not: basic+el's direction update and the
  dropped + tau of polarization in viscosity (each held to the port's own
  CG, the JAX package only shown to be off);
* the one-voxel-thick cell against the JAX package's 2-D pipeline
  (``use_dim2="auto"``), the options' refusals, the x-slab solves of the
  new methods, and FG projects that pick nesterov and willot.

The residual and the estimators' histories agree to 1e-9 relative (1e-14
absolute for the estimators that subtract two norms or means), the mean
stresses to 1e-10 of their size.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

import fibergen_tpu as fg
import fibergen_tpu_torch as ft
from fibergen_tpu.core.grid import Grid as JGrid
from fibergen_tpu.ops import gamma as jgamma
from fibergen_tpu.ops import green as jgreen
from fibergen_tpu.utils.logging import LOG as JLOG
from fibergen_tpu_torch import parallel
from fibergen_tpu_torch.ops import gamma, green
from fibergen_tpu_torch.solvers.ls import SolverError
from fibergen_tpu_torch.utils.logging import LOG

import _torch_demos as demos

torch.set_num_threads(2)

SHAPE, CELL = (9, 7, 5), (1.2, 0.8, 1.0)
# mode -> (dim, load, law, (inclusion, matrix) moduli): the bench's sphere
# with mu 10/1 and lambda 5/1 in elasticity, fluidities 0.1/1 in viscosity
MODES = {
    "elasticity": (6, [1.0, 0, 0, 0, 0, 0], "isotropic",
                   ((10.0, 5.0), (1.0, 1.0))),
    "heat": (3, [1.0, 0, 0], "scalar", ((10.0,), (1.0,))),
    "porous": (3, [0.0, 0.3, 1.0], "scalar", ((10.0,), (1.0,))),
    "viscosity": (6, [0, 0, 0, 0, 1.0, 0], "scalar", ((0.1,), (1.0,))),
}


@pytest.fixture(autouse=True)
def _quiet():
    old = (JLOG.enabled, LOG.enabled)
    JLOG.enabled = LOG.enabled = False
    yield
    JLOG.enabled, LOG.enabled = old


def _sphere(shape):
    ax = [(np.arange(s) + 0.5) / s - 0.5 for s in shape]
    X, Y, Z = np.meshgrid(*ax, indexing="ij")
    return ((X * X + Y * Y + Z * Z) < 0.09).astype(np.float64)


def _jax_law(law, dim, moduli):
    if law == "isotropic":
        return fg.LinearIsotropic(*moduli)
    return fg.ScalarLinearIsotropic(moduli[0], dim=dim)


def _solvers(mode, shape=SHAPE, cell=CELL, **opt):
    """(JAX solver, port solver) of the mode's sphere problem, loaded."""
    dim, load, law, (mi, mm) = MODES[mode]
    phi = _sphere(shape)
    jmat = fg.VoigtMixed([
        fg.Phase("i", _jax_law(law, dim, mi), jnp.asarray(phi)),
        fg.Phase("m", _jax_law(law, dim, mm), jnp.asarray(1.0 - phi))],
        dim=dim)
    pmat = ft.convert.material_from_numpy(
        [("i", *mi, phi), ("m", *mm, 1.0 - phi)], dim=dim, law=law,
        device="cpu")
    o = dict(mode=mode, dtype="float64", **opt)
    kw = dict(dx=cell[0], dy=cell[1], dz=cell[2])
    js = fg.LSSolver(fg.Grid(*shape, **kw), jmat, fg.SolverOptions(**o))
    ps = ft.LSSolver(ft.Grid(*shape, **kw), pmat, ft.SolverOptions(**o),
                     device="cpu")
    js.set_strain(load)
    ps.set_strain(load)
    return js, ps


def _k(mode):
    return 4 if mode == "viscosity" else 0


def _same_solve(js, ps, atol=0.0):
    """Both solves converge with the same reference material, the same
    number of iterations, histories within 1e-9 relative (``atol``
    absolute) and mean stresses within 1e-10 of their size."""
    assert not js.run() and not ps.run()
    assert ps.mu_0 == js.mu_0
    rj, rp = np.asarray(js.residuals), np.asarray(ps.residuals)
    assert len(rp) == len(rj) < ps.opt.maxiter
    np.testing.assert_allclose(rp, rj, rtol=1e-9, atol=atol)
    S_ref = np.asarray(js.calc_mean_stress())
    np.testing.assert_allclose(ps.calc_mean_stress(), S_ref, rtol=0,
                               atol=1e-10 * np.max(np.abs(S_ref)))


def _mean(s):
    return float(s.calc_mean_stress()[_k(s.mode)])


def _port(mode, **opt):
    return _solvers(mode, **opt)[1]


# ------------------------------------------------------------- methods
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("scheme", ["staggered", "collocated"])
def test_nesterov_matches_jax(mode, scheme):
    js, ps = _solvers(mode, method="nesterov", gamma_scheme=scheme,
                      error_estimator="epsilon", tol=1e-6, maxiter=500)
    _same_solve(js, ps, atol=1e-14)


@pytest.mark.parametrize("mode,scheme", [
    ("elasticity", "staggered"), ("elasticity", "collocated"),
    ("viscosity", "staggered"), ("heat", "staggered")])
def test_cg_reinit_matches_jax(mode, scheme):
    """The exact residual every fifth iteration, on the K1 route in
    staggered elasticity and viscosity (K1 init, K3, K2 no-dot) and on
    the generic operators; the JAX package reinitializes on its
    one-iteration loop (check_every 1) only, so it runs that.  The exact
    residual is formed afresh from eps, its rounding a fixed 1e-16 or so
    of the first residual: the histories agree to 1e-9 relative or 1e-15
    absolute."""
    js, ps = _solvers(mode, gamma_scheme=scheme, cg_reinit=5,
                      error_estimator="residual", tol=1e-10, maxiter=500)
    _same_solve(js, ps, atol=1e-15)


def test_cg_reinit_falls_on_the_same_iterations_in_chunks():
    """The port's chunked loop reinitializes after the same step numbers
    as its one-iteration loop: the histories are the same."""
    runs = []
    for K in (1, 4):
        ps = _port("elasticity", cg_reinit=3, check_every=K,
                   error_estimator="residual", tol=1e-10, maxiter=500)
        assert not ps.run()
        runs.append(np.asarray(ps.residuals))
    n = len(runs[0])
    assert len(runs[1]) >= n
    np.testing.assert_allclose(runs[1][:n], runs[0], rtol=1e-12, atol=0)


@pytest.mark.parametrize("estimator", ["sigma", "energy"])
@pytest.mark.parametrize("mode,scheme", [
    ("elasticity", "staggered"), ("viscosity", "collocated"),
    ("heat", "staggered")])
def test_stress_and_energy_estimators_match_jax(estimator, mode, scheme):
    """The mean stress or energy after each step, against the JAX
    package's one-iteration loop (its chunked loop keeps the field of the
    chunk after the one that converged); the port's chunks of four read
    the same history."""
    js, ps = _solvers(mode, gamma_scheme=scheme, error_estimator=estimator,
                      tol=1e-8, maxiter=500)
    _same_solve(js, ps, atol=1e-14)
    p4 = _port(mode, gamma_scheme=scheme, error_estimator=estimator,
               check_every=4, tol=1e-8, maxiter=500)
    assert not p4.run()
    np.testing.assert_allclose(p4.residuals[:len(ps.residuals)],
                               ps.residuals, rtol=1e-12, atol=0)


# ------------------------------------------------ the two JAX defects
@pytest.mark.parametrize("mode,scheme", [
    ("elasticity", "staggered"), ("elasticity", "collocated"),
    ("viscosity", "staggered")])
def test_basic_el_reaches_its_cg_solution(mode, scheme):
    """basic+el takes the exact line step along the residual and ends at
    the CG solution; the JAX package's direction update (-Gamma (C - C0)
    d, right for alpha = 1 only) agrees at the first iteration and departs
    from the second on, ending off the solution."""
    _, cg = _solvers(mode, gamma_scheme=scheme,
                     error_estimator="residual", tol=1e-12, maxiter=500)
    js, ps = _solvers(mode, gamma_scheme=scheme, method="basic+el",
                      tol=1e-10, maxiter=3000)
    assert not cg.run() and not ps.run() and not js.run()
    ref = _mean(cg)
    assert abs(_mean(ps) - ref) <= 1e-6 * abs(ref)
    off = 5e-2 if mode == "elasticity" else 3e-3
    assert abs(_mean(js) - ref) >= off * abs(ref)
    assert js.residuals[0] == pytest.approx(ps.residuals[0], rel=1e-12)
    assert abs(js.residuals[1] - ps.residuals[1]) > 1e-3 * ps.residuals[1]


def test_basic_el_under_mixed_bcs_reaches_cg():
    """With a uniaxial projector and zero prescribed stress the line step
    minimizes the energy less the prescribed stress's work; basic+el ends
    at the mixed-BC CG solution."""
    P = np.zeros((6, 6))
    P[0, 0] = 1.0
    out = []
    for method, est in (("cg", "residual"), ("basic+el", "epsilon")):
        ps = _port("elasticity", method=method, error_estimator=est,
                   tol=1e-10, maxiter=3000)
        ps.set_bc_projector(P)
        ps.set_stress(np.zeros(6))
        assert not ps.run()
        out.append((ps.calc_mean_stress(), ps.calc_mean_strain()))
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=0, atol=1e-7)
    np.testing.assert_allclose(out[1][1], out[0][1], rtol=0, atol=1e-7)


def test_polarization_in_viscosity_reaches_collocated_cg():
    """Eyre-Milton in the Delta scheme keeps the + tau of its step (K6's
    beta 2 alpha mu0v + 1) and ends at the collocated CG solution; the
    JAX package drops it and ends far off."""
    _, cg = _solvers("viscosity", gamma_scheme="collocated",
                     error_estimator="residual", tol=1e-12, maxiter=500)
    js, ps = _solvers("viscosity", method="polarization", tol=1e-10,
                      maxiter=3000)
    assert not cg.run() and not ps.run() and not js.run()
    assert ps.scheme == "collocated"
    ref = _mean(cg)
    assert abs(_mean(ps) - ref) <= 1e-6 * abs(ref)
    assert abs(_mean(js) - ref) >= 0.1 * abs(ref)


# ------------------------------------------------ Willot and freq_hack
OP_GRIDS = [((9, 7, 5), (1.0, 1.0, 1.0)), ((9, 7, 5), (1.2, 0.8, 1.0)),
            ((8, 6, 4), (1.2, 0.8, 1.0))]


def _op_grids(shape, cell):
    kw = dict(dx=cell[0], dy=cell[1], dz=cell[2])
    return ft.Grid(*shape, **kw), JGrid(*shape, **kw)


def _rel(a, ref):
    a, ref = np.asarray(a), np.asarray(ref)
    return np.max(np.abs(a - ref)) / np.max(np.abs(ref))


@pytest.mark.parametrize("shape,cell", OP_GRIDS)
def test_willot_and_freq_hack_operators_match_jax(shape, cell):
    pg, jg = _op_grids(shape, cell)
    rng = np.random.default_rng(7)
    tau = rng.standard_normal((6,) + shape)
    E = rng.standard_normal(6)
    tt, tj = torch.as_tensor(tau), jnp.asarray(tau)
    for lam in (0.3, 0.0, float("inf")):
        ref = jgamma.gamma_operator(jg, "elasticity", "willot", None, E, 1.7,
                                    lam, tj, -1.0, 0.4)
        out = gamma.gamma_willot(pg, E, 1.7, lam, tt, -1.0, 0.4)
        assert _rel(out.numpy(), ref) <= 1e-12
    ref = jgamma.gamma_operator(jg, "viscosity", "willot", None, E, 1.7, 0.0,
                                tj, -1.0)
    assert _rel(gamma.delta_willot(pg, E, 1.7, tt, -1.0).numpy(), ref) \
        <= 1e-12
    ref = jgreen.gamma_collocated_fused(jg, E, 1.7, 0.3, tj, -1.0, 0.4,
                                        freq_hack=True)
    out = green.gamma_collocated_fused(pg, E, 1.7, 0.3, tt, -1.0, 0.4,
                                       freq_hack=True)
    assert _rel(out.numpy(), ref) <= 1e-12
    if shape[0] % 2 == 0:
        # the symmetrization changes the Nyquist bins of an even grid
        plain = green.gamma_collocated_fused(pg, E, 1.7, 0.3, tt, -1.0, 0.4)
        assert _rel(plain.numpy(), ref) > 1e-6


@pytest.mark.parametrize("case", ["elasticity", "viscosity", "mixed_bc",
                                  "polarization", "alias"])
def test_willot_solves_match_jax(case):
    mode = "viscosity" if case == "viscosity" else "elasticity"
    opt = dict(gamma_scheme="Willot_R" if case == "alias" else "willot",
               error_estimator="residual", tol=1e-10, maxiter=500)
    if case == "polarization":
        opt.update(method="polarization", error_estimator="epsilon",
                   tol=1e-8)
    js, ps = _solvers(mode, **opt)
    assert js.scheme == ps.scheme == "willot"
    if case == "mixed_bc":
        P = np.zeros((6, 6))
        P[0, 0] = 1.0
        for s in (js, ps):
            s.set_bc_projector(P)
            s.set_stress(np.zeros(6))
    # the solves end at the rounding floor (1e-15 of the first residual),
    # where the two FFT libraries' rounding differs in absolute terms
    _same_solve(js, ps, atol=1e-14 if case == "polarization" else 1e-15)


@pytest.mark.parametrize("method", ["cg", "polarization"])
def test_freq_hack_solves_match_jax(method):
    js, ps = _solvers("elasticity", shape=(8, 6, 4), method=method,
                      gamma_scheme="collocated", freq_hack=True,
                      error_estimator="residual" if method == "cg"
                      else "epsilon", tol=1e-10 if method == "cg" else 1e-8,
                      maxiter=500)
    _same_solve(js, ps, atol=0.0 if method == "cg" else 1e-14)


# ------------------------------------------------- one voxel thick
@pytest.mark.parametrize("mode,scheme", [
    ("heat", "staggered"), ("elasticity", "staggered"),
    ("elasticity", "collocated")])
def test_one_voxel_thick_cell_matches_the_jax_2d_pipeline(mode, scheme):
    """use_dim2 picks one of the JAX package's TPU programs; the port's
    3-D operators on nz = 1 give the 2-D pipeline's answer."""
    js, ps = _solvers(mode, shape=(15, 13, 1), cell=(1.2, 0.8, 1.0),
                      gamma_scheme=scheme, error_estimator="residual",
                      tol=1e-10, maxiter=500)
    assert js._dim2_capable
    _same_solve(js, ps)
    assert js._dim2_last


# ------------------------------------------------------ options
def test_option_refusals_and_aliases():
    assert ft.SolverOptions(gamma_scheme="Willot-R").resolved_scheme() \
        == "willot"
    phi = np.ones((4, 4, 4))
    scal = ft.convert.material_from_numpy([("a", 1.0, phi)], dim=3,
                                          law="scalar", device="cpu")
    svk = ft.convert.material_from_numpy([("a", 1.0, 1.0, phi)], dim=9,
                                         law="svk", device="cpu")
    iso = ft.convert.material_from_numpy([("a", 1.0, 1.0, phi)],
                                         device="cpu")
    g = ft.Grid(4, 4, 4)
    for mat, mode in ((scal, "heat"), (scal, "porous"),
                      (svk, "hyperelasticity")):
        with pytest.raises(ValueError, match="Unknown gamma scheme 'willot'"):
            ft.LSSolver(g, mat, ft.SolverOptions(mode=mode,
                                                 gamma_scheme="willot"),
                        device="cpu")
    with pytest.raises(SolverError, match="nl_cg requires hyperelasticity"):
        ft.LSSolver(g, iso, ft.SolverOptions(method="nl_cg"), device="cpu")
    with pytest.raises(ValueError, match="nl_cg_beta_scheme"):
        ft.LSSolver(g, svk, ft.SolverOptions(
            mode="hyperelasticity", method="nl_cg",
            nl_cg_beta_scheme="newton"), device="cpu")
    # Willot and freq_hack take the slabs (test_torch_parallel_paths.py
    # solves them)
    mesh = parallel.make_mesh(["cpu"] * 2)
    for kw in (dict(gamma_scheme="willot"),
               dict(gamma_scheme="collocated", freq_hack=True)):
        s = ft.LSSolver(g, iso, ft.SolverOptions(**kw),
                        sharding=parallel.field_sharding(mesh))
        assert s.par is not None


@pytest.mark.parametrize("kw", [
    dict(method="nesterov", error_estimator="epsilon", tol=1e-6),
    dict(method="basic+el", tol=1e-6),
    dict(cg_reinit=4, error_estimator="sigma", tol=1e-8)],
    ids=["nesterov", "basic_el", "cg_reinit_sigma"])
def test_new_methods_on_slabs_match_the_unsharded_solve(kw):
    """The x-slab solve (two slabs of the CPU) takes the same iterations
    and ends at the same mean stress.  The reductions add the slabs'
    partial sums, in another order than the whole field's, and basic+el's
    step length carries that rounding from one iteration to the next:
    histories agree to 1e-7 relative."""
    out = []
    for sharding in (None, parallel.field_sharding(
            parallel.make_mesh(["cpu"] * 2))):
        mat = ft.convert.material_from_numpy(
            [("i", 10.0, 5.0, _sphere((8, 6, 5))),
             ("m", 1.0, 1.0, 1.0 - _sphere((8, 6, 5)))], device="cpu")
        s = ft.LSSolver(ft.Grid(8, 6, 5), mat, ft.SolverOptions(
            maxiter=500, **kw), device="cpu", sharding=sharding)
        s.set_strain(MODES["elasticity"][1])
        assert not s.run()
        out.append((np.asarray(s.residuals), s.calc_mean_stress()))
    assert len(out[0][0]) == len(out[1][0])
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-7, atol=1e-14)
    np.testing.assert_allclose(out[1][1], out[0][1], rtol=1e-12, atol=1e-14)


# ------------------------------------------------------ front end
@pytest.mark.parametrize("setting", [("solver.method", "nesterov"),
                                     ("solver.gamma_scheme", "willot")])
def test_fg_project_with_the_new_method_or_scheme_matches_jax(setting):
    """The hashin project at n = 16 with <method>nesterov</method> or
    <gamma_scheme>willot</gamma_scheme> through both front ends."""
    out = []
    for F, kw in ((fg.FG, {}), (ft.FG, dict(device="cpu"))):
        f = demos.load(F, "hashin", **kw)
        f.set(*setting)
        f.set("solver.tol", 1e-6)
        assert f.run() == 0
        out.append(np.asarray(f.get_mean_stress(), dtype=np.float64))
    assert demos.rel(out[1], out[0]) <= 1e-10
