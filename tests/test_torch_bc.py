"""The port's mixed boundary conditions and linear loadstep loop against the
JAX package, in float64 on the CPU (the port's plain path):

* the projector's matrices (``make_bc_projector``) for the identity, zero,
  uniaxial and a random symmetric idempotent P, and its refusals;
* mixed-BC solves (CG and basic in elasticity, heat and porous flow on
  both grids and in collocated viscosity; polarization in elasticity, heat
  and porous flow), iteration for iteration, with their boundary
  condition error; the incompatible-BC refusals and the mixed paths not
  ported yet;
* the linear loadstep loop with polynomial (orders 0-2) and transformation
  extrapolation, step for step, and the extrapolation functions alone.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

import fibergen_tpu as fg
import fibergen_tpu_torch as ft
from fibergen_tpu.materials import laws as jlaws
from fibergen_tpu.solvers import bc as jbc
from fibergen_tpu.solvers import ls as jls
from fibergen_tpu.utils.logging import LOG as JLOG
from fibergen_tpu_torch import parallel
from fibergen_tpu_torch.core import voigt
from fibergen_tpu_torch.solvers import bc, ls
from fibergen_tpu_torch.utils.logging import LOG

torch.set_num_threads(2)

SHAPE, CELL = (9, 7, 5), (1.2, 0.8, 1.0)


@pytest.fixture(autouse=True)
def _quiet():
    old = (JLOG.enabled, LOG.enabled)
    JLOG.enabled = LOG.enabled = False
    yield
    JLOG.enabled, LOG.enabled = old


def _random_projector(dim, rank, seed):
    """A symmetric P with P:P = P under the dyad4 shear doubling: P =
    W^-1/2 U U^T W^-1/2 for orthonormal columns U, W the Voigt weights."""
    rng = np.random.default_rng(seed)
    U, _ = np.linalg.qr(rng.standard_normal((dim, rank)))
    s = 1.0 / np.sqrt(voigt.weights(dim))
    return (s[:, None] * U) @ (U.T * s[None, :])


def _uniaxial(dim, k=0):
    P = np.zeros((dim, dim))
    P[k, k] = 1.0
    return P


PROJECTORS = {
    "identity": lambda d: voigt.id4(d),
    "zero": lambda d: np.zeros((d, d)),
    "uniaxial": _uniaxial,
    "random": lambda d: _random_projector(d, 2, 7),
}


@pytest.mark.parametrize("name", list(PROJECTORS))
@pytest.mark.parametrize("dim", [3, 6, 9])
def test_bc_projector_matches_jax(name, dim):
    P = PROJECTORS[name](dim)
    ref = jbc.make_bc_projector(P, 1.7, 0.3, bc_relax=0.8)
    out = bc.make_bc_projector(P, 1.7, 0.3, bc_relax=0.8)
    for key in ("P", "Q", "QC0", "M", "MQ"):
        np.testing.assert_allclose(getattr(out, key), getattr(ref, key),
                                   rtol=0, atol=1e-12, err_msg=key)
    assert out.is_trivial == ref.is_trivial == (name == "identity")
    assert out.bc_relax == 0.8 and out.dim == dim
    E, S = np.linspace(0.1, 0.9, dim), np.linspace(-1.0, 1.0, dim)
    np.testing.assert_allclose(bc.calc_bc_mean(out, E, S),
                               jbc.calc_bc_mean(ref, E, S), atol=1e-12)
    F0 = np.linspace(-0.3, 0.7, dim)
    np.testing.assert_allclose(
        bc.bc_correction(out, torch.as_tensor(F0)).numpy(),
        np.asarray(jbc.bc_correction(ref, F0)), atol=1e-12)


def test_voigt_helpers_match_jax():
    from fibergen_tpu.core import voigt as jv
    rng = np.random.default_rng(3)
    for dim in (3, 6, 9):
        A, B = rng.standard_normal((dim, dim)), rng.standard_normal((dim, dim))
        a, b = rng.standard_normal(dim), rng.standard_normal(dim)
        for name in ("id4", "ii4"):
            np.testing.assert_array_equal(getattr(voigt, name)(dim),
                                          getattr(jv, name)(dim))
        np.testing.assert_array_equal(voigt.dyad4_mv(A, a), jv.dyad4_mv(A, a))
        np.testing.assert_array_equal(voigt.dyad4_mm(A, B), jv.dyad4_mm(A, B))
        assert voigt.dyad_vv(a, b) == jv.dyad_vv(a, b)
        assert voigt.norm_2(a) == jv.norm_2(a)
    M = rng.standard_normal((6, 6))
    M9 = rng.standard_normal((9, 9))
    np.testing.assert_array_equal(voigt.expand_matrix_6_to_9(M),
                                  jv.expand_matrix_6_to_9(M))
    np.testing.assert_array_equal(voigt.reduce_matrix_9_to_6(M9),
                                  jv.reduce_matrix_9_to_6(M9))


def test_bc_projector_refusals():
    """Both packages refuse a projector that is not symmetric, and one that
    is not idempotent, with the same words."""
    bad = {"not symmetric": np.triu(np.ones((6, 6))),
           "not a projector": 2.0 * voigt.id4(6)}
    for match, P in bad.items():
        for make in (bc.make_bc_projector, jbc.make_bc_projector):
            with pytest.raises(ValueError, match=match):
                make(P, 1.0, 0.0)


# ------------------------------------------------------------ the solves

def _sphere(shape):
    ax = [(np.arange(s) + 0.5) / s - 0.5 for s in shape]
    X, Y, Z = np.meshgrid(*ax, indexing="ij")
    return ((X * X + Y * Y + Z * Z) < 0.09).astype(np.float64)


# mode -> (dim, law, (fibre, matrix) moduli, P, E, S): a strain-controlled
# subspace and the stress prescribed on the rest
P6 = voigt.id4(6)
P6[4, 4] = 0.0                          # xz stress-controlled
LOADS = {
    "elasticity": (6, "isotropic", ((10.0, 5.0), (1.0, 1.0)),
                   _uniaxial(6), [0.01, 0, 0, 0, 0, 0], np.zeros(6)),
    "elasticity-stress": (6, "isotropic", ((10.0, 5.0), (1.0, 1.0)),
                          P6, [0.01, -0.002, 0, 0.003, 0, 0],
                          [0, 0, 0, 0, 0.05, 0]),
    "heat": (3, "scalar", ((10.0,), (1.0,)), _uniaxial(3),
             [1.0, 0, 0], [0, 0.5, 0]),
    "porous": (3, "scalar", ((10.0,), (1.0,)), _uniaxial(3, 2),
               [0, 0, 1.0], [0.3, 0, 0]),
    "viscosity": (6, "scalar", ((0.1,), (1.0,)), P6,
                  [0, 0, 0, 1.0, 0, 0], [0, 0, 0, 0, 0.4, 0]),
}


def _solvers(load, shape=SHAPE, cell=CELL, bcs=True, **opts):
    """The JAX solver and the port's on the same problem, both set up."""
    dim, law, moduli, P, E, S = LOADS[load]
    mode = load.split("-")[0]
    phi = _sphere(shape)
    jlaw = (lambda m: jlaws.LinearIsotropic(mu=m[0], lam=m[1], dim=dim)) \
        if law == "isotropic" else \
        (lambda m: jlaws.ScalarLinearIsotropic(mu=m[0], dim=dim))
    jmat = fg.VoigtMixed([
        fg.Phase("fiber", jlaw(moduli[0]), jnp.asarray(phi)),
        fg.Phase("matrix", jlaw(moduli[1]), jnp.asarray(1.0 - phi))], dim=dim)
    opts = dict(mode=mode, dtype="float64", maxiter=500, **opts)
    js = fg.LSSolver(fg.Grid(*shape, dx=cell[0], dy=cell[1], dz=cell[2]),
                     jmat, fg.SolverOptions(**opts))
    pmat = ft.convert.material_from_numpy(
        [("fiber", *moduli[0], phi), ("matrix", *moduli[1], 1.0 - phi)],
        dim=dim, device="cpu", law=law)
    ps = ft.LSSolver(ft.convert.grid_from_numpy(shape, cell), pmat,
                     ft.convert.options_from_dict(opts), device="cpu")
    for s in (js, ps):
        if bcs:
            s.set_bc_projector(P)
            s.set_stress(S)
        s.set_strain(E)
    return js, ps


def _same_solve(js, ps, atol=0.0):
    """The same iterations, histories within 1e-9 (``atol`` for the epsilon
    estimator's differences of norms), mean strain and stress within
    1e-10, the same boundary condition error within 1e-10."""
    assert ps.mu_0 == js.mu_0
    rj, rp = np.asarray(js.residuals), np.asarray(ps.residuals)
    assert len(rp) == len(rj)
    np.testing.assert_allclose(rp, rj, rtol=1e-9, atol=atol)
    for name in ("calc_mean_strain", "calc_mean_stress"):
        ref = np.asarray(getattr(js, name)())
        np.testing.assert_allclose(getattr(ps, name)(), ref, rtol=0,
                                   atol=1e-10 * np.max(np.abs(ref)))
    assert abs(ps.bc_error() - js.bc_error()) <= 1e-10


@pytest.mark.parametrize("load,scheme,method", [
    ("elasticity", "staggered", "cg"), ("elasticity", "collocated", "cg"),
    ("elasticity-stress", "staggered", "cg"),
    ("elasticity-stress", "collocated", "cg"),
    ("elasticity", "staggered", "basic"),
    ("elasticity", "collocated", "basic"),
    ("heat", "staggered", "cg"), ("heat", "collocated", "cg"),
    ("heat", "staggered", "basic"), ("porous", "staggered", "cg"),
    ("porous", "collocated", "cg"), ("porous", "collocated", "basic"),
    ("viscosity", "collocated", "cg"), ("viscosity", "collocated", "basic"),
    ("viscosity", "staggered", "cg"), ("viscosity", "staggered", "basic"),
    ("elasticity", "collocated", "polarization"),
    ("heat", "collocated", "polarization"),
    ("porous", "collocated", "polarization")])
def test_mixed_bc_solve_matches_jax(load, scheme, method):
    cg = method == "cg"
    js, ps = _solvers(load, method=method, gamma_scheme=scheme,
                      error_estimator="residual" if cg else "epsilon",
                      tol=1e-9 if cg else 1e-6)
    assert not js.run() and not ps.run()
    _same_solve(js, ps, atol=0.0 if cg else 1e-14)
    if method != "polarization":
        assert ps.bc_error() <= ps.opt.bc_tol
    if cg:
        assert np.max(np.abs(ps.get_field("epsilon") - np.asarray(js.eps))) \
            <= 1e-9


def test_mixed_bc_check_every_4_matches_jax():
    """check_every=4: the JAX package's pipelined loop reads each chunk one
    dispatch behind and keeps the next chunk's field; the histories agree
    entry for entry and the means, converged to 1e-10, within 1e-8."""
    js, ps = _solvers("elasticity-stress", method="cg", check_every=4,
                      error_estimator="residual", tol=1e-10)
    assert not js.run() and not ps.run()
    rj, rp = np.asarray(js.residuals), np.asarray(ps.residuals)
    assert len(rp) == len(rj)
    np.testing.assert_allclose(rp, rj, rtol=1e-9)
    ref = np.asarray(js.calc_mean_stress())
    np.testing.assert_allclose(ps.calc_mean_stress(), ref, rtol=0,
                               atol=1e-8 * np.max(np.abs(ref)))


def test_uniaxial_stress_is_met():
    """P = e_xx e_xx, S = 0: the stress-controlled mean stresses vanish
    (1e-9 of sigma_xx) and the prescribed strain is kept."""
    _, ps = _solvers("elasticity", method="cg", error_estimator="residual",
                     tol=1e-10)
    assert not ps.run()
    S = ps.calc_mean_stress()
    assert np.max(np.abs(S[1:])) <= 1e-9 * abs(S[0])
    assert ps.calc_mean_strain()[0] == pytest.approx(0.01, rel=1e-12)
    assert ps.bc_error() <= 1e-9


def test_incompatible_bcs_raise():
    """A stress in the strain-controlled subspace, or a strain in the
    stress-controlled one, raises SolverError in both packages."""
    for load, P, E, S, match in (
            ("elasticity", voigt.id4(6), [0.01, 0, 0, 0, 0, 0],
             [1.0, 0, 0, 0, 0, 0], "stress"),
            ("elasticity", np.zeros((6, 6)), [0.01, 0, 0, 0, 0, 0],
             np.zeros(6), "strain")):
        for s, err in zip(_solvers(load, bcs=False),
                          (jls.SolverError, ls.SolverError)):
            s.set_bc_projector(P)
            s.set_strain(E)
            s.set_stress(S)
            with pytest.raises(err, match=f"Incompatible {match}"):
                s.run()


@pytest.mark.parametrize("kind", ["staggered viscosity", "sharded"])
def test_unported_mixed_paths_raise(kind):
    """Mixed BCs on a sharded mesh and, in staggered viscosity, on the
    generic staggered Delta path meet the boundary condition
    (test_mixed_bc_solve_matches_jax and test_torch_parallel_paths.py hold
    them against the JAX package)."""
    phi = np.full((8, 4, 4), 0.5)
    if kind == "sharded":
        mat = ft.convert.material_from_numpy(
            [("a", 1.0, 1.0, phi), ("b", 5.0, 2.0, 1.0 - phi)], device="cpu")
        s = ft.LSSolver(ft.Grid(8, 4, 4), mat, ft.SolverOptions(
            tol=1e-6), sharding=parallel.field_sharding(
                parallel.make_mesh(["cpu"] * 2)))
        s.set_strain([0.01, 0, 0, 0, 0, 0])
    else:
        mat = ft.convert.material_from_numpy(
            [("a", 1.0, phi), ("b", 0.1, 1.0 - phi)], device="cpu",
            law="scalar")
        s = ft.LSSolver(ft.Grid(8, 4, 4), mat, ft.SolverOptions(
            mode="viscosity", tol=1e-6), device="cpu")
        s.set_strain([0, 0, 0, 1.0, 0, 0])
    s.set_bc_projector(P6)
    S = [0, 0, 0, 0, 0.4, 0] if kind != "sharded" else [0, 0, 0, 0, 0.004, 0]
    s.set_stress(S)
    assert not s.run()
    assert (s.par is not None) == (kind == "sharded")
    assert s.bc_error() <= s.opt.bc_tol
    assert abs(s.calc_mean_stress()[4] - S[4]) <= s.opt.bc_tol * S[4]
    s.set_stress(np.zeros(6))
    # the identity projector keeps the trivial path
    s.set_bc_projector(voigt.id4(6))
    assert not s.run()


# ------------------------------------------------------ loadsteps

@pytest.mark.parametrize("method,extrap,order", [
    ("cg", "polynomial", 0), ("cg", "polynomial", 1),
    ("basic", "polynomial", 0), ("basic", "polynomial", 1),
    ("basic", "polynomial", 2), ("basic", "transformation", 1)])
def test_linear_loadsteps_match_jax(method, extrap, order):
    """Four loadsteps, step for step: the histories of every loadstep
    (one list) agree entry for entry.  The basic scheme starts from the
    extrapolated field, the CG from the loadstep's mean, as in the JAX
    package.  The transformation rule inverts the strain tensor per voxel,
    so its loading keeps that tensor well away from singular, and its
    loadsteps start at t = 1/4 (the zero field of t = 0 has no inverse)."""
    poly = extrap == "polynomial"
    js, ps = _solvers("elasticity-stress" if poly else "elasticity",
                      bcs=poly, method=method,
                      error_estimator="residual" if method == "cg"
                      else "epsilon", tol=1e-9 if method == "cg" else 1e-6,
                      loadsteps=4, first_loadstep=0 if poly else 1,
                      loadstep_extrapolation_order=order,
                      loadstep_extrapolation_method=extrap)
    if extrap == "transformation":
        for s in (js, ps):
            s.set_strain([0.02, 0.015, 0.01, 0.002, 0.001, 0.0005])
    assert not js.run() and not ps.run()
    _same_solve(js, ps, atol=0.0 if method == "cg" else 1e-14)


def test_extrapolation_cuts_basic_iterations():
    """Linear solutions scale with the loadstep parameter, so first-order
    extrapolation predicts each one: the basic scheme then needs far fewer
    iterations than from the previous loadstep's field."""
    counts = []
    for order in (0, 1):
        _, ps = _solvers("elasticity", method="basic", loadsteps=4,
                         error_estimator="epsilon", tol=1e-6,
                         loadstep_extrapolation_order=order)
        assert not ps.run()
        counts.append(len(ps.residuals))
    assert counts[1] < counts[0]


@pytest.mark.parametrize("mode,names", [
    ("heat", ("temperature gradient", "heat flux")),
    ("elasticity", ("elastic strain", "average elastic stress"))])
def test_print_mean_logs_each_loadstep_with_the_modes_names(mode, names,
                                                             capsys):
    """print_mean logs the mean strain and stress after every run_solver
    call, once per loadstep, under the mode's names (the JAX package's
    _print_mean_values)."""
    _, ps = _solvers(mode, bcs=False, loadsteps=2, print_mean=True,
                     error_estimator="residual", tol=1e-9)
    calls = []
    solve = ps.run_solver
    ps.run_solver = lambda E, S: (calls.append(1), solve(E, S))
    capsys.readouterr()
    LOG.enabled = True
    assert not ps.run()
    LOG.enabled = False
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("mean ")]
    assert len(calls) == 3                  # t = 0, 1/2, 1
    assert [ln.split(" = ")[0] for ln in lines] == \
        [f"mean {names[0]}", f"mean {names[1]}"] * 3
    last = f"mean {names[1]} = {ps.calc_mean_stress()}"
    assert lines[-1] == last.splitlines()[0]


def test_extrapolate_functions_match_jax():
    """The extrapolation rules on random fields (the transformation rule
    on deformation gradients near the identity) within 1e-12."""
    rng = np.random.default_rng(11)
    shape = (9, 4, 3, 5)
    fs = [np.eye(3).reshape(9)[[0, 4, 8, 5, 2, 1, 7, 6, 3]][:, None, None,
                                                             None]
          + 0.1 * rng.standard_normal(shape) for _ in range(3)]
    ts = [0.2, 0.45, 0.7]
    for order in (1, 2):
        h = list(zip(ts[-order - 1:], fs[-order - 1:]))
        ref = np.asarray(jls._extrapolate(
            [(t, jnp.asarray(f)) for t, f in h], 0.9, "polynomial", 9))
        out = ls._extrapolate([(t, torch.as_tensor(f)) for t, f in h], 0.9,
                              "polynomial", 9).numpy()
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-12)
    for dim in (9, 6):
        h = [(t, f[:dim]) for t, f in zip(ts[1:], fs[1:])]
        ref = np.asarray(jls._extrapolate(
            [(t, jnp.asarray(f)) for t, f in h], 0.9, "transformation", dim))
        out = ls._extrapolate([(t, torch.as_tensor(f)) for t, f in h], 0.9,
                              "transformation", dim).numpy()
        assert out.shape == ref.shape == (dim,) + shape[1:]
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-12)
    with pytest.raises(ls.SolverError, match="extrapolation method"):
        ls._extrapolate([(0.0, torch.zeros(6, 2, 2, 2))] * 2, 1.0, "spline")
