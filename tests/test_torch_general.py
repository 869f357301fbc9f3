"""Solves of general linear materials against the JAX package's, in float64
on the CPU (the port's plain path; the JAX package runs its own plain path
there): a transversely isotropic fibre about a fixed axis and about a
per-voxel orientation field, and a general 6x6 fibre, each in an isotropic
matrix, by CG and basic on the staggered grid (the generic route: the plain
stress difference, div_staggered, K3's twin, eps_staggered) and on the
collocated grid; staggered elasticity under every mixing rule;
anisotropic heat and porous flow on both grids; uniaxial stress and the
batched load cases with a tiso fibre; and the refusals of the paths not
ported yet.  Each solve takes the same iterations, its residual history
agrees within 1e-9, its strain field within 1e-9 and its mean stress
within 1e-10.  The CG solves stop at 1e-8: the stiff tiso and general
fibres (moduli in the thousands) put the recursive residual's float64
rounding at about 1e-18 absolute, 1e-9 of an entry near 1e-9.
"""
import math

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import fibergen_tpu as fg
import fibergen_tpu_torch as ft
from fibergen_tpu.materials import laws as jl
from fibergen_tpu.materials import mixing as jmix
from fibergen_tpu.utils.logging import LOG as JLOG
from fibergen_tpu_torch import parallel
from fibergen_tpu_torch.utils.logging import LOG

torch.set_num_threads(2)

SHAPE, CELL = (9, 7, 5), (1.2, 0.8, 1.0)
# the tiso demo's fibre and matrix (demo/elasticity/transverse_isotropy:
# E = 910, nu = 0.3 -> mu = 350, lam = 525)
TISO = dict(E=3860.0, nu=0.2, E_a=5390.0, G_a=390.0, nu_a=0.031)
MATRIX = (350.0, 525.0)
AXIS = [1.0, 0.3, -0.2]


@pytest.fixture(autouse=True)
def _quiet():
    old = (JLOG.enabled, LOG.enabled)
    JLOG.enabled = LOG.enabled = False
    yield
    JLOG.enabled, LOG.enabled = old


def _phi(shape=SHAPE):
    """A blurred sphere: interface voxels around pure ones."""
    ax = [(np.arange(s) + 0.5) / s - 0.5 for s in shape]
    X, Y, Z = np.meshgrid(*ax, indexing="ij")
    return 1.0 / (1.0 + np.exp(-(0.09 - (X * X + Y * Y + Z * Z)) / 0.02))


def _orientation(shape=SHAPE):
    v = np.random.default_rng(0).standard_normal((3,) + shape)
    return v / np.linalg.norm(v, axis=0, keepdims=True)


def _stiffness():
    A = np.random.default_rng(1).standard_normal((6, 6))
    return 100.0 * (A @ A.T + 6.0 * np.eye(6))


def _conductivity():
    A = np.random.default_rng(2).standard_normal((3, 3))
    return A @ A.T + 3.0 * np.eye(3) + 0.2 * (A - A.T)


# material -> (dim, [(JAX law, port phase law)] for fibre and matrix)
def _phase_laws(material, shape=SHAPE):
    if material == "tiso":
        return 6, [(jl.LinearTransverselyIsotropic(a=np.array(AXIS), **TISO),
                    ("tiso", TISO, AXIS))]
    if material == "tiso-field":
        o = _orientation(shape)
        return 6, [(jl.LinearTransverselyIsotropic(orientation=jnp.asarray(o),
                                                   **TISO),
                    ("tiso", TISO, o))]
    if material == "general":
        C = _stiffness()
        return 6, [(jl.LinearGeneral(C=C), ("general", C))]
    if material == "iso":
        return 6, [(jl.LinearIsotropic(mu=10.0, lam=5.0),
                    ("isotropic", 10.0, 5.0))]
    K = _conductivity()
    return 3, [(jl.MatrixLinearAnisotropic(K=K), ("aniso", K))]


def _matrix_law(dim, material):
    if dim == 3:
        return jl.ScalarLinearIsotropic(mu=1.0, dim=3), ("scalar", 1.0)
    if material == "iso":
        return jl.LinearIsotropic(mu=1.0, lam=1.0), ("isotropic", 1.0, 1.0)
    return jl.LinearIsotropic(mu=MATRIX[0], lam=MATRIX[1]), \
        ("isotropic", *MATRIX)


LOADS = {6: [0.01, -0.002, 0.003, 0.004, 0.0, 0.002], 3: [1.0, 0.5, 0.0]}


def _solvers(material, rule="voigt", mode="elasticity", shape=SHAPE,
             **opts):
    """The JAX solver and the port's on the same problem, both loaded."""
    dim, fibre = _phase_laws(material, shape)
    matrix = _matrix_law(dim, material)
    phi = _phi(shape)
    (jf, pf), (jm, pm) = fibre[0], matrix
    jmat = jmix.MIXING_RULES[rule]([
        fg.Phase("fiber", jf, jnp.asarray(phi)),
        fg.Phase("matrix", jm, jnp.asarray(1.0 - phi))], dim=dim)
    pmat = ft.convert.material_from_numpy(
        [("fiber", pf, phi), ("matrix", pm, 1.0 - phi)], dim=dim,
        device="cpu", rule=rule)
    opts = dict(mode=mode, dtype="float64", maxiter=500, **opts)
    js = fg.LSSolver(fg.Grid(*shape, dx=CELL[0], dy=CELL[1], dz=CELL[2]),
                     jmat, fg.SolverOptions(**opts))
    ps = ft.LSSolver(ft.convert.grid_from_numpy(shape, CELL), pmat,
                     ft.convert.options_from_dict(opts), device="cpu")
    for s in (js, ps):
        s.set_strain(LOADS[dim])
    return js, ps


def _same_solve(js, ps, atol=0.0):
    assert ps.mu_0 == pytest.approx(js.mu_0, rel=1e-14)
    rj, rp = np.asarray(js.residuals), np.asarray(ps.residuals)
    assert len(rp) == len(rj) and len(rp) < 500
    np.testing.assert_allclose(rp, rj, rtol=1e-9, atol=atol)
    assert np.max(np.abs(ps.get_field("epsilon") - np.asarray(js.eps))) \
        <= 1e-9
    for name in ("calc_mean_strain", "calc_mean_stress"):
        ref = np.asarray(getattr(js, name)())
        np.testing.assert_allclose(getattr(ps, name)(), ref, rtol=0,
                                   atol=1e-10 * np.max(np.abs(ref)))


@pytest.mark.parametrize("material,rule,mode,scheme,method", [
    ("tiso", "voigt", "elasticity", "staggered", "cg"),
    ("tiso", "voigt", "elasticity", "collocated", "cg"),
    ("tiso", "voigt", "elasticity", "staggered", "basic"),
    ("tiso", "voigt", "elasticity", "collocated", "basic"),
    ("tiso-field", "voigt", "elasticity", "staggered", "cg"),
    ("tiso-field", "voigt", "elasticity", "collocated", "cg"),
    ("tiso-field", "voigt", "elasticity", "staggered", "basic"),
    ("tiso-field", "voigt", "elasticity", "collocated", "basic"),
    ("general", "voigt", "elasticity", "staggered", "cg"),
    ("general", "voigt", "elasticity", "collocated", "cg"),
    ("general", "voigt", "elasticity", "staggered", "basic"),
    ("general", "voigt", "elasticity", "collocated", "basic"),
    ("iso", "reuss", "elasticity", "staggered", "cg"),
    ("iso", "reuss", "elasticity", "collocated", "cg"),
    ("tiso", "maximum", "elasticity", "staggered", "cg"),
    ("tiso", "random", "elasticity", "staggered", "cg"),
    ("tiso", "fiftyfifty", "elasticity", "staggered", "cg"),
    ("iso", "split", "elasticity", "staggered", "cg"),
    ("iso", "iso", "elasticity", "staggered", "cg"),
    ("aniso", "voigt", "heat", "staggered", "cg"),
    ("aniso", "voigt", "heat", "collocated", "cg"),
    ("aniso", "voigt", "porous", "staggered", "basic"),
    ("aniso", "maximum", "porous", "collocated", "cg")])
def test_general_solve_matches_jax(material, rule, mode, scheme, method):
    cg = method == "cg"
    js, ps = _solvers(material, rule, mode, gamma_scheme=scheme,
                      method=method,
                      error_estimator="residual" if cg else "epsilon",
                      tol=1e-8 if cg else 1e-6)
    assert ps._k1_route == (rule == "reuss" and scheme == "staggered")
    assert not js.run() and not ps.run()
    _same_solve(js, ps, atol=0.0 if cg else 1e-14)


def test_uniaxial_stress_on_the_generic_route_matches_jax():
    """A tiso fibre under P = e_xx e_xx, S = 0 on the staggered grid: the
    generic route adds alpha R to eps_staggered's mean."""
    js, ps = _solvers("tiso", gamma_scheme="staggered",
                      error_estimator="residual", tol=1e-10)
    P = np.zeros((6, 6))
    P[0, 0] = 1.0
    for s in (js, ps):
        s.set_bc_projector(P)
        s.set_stress(np.zeros(6))
        s.set_strain([0.01, 0, 0, 0, 0, 0])
    assert not js.run() and not ps.run()
    _same_solve(js, ps)
    assert abs(ps.bc_error() - js.bc_error()) <= 1e-10
    assert ps.bc_error() <= ps.opt.bc_tol
    S = ps.calc_mean_stress()
    assert np.max(np.abs(S[1:])) <= 1e-9 * abs(S[0])


def test_run_batched_with_a_tiso_fibre_matches_jax():
    """The six unit strains in one batch on the generic staggered route,
    against the JAX package's batched state after as many steps."""
    js, ps = _solvers("tiso-field", error_estimator="residual", tol=1e-9,
                      check_every=2)
    Es = np.eye(6)
    assert not js.run_batched(Es)
    assert not ps.run_batched(Es, pallas_mid="auto")
    rj, rp = np.asarray(js.residuals), np.asarray(ps.residuals)
    assert len(rp) == len(rj)
    np.testing.assert_allclose(rp, rj, rtol=1e-9)
    steps = math.ceil(len(rp) / 2) * 2
    mf = js.mat.fields()
    eps = js._cg_b_init_chunk_n(steps)(
        mf, jnp.asarray(Es, js.dtype), mu0=js.mu_0, lam0=js.lambda_0,
        pallas_mid=True)[0]
    S_ref = np.asarray(js._k_b_means(mf, eps)[1])
    assert np.max(np.abs(ps.eps_batch.numpy() - np.asarray(eps))) <= 1e-9
    np.testing.assert_allclose(ps.calc_mean_stress_batched(), S_ref, rtol=0,
                               atol=1e-10 * np.max(np.abs(S_ref)))


def test_refusals_of_the_paths_not_ported():
    grid = ft.Grid(*SHAPE)
    # staggered viscosity off the isotropic route takes the generic Delta
    # path (tests/test_torch_dfg.py holds it against the JAX package)
    for rule, law in (("voigt", ("general", _stiffness())),
                      ("maximum", ("scalar", 1.0))):
        mat = ft.convert.material_from_numpy(
            [("a", law, _phi()), ("b", ("scalar", 2.0), 1.0 - _phi())],
            device="cpu", rule=rule)
        for scheme in ("staggered", "collocated"):
            s = ft.LSSolver(grid, mat, ft.SolverOptions(
                mode="viscosity", gamma_scheme=scheme, tol=1e-6),
                device="cpu")
            assert not s._k1_route
            s.set_strain([0, 0, 0, 0, 1.0, 0])
            assert not s.run()
    # polarization: the laws' own refusal, in both packages
    js, ps = _solvers("tiso", method="polarization")
    for s in (js, ps):
        with pytest.raises(NotImplementedError,
                           match="LinearTransverselyIsotropic has no "
                                 "polarization"):
            s.run()
    # Reuss needs isotropic laws, as in the JAX package (which raises in
    # the solve, the port when the solver is built)
    jmat = jmix.ReussMixed([
        fg.Phase("f", _phase_laws("tiso")[1][0][0], jnp.asarray(_phi())),
        fg.Phase("m", _matrix_law(6, "tiso")[0], jnp.asarray(1 - _phi()))])
    js = fg.LSSolver(fg.Grid(*SHAPE), jmat, fg.SolverOptions(dtype="float64"))
    js.set_strain(LOADS[6])
    with pytest.raises(NotImplementedError,
                       match="reuss mixing needs isotropic laws"):
        js.run()
    with pytest.raises(NotImplementedError,
                       match="reuss mixing needs isotropic laws"):
        _solvers("tiso", rule="reuss")
    # sharded: a material off the isotropic Voigt route, and Reuss, take
    # the slabs (test_torch_parallel_materials.py solves them)
    mesh = parallel.make_mesh(["cpu"] * 2)
    for material, rule in (("tiso", "voigt"), ("iso", "reuss"),
                           ("iso", "maximum")):
        _, ps = _solvers(material, rule, shape=(8, 4, 4))
        s = ft.LSSolver(ft.Grid(8, 4, 4), ps.mat, ft.SolverOptions(),
                        sharding=parallel.field_sharding(mesh))
        assert s.par is not None
        assert getattr(s.mat, "inner", s.mat) is ps.mat
    # hyperelastic phases: Maximum takes them (test_torch_hyper_rules.py),
    # Reuss needs isotropic laws, as in the JAX package
    ft.convert.material_from_numpy(
        [("a", 1.0, 1.0, _phi()), ("b", 2.0, 1.0, 1.0 - _phi())], dim=9,
        law="svk", device="cpu", rule="maximum")
    with pytest.raises(NotImplementedError,
                       match="reuss mixing needs isotropic laws"):
        ft.convert.material_from_numpy(
            [("a", 1.0, 1.0, _phi()), ("b", 2.0, 1.0, 1.0 - _phi())], dim=9,
            law="svk", device="cpu", rule="reuss")


def test_reference_material_follows_the_material_state():
    """mu_0 is memoized on the tensors the material reads: a new
    orientation field or phi recomputes it, the same ones do not."""
    _, ps = _solvers("tiso-field", error_estimator="residual", tol=1e-6)
    ps.calc_ref_material()
    memo = ps._eig_memo
    ps.calc_ref_material()
    assert ps._eig_memo is memo
    law = ps.mat.phases[0].law
    law.orientation = law.orientation.clone()
    ps.calc_ref_material()
    assert ps._eig_memo is not memo
    memo = ps._eig_memo
    ps.mat.phases[1].phi = ps.mat.phases[1].phi.clone()
    ps.calc_ref_material()
    assert ps._eig_memo is not memo and ps._eig_memo[1] == memo[1]
