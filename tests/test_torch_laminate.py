"""The interface rules (laminate, infinity-laminate, fluidity) against the
JAX package's, in float64 on the CPU: the responses of each rule over two
and three phases in dims 3 and 6, with the interface normals of the JAX
package's geometry_fields, within 1e-12; and solves, iteration for
iteration (residual histories within 1e-9, strain fields within 1e-9, mean
stresses within 1e-10): the laminate in elasticity on the staggered grid
(the generic route, K3's twin) and the collocated grid (K5's), in heat on
the staggered grid (K4's), and fluidity mixing in viscosity on both grids
(the generic Delta path, K3's twin with the dual constants; K6's).
"""
import functools

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import fibergen_tpu as fg
import fibergen_tpu_torch as ft
from fibergen_tpu.geometry import discretize
from fibergen_tpu.geometry.primitives import Capsule
from fibergen_tpu.materials import laminate as jlam
from fibergen_tpu.materials import laws as jl
from fibergen_tpu.utils.logging import LOG as JLOG
from fibergen_tpu_torch.materials import laws, mixing
from fibergen_tpu_torch.utils.logging import LOG

torch.set_num_threads(2)

SHAPE = (9, 7, 5)
TISO = dict(E=3860.0, nu=0.2, E_a=5390.0, G_a=390.0, nu_a=0.031)
AXIS = [1.0, 0.3, -0.2]


@pytest.fixture(autouse=True)
def _quiet():
    old = (JLOG.enabled, LOG.enabled)
    JLOG.enabled = LOG.enabled = False
    yield
    JLOG.enabled, LOG.enabled = old


@functools.lru_cache(maxsize=None)
def _geometry(shape=SHAPE):
    """Two spheres, one inside the cell and one across its x face: their
    supersampled phase fields (matrix, sphere 1, sphere 2) and the
    normals of the JAX package's geometry_fields, as numpy (made once;
    the callers do not write them)."""
    grid = fg.Grid(*shape)
    fibres = [Capsule(material=1, fiber_id=0, center=np.array([0.5, 0.5, 0.5]),
                      axis=np.array([1.0, 0, 0]), length=0.0, radius=0.3),
              Capsule(material=2, fiber_id=1, center=np.array([0.95, 0.2, 0.3]),
                      axis=np.array([1.0, 0, 0]), length=0.0, radius=0.22)]
    phis = discretize.voxelize(grid, fibres, n_materials=3,
                               matrix_material=0, supersample=4,
                               dtype=jnp.float64)
    n = discretize.geometry_fields(grid, fibres, dtype=jnp.float64)["normals"]
    return [np.array(p) for p in phis], np.array(n)


def _phase_laws(dim, kind):
    """[(JAX law, port law)] per phase: isotropic (``iso``), a tiso fibre
    in an isotropic matrix (``tiso``), scalar laws (dim 3, fluidities)."""
    if dim == 3 or kind == "scalar":
        mus = (1.0, 10.0, 4.0) if dim == 3 else (1.0, 0.1, 0.5)
        return [(jl.ScalarLinearIsotropic(mu=m, dim=dim),
                 laws.ScalarLinearIsotropic(mu=m, dim=dim)) for m in mus]
    if kind == "tiso":
        a = np.array(AXIS)
        return [(jl.LinearIsotropic(mu=350.0, lam=525.0),
                 laws.LinearIsotropic(mu=350.0, lam=525.0)),
                (jl.LinearTransverselyIsotropic(a=a, **TISO),
                 laws.LinearTransverselyIsotropic(a=a, **TISO))]
    mo = ((1.0, 1.0), (10.0, 5.0), (4.0, 0.5))
    return [(jl.LinearIsotropic(mu=m, lam=lm), laws.LinearIsotropic(mu=m,
                                                                    lam=lm))
            for m, lm in mo]


def _materials(rule, dim, nphases, kind="iso", flip=False):
    """The JAX rule and the port's over the same phases and normals."""
    phis, n = _geometry()
    if nphases == 2:
        phis = [phis[0], 1.0 - phis[0]]
    pl = _phase_laws(dim, kind)[:nphases]
    nj = -n if flip else n
    jcls = {"laminate": jlam.LaminateMixed,
            "infinity_laminate": jlam.InfinityLaminateMixed,
            "fluidity": jlam.FluidityMixed}[rule]
    jmat = jcls([fg.Phase(f"p{i}", j, jnp.asarray(phi))
                 for i, ((j, _), phi) in enumerate(zip(pl, phis))], dim=dim,
                normals=jnp.asarray(n))
    pmat = mixing.make_mixed(rule, [
        mixing.Phase(f"p{i}", p, torch.as_tensor(phi))
        for i, ((_, p), phi) in enumerate(zip(pl, phis))], dim=dim)
    pmat.normals = torch.as_tensor(nj)
    return jmat, pmat


def _close(a, b, tol=1e-12):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.max(np.abs(a - b)) <= tol * max(1.0, np.max(np.abs(b))), \
        np.max(np.abs(a - b))


CASES = [("laminate", 3, 2, "iso"), ("laminate", 3, 3, "iso"),
         ("laminate", 6, 2, "iso"), ("laminate", 6, 3, "iso"),
         ("laminate", 6, 2, "tiso"),
         ("infinity_laminate", 3, 2, "iso"), ("infinity_laminate", 6, 2, "iso"),
         ("infinity_laminate", 6, 2, "tiso"),
         ("fluidity", 6, 2, "scalar"), ("fluidity", 6, 3, "scalar")]


@pytest.mark.parametrize("rule,dim,nphases,kind", CASES)
def test_responses_match_jax(rule, dim, nphases, kind):
    """pk1, w, dpk1, stress_diff, mean_pk1 and eig_range, within 1e-12."""
    jmat, pmat = _materials(rule, dim, nphases, kind)
    rng = np.random.default_rng(3)
    F = rng.standard_normal((dim,) + SHAPE)
    W = rng.standard_normal((dim,) + SHAPE)
    Fj, Ft = jnp.asarray(F), torch.as_tensor(F)
    Wj, Wt = jnp.asarray(W), torch.as_tensor(W)
    _close(pmat.pk1(Ft), jmat.pk1(Fj))
    _close(pmat.w(Ft), jmat.w(Fj))
    _close(pmat.dpk1(Ft, Wt), jmat.dpk1(Fj, Wj))
    _close(pmat.stress_diff(Ft, 0.7, 0.2), jmat.stress_diff(Fj, 0.7, 0.2))
    _close(pmat.mean_pk1(Ft), jmat.mean_pk1(Fj))
    for zt in (False, True):
        _close([float(x) for x in pmat.eig_range(zero_trace=zt)],
               [float(x) for x in jmat.eig_range(Fj, zero_trace=zt)])
    assert not pmat.iso_route()
    # the interface is where the rule differs from the Voigt rule
    voigt = mixing.VoigtMixed(list(pmat.phases), dim=dim)
    assert torch.max(torch.abs(pmat.pk1(Ft) - voigt.pk1(Ft))) > 1e-3


@pytest.mark.parametrize("rule,dim,kind", [
    ("laminate", 6, "tiso"), ("laminate", 3, "iso"),
    ("infinity_laminate", 6, "iso"), ("fluidity", 6, "scalar")])
def test_the_sign_of_the_normal_changes_nothing(rule, dim, kind):
    """sym(a x n) is invariant under (a, n) -> (-a, -n): a linear law's
    laminate takes either normal."""
    _, pmat = _materials(rule, dim, 2, kind)
    _, flip = _materials(rule, dim, 2, kind, flip=True)
    F = torch.as_tensor(np.random.default_rng(4).standard_normal(
        (dim,) + SHAPE))
    _close(flip.pk1(F), pmat.pk1(F), tol=1e-13)


def test_pure_voxels_and_laminate_closed_forms():
    """A planar interface cutting a voxel: the laminate rule gives the
    exact series conductivity; zero normals take the guard's e_x, the
    interface's own normal here."""
    shape = (8, 3, 3)
    x = np.arange(8) / 8.0
    frac = 0.5 + 0.3 / 8
    f2 = np.clip((frac - x) * 8.0, 0.0, 1.0)
    phi2 = np.broadcast_to(f2[:, None, None], shape).copy()
    k1, k2 = 1.0, 10.0
    mat = ft.convert.material_from_numpy(
        [("a", k1, 1.0 - phi2), ("b", k2, phi2)], dim=3, law="scalar",
        device="cpu", rule="laminate", normals=np.zeros((3,) + shape))
    s = ft.LSSolver(ft.Grid(*shape), mat, ft.SolverOptions(
        mode="heat", tol=1e-12, error_estimator="residual", maxiter=500),
        device="cpu")
    s.set_strain([1.0, 0, 0])
    assert not s.run()
    exact = 1.0 / ((1 - frac) / k1 + frac / k2)
    assert abs(s.calc_mean_stress()[0] - exact) <= 1e-10 * exact


def test_refusals():
    phi = torch.full(SHAPE, 0.5, dtype=torch.float64)
    svk = [mixing.Phase(f"p{i}", laws.SaintVenantKirchhoff(mu=1.0, lam=1.0),
                        phi) for i in range(2)]
    # the laminates take nonlinear laws (test_torch_hyper_laminate.py);
    # the fluidity rule is viscosity's
    for rule in ("laminate", "infinity-laminate"):
        assert mixing.make_mixed(rule, svk, dim=9).dim == 9
    with pytest.raises(ValueError, match="fluidity mixing requires dim 6"):
        mixing.make_mixed("fluidity", svk, dim=9)
    iso = [mixing.Phase(f"p{i}", laws.LinearIsotropic(mu=1.0, lam=1.0), phi)
           for i in range(2)]
    mat = mixing.make_mixed("laminate", iso)
    with pytest.raises(ValueError, match="normals"):
        mat.pk1(torch.zeros((6,) + SHAPE, dtype=torch.float64))
    with pytest.raises(ValueError, match="dim 6"):
        mixing.make_mixed("fluidity", iso, dim=3)
    with pytest.raises(ValueError, match="takes no normals"):
        ft.convert.material_from_numpy(
            [("a", 1.0, 1.0, phi.numpy())], device="cpu",
            normals=np.zeros((3,) + SHAPE))
    gen = laws.LinearGeneral(C=np.eye(6))
    with pytest.raises(ValueError, match="linear isotropic"):
        mixing.make_mixed("laminate", iso + [mixing.Phase("g", gen, phi)])


# ------------------------------------------------------ solves

def _solvers(rule, mode, scheme, method="cg", nphases=2, kind="iso", **opt):
    dim = 3 if mode == "heat" else 6
    jmat, pmat = _materials(rule, dim, nphases, kind)
    opts = dict(mode=mode, gamma_scheme=scheme, method=method,
                dtype="float64", maxiter=500,
                error_estimator="residual" if method == "cg" else "epsilon",
                tol=1e-8 if method == "cg" else 1e-6, **opt)
    js = fg.LSSolver(fg.Grid(*SHAPE), jmat, fg.SolverOptions(**opts))
    ps = ft.LSSolver(ft.Grid(*SHAPE), pmat, ft.convert.options_from_dict(opts),
                     device="cpu")
    load = {"elasticity": [0.01, -0.002, 0.003, 0.004, 0.0, 0.002],
            "heat": [1.0, 0.5, 0.0], "viscosity": [0, 0, 0, 0, 1.0, 0.3]}
    for s in (js, ps):
        s.set_strain(load[mode])
    return js, ps


def _same_solve(js, ps, atol=0.0):
    assert ps.mu_0 == pytest.approx(js.mu_0, rel=1e-14)
    rj, rp = np.asarray(js.residuals), np.asarray(ps.residuals)
    assert len(rp) == len(rj) and 1 < len(rp) < 500
    np.testing.assert_allclose(rp, rj, rtol=1e-9, atol=atol)
    assert np.max(np.abs(ps.get_field("epsilon") - np.asarray(js.eps))) \
        <= 1e-9
    for name in ("calc_mean_strain", "calc_mean_stress"):
        ref = np.asarray(getattr(js, name)())
        np.testing.assert_allclose(getattr(ps, name)(), ref, rtol=0,
                                   atol=1e-10 * np.max(np.abs(ref)))


@pytest.mark.parametrize("rule,mode,scheme,method,nphases,kind", [
    ("laminate", "elasticity", "staggered", "cg", 2, "iso"),
    ("laminate", "elasticity", "collocated", "cg", 2, "iso"),
    ("laminate", "elasticity", "staggered", "basic", 3, "iso"),
    ("laminate", "elasticity", "staggered", "cg", 2, "tiso"),
    ("infinity_laminate", "elasticity", "collocated", "cg", 2, "iso"),
    ("laminate", "heat", "staggered", "cg", 2, "iso"),
    ("laminate", "heat", "collocated", "cg", 3, "iso"),
    ("fluidity", "viscosity", "staggered", "cg", 2, "scalar"),
    ("fluidity", "viscosity", "collocated", "cg", 2, "scalar"),
    ("fluidity", "viscosity", "staggered", "basic", 3, "scalar")])
def test_solve_matches_jax(rule, mode, scheme, method, nphases, kind):
    js, ps = _solvers(rule, mode, scheme, method, nphases, kind)
    assert not ps._k1_route
    assert not js.run() and not ps.run()
    _same_solve(js, ps, atol=0.0 if method == "cg" else 1e-14)
