"""The doubly-fine grid and the generic staggered Delta path against the
JAX package, in float64 on the CPU: prolong and restrict in dims 3 and 6,
the responses of DfgMaterial over fine phases within 1e-12; solves,
iteration for iteration (residual histories within 1e-9, strain fields
within 1e-9, mean stresses within 1e-10) under half_staggered and
full_staggered in elasticity, heat and viscosity, and staggered viscosity
off the fused K1/K2 route (phases with a lambda, a tiso phase, a rule off
the isotropic route, mixed BCs, and run_batched); and the Nunan-Keller
demo at n = 8 (the JAX package's FG, its fine phases handed to the port),
whose alpha and beta agree within 1e-8.  Lambda phases that make the Delta
operator near singular on the trace are held to the JAX package's mean
stress only (ROADMAP.md, Queue 3 item 2).
"""
import math
import os

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import fibergen_tpu as fg
import fibergen_tpu_torch as ft
from fibergen_tpu.materials import dfg as jdfg
from fibergen_tpu.materials import laws as jl
from fibergen_tpu.materials import mixing as jmix
from fibergen_tpu.utils.logging import LOG as JLOG
from fibergen_tpu_torch.core import voigt
from fibergen_tpu_torch.materials import dfg
from fibergen_tpu_torch.utils.logging import LOG

torch.set_num_threads(2)

SHAPE = (9, 7, 5)
FINE = tuple(2 * n for n in SHAPE)
TISO = dict(E=3860.0, nu=0.2, E_a=5390.0, G_a=390.0, nu_a=0.031)
DEMO = os.path.join(os.path.dirname(__file__), "..", "demo", "viscosity",
                    "nunan_keller", "project.xml")


@pytest.fixture(autouse=True)
def _quiet():
    old = (JLOG.enabled, LOG.enabled)
    JLOG.enabled = LOG.enabled = False
    yield
    JLOG.enabled, LOG.enabled = old


def _phi(shape):
    """A blurred sphere: interface voxels around pure ones."""
    ax = [(np.arange(s) + 0.5) / s - 0.5 for s in shape]
    X, Y, Z = np.meshgrid(*ax, indexing="ij")
    return 1.0 / (1.0 + np.exp(-(0.09 - (X * X + Y * Y + Z * Z)) / 0.02))


@pytest.mark.parametrize("dim", [3, 6])
def test_prolong_and_restrict_match_jax(dim):
    rng = np.random.default_rng(dim)
    F = rng.standard_normal((dim,) + SHAPE)
    Y = rng.standard_normal((dim,) + FINE)
    P = dfg.prolong(torch.as_tensor(F)).numpy()
    np.testing.assert_array_equal(P, np.asarray(jdfg.prolong(jnp.asarray(F))))
    np.testing.assert_allclose(dfg.restrict(torch.as_tensor(Y)).numpy(),
                               np.asarray(jdfg.restrict(jnp.asarray(Y))),
                               rtol=0, atol=1e-14)
    np.testing.assert_allclose(dfg.restrict(torch.as_tensor(P)).numpy(), F,
                               rtol=0, atol=1e-15)


# material -> (dim, rule, [(JAX law, port phase) per phase])
def _phases(material):
    if material == "iso":
        return 6, "voigt", [(jl.LinearIsotropic(mu=10.0, lam=5.0),
                             ("isotropic", 10.0, 5.0)),
                            (jl.LinearIsotropic(mu=1.0, lam=1.0),
                             ("isotropic", 1.0, 1.0))]
    if material == "tiso":
        a = np.array([1.0, 0.3, -0.2])
        return 6, "maximum", [
            (jl.LinearTransverselyIsotropic(a=a, **TISO), ("tiso", TISO, a)),
            (jl.LinearIsotropic(mu=350.0, lam=525.0),
             ("isotropic", 350.0, 525.0))]
    if material == "heat":
        return 3, "voigt", [(jl.ScalarLinearIsotropic(mu=m, dim=3),
                             ("scalar", m)) for m in (10.0, 1.0)]
    if material == "visc-lambda":
        # 2 mu + 3 lam < 4 mu_0 in both phases: the Delta operator stays
        # regular on the trace (ROADMAP.md, Queue 3)
        return 6, "voigt", [(jl.LinearIsotropic(mu=m, lam=lm),
                             ("isotropic", m, lm))
                            for m, lm in ((0.05, 0.01), (0.5, 0.02))]
    if material == "visc-lambda-singular":
        # 2 mu + 3 lam = 4 mu_0 in the fibre: the Delta operator is
        # singular on the trace (ROADMAP.md, Queue 3 item 2)
        return 6, "voigt", [(jl.LinearIsotropic(mu=m, lam=lm),
                             ("isotropic", m, lm))
                            for m, lm in ((0.05, 0.02), (0.5, 0.1))]
    # viscosity: fluidities 0.1 (fibre) and 1 (matrix)
    return 6, "voigt", [
        (jl.ScalarLinearIsotropic(mu=m, dim=6), ("scalar", m))
        for m in (0.1, 1.0)]


def _materials(material, fine=True, rule=None):
    """The JAX material and the port's over the phases of ``material``
    (on the doubly-fine grid with ``fine``, wrapped in DfgMaterial)."""
    dim, rule0, pl = _phases(material)
    rule = rule or rule0
    phi = _phi(FINE if fine else SHAPE)
    phis = (phi, 1.0 - phi)
    jmat = jmix.MIXING_RULES[rule]([
        fg.Phase(f"p{i}", j, jnp.asarray(ph))
        for i, ((j, _), ph) in enumerate(zip(pl, phis))], dim=dim)
    pmat = ft.convert.material_from_numpy(
        [(f"p{i}", p, ph) for i, ((_, p), ph) in enumerate(zip(pl, phis))],
        dim=dim, device="cpu", rule=rule)
    if fine:
        return jdfg.DfgMaterial(jmat), dfg.DfgMaterial(pmat)
    return jmat, pmat


def _close(a, b, tol=1e-12):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.max(np.abs(a - b)) <= tol * max(1.0, np.max(np.abs(b)))


@pytest.mark.parametrize("material", ["iso", "tiso", "heat", "visc"])
def test_dfg_responses_match_jax(material):
    jmat, pmat = _materials(material)
    dim = jmat.dim
    assert isinstance(pmat, dfg.DfgMaterial) and not pmat.iso_route()
    rng = np.random.default_rng(5)
    F, W = (rng.standard_normal((dim,) + SHAPE) for _ in range(2))
    Fj, Ft = jnp.asarray(F), torch.as_tensor(F)
    _close(pmat.pk1(Ft), jmat.pk1(Fj))
    _close(pmat.dpk1(Ft, torch.as_tensor(W)), jmat.dpk1(Fj, jnp.asarray(W)))
    _close(pmat.stress_diff(Ft, 0.7, 0.2), jmat.stress_diff(Fj, 0.7, 0.2))
    _close(pmat.w(Ft), jmat.w(Fj))
    _close(pmat.mean_w(Ft), jmat.mean_w(Fj))
    _close(pmat.mean_pk1(Ft), jmat.mean_pk1(Fj))
    _close(pmat.mean_cauchy(Ft), jmat.mean_cauchy(Fj))
    for zt in (False, True):
        _close([float(x) for x in pmat.eig_range(zero_trace=zt)],
               [float(x) for x in jmat.eig_range(Fj, zero_trace=zt)])
    if material == "iso":
        _close(pmat.polarization(0.8, Ft), jmat.polarization(0.8, Fj))


def test_refusals():
    phi = np.full(FINE, 0.5)
    # dim 9 fields take the shears' shifts on their off-diagonal
    # components (test_torch_hyper_rules.py solves with them)
    F = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (9,) + SHAPE))
    np.testing.assert_array_equal(dfg.restrict(dfg.prolong(F)).numpy(),
                                  F.numpy())
    with pytest.raises(ValueError, match="dim 3, 6 or 9"):
        dfg.prolong(torch.zeros((5,) + SHAPE))
    mat = ft.convert.material_from_numpy(
        [("a", 1.0, 1.0, phi), ("b", 2.0, 1.0, 1.0 - phi)], dim=9,
        law="svk", device="cpu")
    assert dfg.DfgMaterial(mat).dim == 9
    # staggered viscosity takes the slabs too (the sharded solves are in
    # test_torch_parallel_paths.py), a doubly-fine material on a mesh
    # keeps its kind
    from fibergen_tpu_torch import parallel
    _, pmat = _materials("visc", fine=False)
    s = ft.LSSolver(ft.Grid(*SHAPE), pmat, ft.SolverOptions(
        mode="viscosity"), sharding=parallel.field_sharding(
            parallel.make_mesh(["cpu"])))
    assert s.par is not None
    _, fmat = _materials("visc")
    s = ft.LSSolver(ft.Grid(*SHAPE), fmat, ft.SolverOptions(
        mode="viscosity", gamma_scheme="full_staggered"),
        sharding=parallel.field_sharding(parallel.make_mesh(["cpu"])))
    assert isinstance(s.mat, dfg.DfgMaterial) and s.par is not None


# ------------------------------------------------------ solves

LOADS = {6: [0.01, -0.002, 0.003, 0.004, 0.0, 0.002], 3: [1.0, 0.5, 0.0],
         "viscosity": [0.0, 0.0, 0.0, 0.3, 1.0, 0.0]}


def _solvers(material, mode, scheme, fine=None, rule=None, **opt):
    fine = scheme != "staggered" if fine is None else fine
    jmat, pmat = _materials(material, fine=fine, rule=rule)
    dim = jmat.dim
    opts = dict(mode=mode, gamma_scheme=scheme, dtype="float64", maxiter=500,
                **opt)
    opts.setdefault("error_estimator", "residual")
    opts.setdefault("tol", 1e-8)
    js = fg.LSSolver(fg.Grid(*SHAPE), jmat, fg.SolverOptions(**opts))
    ps = ft.LSSolver(ft.Grid(*SHAPE), pmat, ft.convert.options_from_dict(opts),
                     device="cpu")
    for s in (js, ps):
        s.set_strain(LOADS["viscosity" if mode == "viscosity" else dim])
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


@pytest.mark.parametrize("material,mode,scheme,method", [
    ("iso", "elasticity", "full_staggered", "cg"),
    ("iso", "elasticity", "half_staggered", "basic"),
    ("tiso", "elasticity", "full_staggered", "cg"),
    ("heat", "heat", "full_staggered", "cg"),
    ("heat", "porous", "half_staggered", "cg"),
    ("visc", "viscosity", "full_staggered", "cg"),
    ("visc", "viscosity", "full_staggered", "basic"),
    # the generic Delta path on the voxel grid
    ("visc-lambda", "viscosity", "staggered", "cg"),
    ("visc-lambda", "viscosity", "staggered", "basic"),
    ("tiso", "viscosity", "staggered", "cg"),
    ("visc-max", "viscosity", "staggered", "cg")])
def test_solve_matches_jax(material, mode, scheme, method):
    rule = "maximum" if material == "visc-max" else None
    if method == "basic":
        opt = dict(method="basic", error_estimator="epsilon", tol=1e-6)
    else:
        opt = {}
    js, ps = _solvers("visc" if rule else material, mode, scheme, rule=rule,
                      **opt)
    assert not ps._k1_route and ps.scheme != "collocated"
    assert ps.scheme == js.scheme == scheme
    assert not js.run() and not ps.run()
    _same_solve(js, ps, atol=0.0 if method == "cg" else 1e-14)


def test_route_choice_in_staggered_viscosity():
    """The fused K1/K2 viscosity route takes isotropic zero-lambda phases
    on the isotropic route without a mixed BC; a lambda phase or another
    rule takes the generic Delta path, and both give the same solve on
    the sharp bench phases (maximum = voigt there)."""
    sharp = (_phi(SHAPE) > 0.5).astype(float)
    res = {}
    for rule in ("voigt", "maximum"):
        mat = ft.convert.material_from_numpy(
            [("f", 0.1, sharp), ("m", 1.0, 1.0 - sharp)], device="cpu",
            law="scalar", rule=rule)
        s = ft.LSSolver(ft.Grid(*SHAPE), mat, ft.SolverOptions(
            mode="viscosity", tol=1e-10, error_estimator="residual"),
            device="cpu")
        assert s._k1_route == (rule == "voigt")
        s.set_strain(LOADS["viscosity"])
        assert not s.run()
        res[rule] = (len(s.residuals), s.calc_mean_stress())
    assert abs(res["voigt"][0] - res["maximum"][0]) <= 1
    np.testing.assert_allclose(res["maximum"][1], res["voigt"][1], rtol=0,
                               atol=1e-9)
    _, ps = _solvers("visc-lambda", "viscosity", "staggered")
    assert not ps._k1_route


def test_singular_trace_lambda_viscosity_mean_stress():
    """The known fault of ROADMAP.md Queue 3 item 2, held in view: on
    lambda phases whose 2 mu + 3 lam comes near 4 mu_0 (the reference
    material's bounds leave out the trace), the CG operator's trace factor
    1 - (2 mu + 3 lam - 2 mu_0) / (2 mu_0) is near zero, and rounding on
    the trace grows each iteration, so the residual histories of the two
    packages part by more than the parity limit of 1e-9.  What stays sound
    is checked: mu_0, the iteration count and the mean stress (1e-10),
    until the reference's choice of mu_0 for such phases is settled."""
    js, ps = _solvers("visc-lambda-singular", "viscosity", "staggered")
    assert not ps._k1_route
    assert not js.run() and not ps.run()
    assert ps.mu_0 == pytest.approx(js.mu_0, rel=1e-14)
    factors = [1.0 - (2.0 * mu + 3.0 * lam - 2.0 * ps.mu_0) / (2.0 * ps.mu_0)
               for mu, lam in ((0.05, 0.02), (0.5, 0.1))]
    assert min(abs(f) for f in factors) < 0.05
    assert abs(len(ps.residuals) - len(js.residuals)) <= 1
    ref = np.asarray(js.calc_mean_stress())
    np.testing.assert_allclose(ps.calc_mean_stress(), ref, rtol=0,
                               atol=1e-10 * np.max(np.abs(ref)))


@pytest.mark.parametrize("scheme,method", [("staggered", "cg"),
                                           ("full_staggered", "cg"),
                                           ("staggered", "basic")])
def test_mixed_bc_viscosity_matches_jax(scheme, method):
    """xz stress-controlled (P[4, 4] = 0, S_xz = 0.4) on the generic Delta
    path: the correction reads mean(tau) and adds to the mean of eta."""
    opt = dict(method="basic", error_estimator="epsilon", tol=1e-6) \
        if method == "basic" else {}
    js, ps = _solvers("visc", "viscosity", scheme, **opt)
    P = voigt.id4(6)
    P[4, 4] = 0.0
    for s in (js, ps):
        s.set_bc_projector(P)
        s.set_stress([0, 0, 0, 0, 0.4, 0])
        s.set_strain([0, 0, 0, 1.0, 0, 0])
    assert not js.run() and not ps.run()
    _same_solve(js, ps, atol=0.0 if method == "cg" else 1e-14)
    assert abs(ps.bc_error() - js.bc_error()) <= 1e-10
    assert ps.bc_error() <= ps.opt.bc_tol


def test_run_batched_on_the_generic_delta_path_matches_jax():
    """The five traceless cases in one batch under full_staggered, against
    the JAX package's batched state after as many steps."""
    js, ps = _solvers("visc", "viscosity", "full_staggered", tol=1e-9,
                      check_every=2)
    Es = ft.api.VISCOSITY_CASES
    assert not js.run_batched(Es)
    assert not ps.run_batched(Es)
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


def test_nunan_keller_demo_at_n8_matches_jax():
    """The demo's rigid sphere (V = 0.2, fluidities 0.5 and 0) at n = 8 under
    full_staggered: the JAX package's FG voxelizes it on the 16^3 fine grid
    and solves the five cases; the port solves them from the same fine
    phases and takes alpha and beta with api.effective_viscosity."""
    f = fg.FG()
    f.load_xml(DEMO)
    f.set("solver..n", 8)
    f.set("solver.dtype", "float64")
    f.set("solver.tol", 1e-10)
    assert f.run() == 0
    jmat, o = f.solver.mat, f.solver.opt
    assert isinstance(jmat, jdfg.DfgMaterial)
    pmat = dfg.DfgMaterial(ft.convert.material_from_numpy(
        [(p.name, p.law.mu, np.asarray(p.phi)) for p in jmat.phases],
        dim=6, law="scalar", device="cpu"))
    opts = {k: getattr(o, k) for k in (
        "mode", "method", "gamma_scheme", "tol", "dtype", "error_estimator",
        "check_every", "maxiter")}
    s = ft.LSSolver(ft.Grid(8, 8, 8), pmat, ft.convert.options_from_dict(opts),
                    device="cpu")
    assert not s.run_batched(ft.api.VISCOSITY_CASES)
    matrix = jmat.phases[f._matrix_material]
    out = ft.api.effective_viscosity(s.calc_mean_stress_batched(),
                                     matrix.law.mu)
    alpha, beta = f._nunan_keller
    assert abs(out.alpha - alpha) <= 1e-8 and abs(out.beta - beta) <= 1e-8
    np.testing.assert_allclose(out.C, np.asarray(f._Ceff), rtol=0, atol=1e-8)
