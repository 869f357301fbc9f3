"""The port's finite-strain slice against the JAX package, in float64 on the
CPU (the port's plain path):

* every hyperelastic law's energy, PK1 and tangent; VoigtMixed in dim 9
  (PK1, tangent, energy, Cauchy stress, stress difference, tangent
  eigenvalue bounds);
* the full-gradient staggered stencils, the finite-strain Green operators
  (hat space and the K3 / K5-at-C=9 twins, also against the Pallas middle
  in interpret mode) and ``gamma_hyper`` against ``gamma_operator``;
* Newton-Krylov solves on both grids with both tangents, iteration for
  iteration (the JAX reference solves are shared through a module-scoped
  cache); ``check_every=4``, where the JAX package's host loop runs one
  chunk further, within 1e-7; the port's own regressions: distinct
  inner/outer estimators, the loadstep split and small-strain SVK against
  the linear laminate.

The CUDA kernel against its twin is in test_torch_cuda.py.
"""
import contextlib
import warnings

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import fibergen_tpu as fg
import fibergen_tpu_torch as ft
from fibergen_tpu.core.grid import Grid as JGrid
from fibergen_tpu.materials import laws as jlaws
from fibergen_tpu.ops import fft as jfft
from fibergen_tpu.ops import gamma as jgamma
from fibergen_tpu.ops import green as jgreen
from fibergen_tpu.ops import pallas_chain as pc
from fibergen_tpu.ops import staggered as jstag
from fibergen_tpu.utils.logging import LOG as JLOG
from fibergen_tpu_torch.core import voigt
from fibergen_tpu_torch.core.grid import Grid
from fibergen_tpu_torch.materials import laws, mixing
from fibergen_tpu_torch.ops import gamma, green, spectral_kernels, staggered
from fibergen_tpu_torch.utils.logging import LOG

torch.set_num_threads(2)

ID9 = np.array([1.0, 1, 1, 0, 0, 0, 0, 0, 0])
MU0 = 1.7


@pytest.fixture(autouse=True)
def _quiet():
    old = (JLOG.enabled, LOG.enabled)
    JLOG.enabled = LOG.enabled = False
    yield
    JLOG.enabled, LOG.enabled = old


def _rel(a, ref):
    """Max-abs error relative to the reference's max-abs (complex values
    compare as their real and imaginary parts)."""
    a, ref = np.asarray(a), np.asarray(ref)
    if np.iscomplexobj(ref):
        a, ref = np.stack([a.real, a.imag]), np.stack([ref.real, ref.imag])
    return np.max(np.abs(a - ref)) / np.max(np.abs(ref))


def _near_identity(rng, shape, scale=0.1):
    return ID9.reshape(9, 1, 1, 1) + scale * rng.standard_normal(
        (9,) + shape)


# ------------------------------------------------------------------ laws

LAWS = ([("SaintVenantKirchhoff", dict(mu=2.0, lam=3.0)),
         ("NeoHooke", dict(mu=2.0, lam=3.0)),
         ("NeoHooke2", dict(mu=2.0, K=3.0))]
        + [(c.__name__, {}) for c in jlaws.GOLDBERG_LAWS.values()])


@pytest.mark.parametrize("name,params", LAWS, ids=[n for n, _ in LAWS])
def test_hyperelastic_laws_match_jax(name, params):
    rng = np.random.default_rng(1)
    F = _near_identity(rng, (5, 4, 3))
    W = rng.standard_normal((9, 5, 4, 3))
    jl, pl = getattr(jlaws, name)(**params), getattr(laws, name)(**params)
    Fj, Ft = jnp.asarray(F), torch.as_tensor(F)
    assert _rel(pl.w(Ft), jl.w(Fj)) <= 1e-12
    assert _rel(pl.pk1(Ft), jl.pk1(Fj)) <= 1e-12
    assert _rel(pl.dpk1(Ft, torch.as_tensor(W)),
                jl.dpk1(Fj, jnp.asarray(W))) <= 1e-12
    assert _rel(pl.cauchy(Ft), jl.cauchy(Fj)) <= 1e-12


def test_component_helpers_and_identity_match_jax():
    F = _near_identity(np.random.default_rng(2), (4, 3, 2))
    Fj, Ft = jnp.asarray(F), torch.as_tensor(F)
    assert _rel(laws.det3_comp(Ft), jlaws.det3_comp(Fj)) <= 1e-15
    for a, b in zip(laws.cauchy_green_comp(Ft), jlaws.cauchy_green_comp(Fj)):
        assert _rel(a, b) <= 1e-15
    from fibergen_tpu.core import voigt as jvoigt
    for dim in (3, 6, 9):
        np.testing.assert_array_equal(voigt.identity_vec(dim),
                                      jvoigt.identity_vec(dim))
    np.testing.assert_array_equal(voigt.weights(9), np.ones(9))


def _mixed(shape, rng, law="svk"):
    """A two-phase dim-9 material with a fractional phi, JAX and port."""
    phi = rng.random(shape)
    mk = {"svk": (jlaws.SaintVenantKirchhoff, (2.0, 3.0), (0.5, 0.7)),
          "neohooke": (jlaws.NeoHooke, (4.0, 1.0), (1.0, 2.0))}[law]
    jmat = fg.VoigtMixed([
        fg.Phase("a", mk[0](*mk[1]), jnp.asarray(phi)),
        fg.Phase("b", mk[0](*mk[2]), jnp.asarray(1.0 - phi))], dim=9)
    pmat = ft.convert.material_from_numpy(
        [("a", *mk[1], phi), ("b", *mk[2], 1.0 - phi)], dim=9, law=law,
        device="cpu")
    return jmat, pmat


@pytest.mark.parametrize("law", ["svk", "neohooke"])
def test_voigt_mixed_dim9_matches_jax(law, monkeypatch):
    shape = (7, 5, 3)
    rng = np.random.default_rng(3)
    jmat, pmat = _mixed(shape, rng, law)
    F = _near_identity(rng, shape)
    W = rng.standard_normal((9,) + shape)
    Fj, Ft = jnp.asarray(F), torch.as_tensor(F)
    assert _rel(pmat.pk1(Ft), jmat.pk1(Fj)) <= 1e-12
    assert _rel(pmat.dpk1(Ft, torch.as_tensor(W)),
                jmat.dpk1(Fj, jnp.asarray(W))) <= 1e-12
    assert _rel(pmat.w(Ft), jmat.w(Fj)) <= 1e-12
    assert _rel(pmat.mean_w(Ft), jmat.mean_w(Fj)) <= 1e-12
    assert _rel(pmat.mean_pk1(Ft), jmat.mean_pk1(Fj)) <= 1e-12
    assert _rel(pmat.mean_cauchy(Ft), jmat.mean_cauchy(Fj)) <= 1e-12
    for lam0 in (0.0, 0.4):
        assert _rel(pmat.stress_diff(Ft, MU0, lam0),
                    jmat.stress_diff(Fj, MU0, lam0)) <= 1e-12
    # the tangent bounds in ragged voxel chunks and eigvalsh batches, with
    # and without row and column 0 (one law: the JAX pass compiles per call)
    monkeypatch.setattr(mixing, "EIG_BATCH", 16)
    for zt in (False, True) if law == "svk" else ():
        lo, hi = pmat._eig_range_nonlinear(Ft, zt, chunk=37)
        jlo, jhi = jmat.eig_range(Fj, zero_trace=zt)
        assert float(lo) == pytest.approx(float(jlo), rel=1e-12)
        assert float(hi) == pytest.approx(float(jhi), rel=1e-12)
    assert pmat._all_iso() is None
    with pytest.raises(NotImplementedError):
        pmat.iso_moduli(torch.float64, "cpu")
    with pytest.raises(ValueError):
        pmat.drop_phi()


def test_dim9_takes_hyperelastic_laws_and_convert_builds_them():
    phi = np.ones((3, 3, 3))
    with pytest.raises(NotImplementedError):
        ft.convert.material_from_numpy([("a", 1.0, 1.0, phi)], dim=9,
                                       device="cpu")
    m = ft.convert.material_from_numpy(
        [("a", 2.0, 5.0, phi)], dim=9, law="neohooke2", device="cpu")
    assert m.phases[0].law == laws.NeoHooke2(mu=2.0, K=5.0)
    m = ft.convert.material_from_numpy(
        [("a", {"f1": 3.0, "f2": 1.5}, phi)], dim=9, law="gb_fiber5",
        device="cpu")
    assert m.phases[0].law == laws.GoldbergFiber5(f1=3.0, f2=1.5)
    assert set(laws.GOLDBERG_LAWS) == set(jlaws.GOLDBERG_LAWS)
    with pytest.raises(ValueError, match="unknown law"):
        ft.convert.material_from_numpy([("a", 1.0, 1.0, phi)], dim=9,
                                       law="ogden", device="cpu")


# ------------------------------------------------------------ operators

GRIDS = [((9, 7, 5), (1.2, 0.8, 1.0)), ((8, 6, 10), (1.0, 1.0, 1.0))]


def _grids(shape, cell):
    kw = dict(dx=cell[0], dy=cell[1], dz=cell[2])
    return Grid(*shape, **kw), JGrid(*shape, **kw)


@pytest.mark.parametrize("shape,cell", GRIDS)
def test_hyper_stencils_match_jax(shape, cell):
    g, jg = _grids(shape, cell)
    rng = np.random.default_rng(4)
    u = rng.standard_normal((3,) + shape)
    tau = rng.standard_normal((9,) + shape)
    E = rng.standard_normal(9)
    assert _rel(staggered.eps_staggered_hyper(g, torch.as_tensor(E),
                                              torch.as_tensor(u)),
                jstag.eps_staggered_hyper(jg, jnp.asarray(E),
                                          jnp.asarray(u))) <= 1e-14
    assert _rel(staggered.div_staggered_hyper(g, torch.as_tensor(tau)),
                jstag.div_staggered_hyper(jg, jnp.asarray(tau))) <= 1e-14


def test_hyper_constants_at_zero_lambda():
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        A, B = green.hyper_constants(MU0, 0.0)
    assert A == -1.0 / (2.0 * MU0) and B == 0.0
    A, B = green.hyper_constants(MU0, 0.4, alpha=-2.0)
    assert A == -2.0 / (2.0 * MU0)
    assert B == pytest.approx(2.0 / (2.0 * MU0 * (1.0 + 2.0 * MU0 / 0.4)),
                              rel=1e-15)


@pytest.mark.parametrize("shape,cell", GRIDS)
@pytest.mark.parametrize("lam0", [0.0, 0.4])
def test_hyper_green_twins_match_jax(shape, cell, lam0):
    g, jg = _grids(shape, cell)
    rng = np.random.default_rng(5)
    tau = rng.standard_normal((9,) + shape)
    f = rng.standard_normal((3,) + shape)
    E = rng.standard_normal(9)
    beta = 0.37
    tau_hat = jfft.fftn(jnp.asarray(tau))
    ref = jgreen.gamma_collocated_hyper(jg, E, MU0, lam0, tau_hat, -1.0, beta)
    out = green.gamma_collocated_hyper(g, E, MU0, lam0,
                                       torch.as_tensor(np.array(tau_hat)),
                                       -1.0, beta)
    assert _rel(out, ref) <= 1e-13
    ref = jgreen.gamma_collocated_hyper_fused(jg, E, MU0, lam0,
                                              jnp.asarray(tau), -1.0, beta)
    out = green.gamma_collocated_hyper_fused(g, torch.as_tensor(E), MU0,
                                             lam0, torch.as_tensor(tau),
                                             -1.0, beta)
    assert _rel(out, ref) <= 1e-13
    f_hat = jfft.fftn(jnp.asarray(f))
    ref = jgreen.g0_staggered_hyper(jg, MU0, lam0, f_hat)
    out = green.g0_staggered_hyper(g, MU0, lam0,
                                   torch.as_tensor(np.array(f_hat)))
    assert _rel(out, ref) <= 1e-13
    ref = jgreen.g0_staggered_hyper_fused(jg, MU0, lam0, jnp.asarray(f))
    out = green.g0_staggered_hyper_fused(g, MU0, lam0, torch.as_tensor(f))
    assert _rel(out, ref) <= 1e-13


@contextlib.contextmanager
def _forced_middle():
    old = (pc.MM_MIDDLE, pc.INTERPRET, jfft.FFT_BACKEND)
    pc.MM_MIDDLE, pc.INTERPRET = "on", True
    jfft.FFT_BACKEND = "matmul"
    try:
        yield
    finally:
        pc.MM_MIDDLE, pc.INTERPRET, jfft.FFT_BACKEND = old


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-10),
                                       (np.float32, 1e-5)])
def test_hyper_chains_match_pallas_middle(dtype, tol, monkeypatch):
    """#9'' pallas_chain._middle with the 9-component part of
    green.gamma_collocated_hyper_fused, and #7'' with _g0_apply at the
    full-gradient constants (g0_staggered_hyper_fused), in interpret mode,
    against the K5 (C = 9) and K3 twins on (8, 6, 7)."""
    shape = (8, 6, 7)
    g, jg = _grids(shape, (1.2, 0.8, 1.0))
    rng = np.random.default_rng(6)
    tau = rng.standard_normal((9,) + shape).astype(dtype)
    f = rng.standard_normal((3,) + shape).astype(dtype)
    E = rng.standard_normal(9).astype(dtype)
    called = []
    for name in ("gamma_collocated_middle", "g0_staggered_middle"):
        orig = getattr(pc, name)
        monkeypatch.setattr(pc, name, lambda *a, _o=orig, _n=name, **k: (
            called.append(_n), _o(*a, **k))[1])
    with _forced_middle():
        ref9 = jgreen.gamma_collocated_hyper_fused(jg, E, MU0, 0.0,
                                                   jnp.asarray(tau), -1.0,
                                                   0.37)
        ref3 = jgreen.g0_staggered_hyper_fused(jg, MU0, 0.0, jnp.asarray(f))
    assert called == ["gamma_collocated_middle", "g0_staggered_middle"]
    t = torch.as_tensor
    out9 = green.gamma_collocated_hyper_fused(g, t(E), MU0, 0.0, t(tau),
                                              -1.0, 0.37)
    out3 = green.g0_staggered_hyper_fused(g, MU0, 0.0, t(f))
    assert out9.dtype == out3.dtype == t(tau).dtype
    assert _rel(out9, ref9) <= tol and _rel(out3, ref3) <= tol


@pytest.mark.parametrize("scheme", ["staggered", "collocated"])
@pytest.mark.parametrize("lam0,beta", [(0.0, 0.0), (0.4, 0.3)])
def test_gamma_hyper_matches_gamma_operator(scheme, lam0, beta):
    g, jg = _grids((9, 7, 5), (1.2, 0.8, 1.0))
    rng = np.random.default_rng(7)
    tau = rng.standard_normal((9, 9, 7, 5))
    E = rng.standard_normal(9)
    ref = jgamma.gamma_operator(jg, "hyperelasticity", scheme, None, E, MU0,
                                lam0, jnp.asarray(tau), -1.0, beta)
    out = gamma.gamma_hyper(g, scheme, torch.as_tensor(E), MU0, lam0,
                            torch.as_tensor(tau), -1.0, beta)
    assert _rel(out, ref) <= 1e-13


def test_hyper_chain_wrapper_counts_no_launch_on_the_cpu():
    g = Grid(5, 4, 3)
    tau = torch.as_tensor(np.random.default_rng(8).standard_normal(
        (9, 5, 4, 3)))
    before = dict(spectral_kernels.launches)
    out = spectral_kernels.gamma_collocated_hyper_chain(g, tau, 0.5, -0.3,
                                                        np.ones(9), 0.2)
    assert out.shape == tau.shape and spectral_kernels.launches == before
    with pytest.raises(ValueError, match="E has"):
        spectral_kernels.gamma_collocated_hyper_chain(g, tau, 0.5, -0.3,
                                                      np.ones(6), 0.2)


# ------------------------------------------------------------ the solves

def _sphere(shape):
    ax = [(np.arange(s) + 0.5) / s - 0.5 for s in shape]
    X, Y, Z = np.meshgrid(*ax, indexing="ij")
    return ((X * X + Y * Y + Z * Z) < 0.09).astype(np.float64)


def _laminate(shape):
    x = (np.arange(shape[0]) + 0.5) / shape[0]
    return np.broadcast_to((x < 0.5)[:, None, None], shape).astype(np.float64)


# geometry -> (shape, phi, law, (fibre, matrix) moduli, loading F)
GEOMETRIES = {
    # bench_hyper_newton's two-phase SVK sphere at 2 % stretch
    "svk-sphere": ((9, 7, 5), _sphere, "svk", ((10.0, 5.0), (1.0, 1.0)),
                   [1.02, 1, 1, 0, 0, 0, 0, 0, 0]),
    # a Neo-Hooke laminate under stretch and shear
    "neohooke-laminate": ((8, 4, 3), _laminate, "neohooke",
                          ((5.0, 2.0), (1.0, 1.0)),
                          [1.03, 0.99, 1, 0, 0.02, 0, 0, 0, 0]),
}
_JAX_CACHE = {}


def _solvers(geometry, **opts):
    shape, mk_phi, law, moduli, load = GEOMETRIES[geometry]
    phi = mk_phi(shape)
    jcls = {"svk": jlaws.SaintVenantKirchhoff, "neohooke": jlaws.NeoHooke}
    jmat = fg.VoigtMixed([
        fg.Phase("fiber", jcls[law](*moduli[0]), jnp.asarray(phi)),
        fg.Phase("matrix", jcls[law](*moduli[1]), jnp.asarray(1.0 - phi))],
        dim=9)
    opts = dict(mode="hyperelasticity", method="cg", dtype="float64",
                maxiter=500, **opts)
    js = fg.LSSolver(fg.Grid(*shape), jmat, fg.SolverOptions(**opts))
    js.set_strain(load)
    pmat = ft.convert.material_from_numpy(
        [("fiber", *moduli[0], phi), ("matrix", *moduli[1], 1.0 - phi)],
        dim=9, law=law, device="cpu")
    ps = ft.LSSolver(ft.Grid(*shape), pmat,
                     ft.convert.options_from_dict(opts), device="cpu")
    ps.set_strain(load)
    return js, ps


@pytest.fixture(scope="module")
def jax_solves():
    """The JAX reference solves, each run once for the module (keyed by
    geometry and options)."""
    def get(geometry, **opts):
        key = (geometry, tuple(sorted(opts.items())))
        if key not in _JAX_CACHE:
            js, _ = _solvers(geometry, **opts)
            assert not js.run()
            _JAX_CACHE[key] = js
        return _JAX_CACHE[key]
    return get


def _port(geometry, **opts):
    ps = _solvers(geometry, **opts)[1]
    assert not ps.run()
    return ps


def _close(ps, js, S_rtol):
    S_ref = np.asarray(js.calc_mean_stress())
    np.testing.assert_allclose(ps.calc_mean_stress(), S_ref, rtol=0,
                               atol=S_rtol * np.max(np.abs(S_ref)))


# per geometry: the estimators and the tolerance of the parity solves.  The
# residual estimator stops at 1e-6: below about 3e-7 of the first inner
# residual the recursive CG residual carries float64 rounding noise that
# CG amplifies past 1e-9 relative
ESTIMATORS = {"svk-sphere": dict(error_estimator="residual",
                                 outer_error_estimator="epsilon", tol=1e-6),
              "neohooke-laminate": dict(tol=1e-8)}


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
@pytest.mark.parametrize("scheme", ["staggered", "collocated"])
@pytest.mark.parametrize("tangent", ["exact", "frozen_iso"])
def test_newton_matches_jax(jax_solves, geometry, scheme, tangent):
    """check_every=1: the same residual history (inner and outer entries)
    within 1e-9 (the epsilon estimator's entries, differences of two
    norms, within 1e-14 absolute), fields within 1e-9, mean stress within
    1e-10, with the same reference material."""
    opts = dict(gamma_scheme=scheme, newton_tangent=tangent,
                **ESTIMATORS[geometry])
    js = jax_solves(geometry, **opts)
    ps = _port(geometry, **opts)
    assert ps.scheme == js.scheme == scheme
    assert ps.mu_0 == pytest.approx(js.mu_0, rel=1e-12)
    assert ps.lambda_0 == js.lambda_0 == 0.0
    rj, rp = np.asarray(js.residuals), np.asarray(ps.residuals)
    assert len(rp) == len(rj)
    np.testing.assert_allclose(rp, rj, rtol=1e-9, atol=1e-14)
    assert np.max(np.abs(ps.get_field("epsilon") - np.asarray(js.eps))) \
        <= 1e-9
    _close(ps, js, 1e-10)
    np.testing.assert_allclose(ps.calc_mean_strain(),
                               GEOMETRIES[geometry][4], atol=1e-12)
    np.testing.assert_allclose(ps.calc_mean_cauchy(), js.calc_mean_cauchy(),
                               rtol=0, atol=1e-10)
    assert ps.calc_mean_energy() == pytest.approx(js.calc_mean_energy(),
                                                  rel=1e-9)
    assert ps.calc_min_det_f() == pytest.approx(js.calc_min_det_f(),
                                                rel=1e-12)
    outer, inner = ps.newton_iterations
    assert outer >= 2 and inner + outer == len(rp)


def test_newton_check_every_4_matches_jax(jax_solves):
    """check_every=4: the JAX package acts on each chunk one dispatch
    behind and keeps the next chunk's field, this port stops at the chunk
    that converged; converged to 1e-10 the mean stress agrees within
    1e-7."""
    opts = dict(gamma_scheme="staggered", tol=1e-10, check_every=4,
                error_estimator="residual", outer_error_estimator="epsilon")
    js = jax_solves("svk-sphere", **opts)
    ps = _port("svk-sphere", **opts)
    _close(ps, js, 1e-7)
    assert abs(len(ps.residuals) - len(js.residuals)) <= 8


def test_newton_sigma_and_energy_estimators_match_jax(jax_solves):
    """The sigma estimator inside, the energy estimator outside; their
    entries are relative changes of a mean (differences of two numbers),
    so they agree within 1e-9 relative or 1e-14 absolute."""
    opts = dict(error_estimator="sigma", outer_error_estimator="energy",
                gamma_scheme="collocated", tol=1e-6)
    js = jax_solves("svk-sphere", **opts)
    ps = _port("svk-sphere", **opts)
    rj, rp = np.asarray(js.residuals), np.asarray(ps.residuals)
    assert len(rp) == len(rj) and ps.newton_iterations[0] >= 2
    np.testing.assert_allclose(rp, rj, rtol=1e-9, atol=1e-14)
    _close(ps, js, 1e-10)


def test_newton_outer_estimator_distinct_from_inner():
    """Residual inner / epsilon outer drives the outer loop with the
    epsilon metric (fed the inner kind's empty metric, the outer loop
    would stop after one iteration, 0.8 % off on the JAX package's bench
    sphere): both tangents take several outer iterations and agree with a
    tight default-estimator solve within 1e-6 of the largest stress."""
    S_ref = _port("svk-sphere", tol=1e-11).calc_mean_stress()
    for tangent in ("exact", "frozen_iso"):
        ps = _port("svk-sphere", tol=1e-8, newton_tangent=tangent,
                   error_estimator="residual",
                   outer_error_estimator="epsilon")
        assert ps.newton_iterations[0] >= 2
        np.testing.assert_allclose(ps.calc_mean_stress(), S_ref, rtol=0,
                                   atol=1e-6 * np.max(np.abs(S_ref)))


def _compression(lmbda, splits, maxiter=400):
    phi = _laminate((8, 4, 4))
    mat = ft.convert.material_from_numpy(
        [("m1", 1.0, 1.0, phi), ("m2", 3.0, 2.0, 1.0 - phi)], dim=9,
        law="svk", device="cpu")
    s = ft.LSSolver(ft.Grid(8, 4, 4), mat, ft.SolverOptions(
        mode="hyperelasticity", tol=1e-8, maxiter=maxiter,
        max_loadstep_splits=splits), device="cpu")
    s.set_strain([lmbda, 1, 1, 0, 0, 0, 0, 0, 0])
    return s


def test_loadstep_split_recovers_divergent_svk():
    """28 % SVK compression in one loadstep meets an indefinite inner
    operator; without splits the run fails, with them it restores the
    state, inserts midpoint loadsteps and converges.  An unreachable load
    stops after ``max_loadstep_splits``."""
    s0 = _compression(0.72, splits=0)
    assert s0.run() and s0._diverged
    s1 = _compression(0.72, splits=8)
    assert not s1.run()
    F = s1.calc_mean_strain()
    assert F[0] == pytest.approx(0.72, rel=1e-6)
    assert F[1] == pytest.approx(1.0, rel=1e-6)
    assert _compression(0.35, splits=2, maxiter=150).run()


def test_nan_marks_the_solve_diverged():
    s = _compression(1.0, splits=0)
    assert s._converged(3, float("nan"), float("nan")) == (3, True)
    assert s._canceled and s._diverged


def test_loadsteps_reach_the_same_solution():
    one = _compression(0.9, splits=0)
    three = _compression(0.9, splits=0)
    three.opt.loadsteps = 3
    assert not one.run() and not three.run()
    np.testing.assert_allclose(three.calc_mean_stress(),
                               one.calc_mean_stress(), rtol=1e-6, atol=1e-9)


def test_hyper_svk_small_strain_matches_linear():
    """SVK Newton-Krylov at a tiny strain gives the linear laminate's
    response."""
    phi = _laminate((8, 4, 4))
    h = 1e-5
    lin = ft.convert.material_from_numpy(
        [("m1", 1.0, 1.0, phi), ("m2", 3.0, 2.0, 1.0 - phi)], device="cpu")
    sl = ft.LSSolver(ft.Grid(8, 4, 4), lin, ft.SolverOptions(
        tol=1e-12, maxiter=2000), device="cpu")
    sl.set_strain([h, 0, 0, 0, 0, 0])
    assert not sl.run()
    sh = _compression(1.0 + h, splits=8)
    sh.opt.tol = 1e-10
    assert not sh.run()
    np.testing.assert_allclose(sh.calc_mean_stress()[:6],
                               sl.calc_mean_stress(), rtol=1e-3,
                               atol=1e-10 * h)


def test_hyper_options():
    mat = ft.convert.material_from_numpy(
        [("a", 1.0, 1.0, np.ones((4, 4, 4)))], dim=9, law="svk",
        device="cpu")
    # basic, nesterov, basic+el and nl_cg run in hyperelasticity
    # (test_torch_hyper_methods.py); polarization stays refused (the
    # hyperelastic laws have none) and Willot is not a finite-strain
    # scheme, as in the JAX package
    for kw in ({"method": "basic"}, {"method": "nesterov"},
               {"method": "basic+el"}, {"method": "nl_cg"}):
        ft.LSSolver(ft.Grid(4, 4, 4), mat, ft.SolverOptions(
            mode="hyperelasticity", **kw), device="cpu")
    with pytest.raises(NotImplementedError, match="no polarization"):
        ft.LSSolver(ft.Grid(4, 4, 4), mat, ft.SolverOptions(
            mode="hyperelasticity", method="polarization"), device="cpu")
    with pytest.raises(ValueError, match="Unknown gamma scheme 'willot'"):
        ft.LSSolver(ft.Grid(4, 4, 4), mat, ft.SolverOptions(
            mode="hyperelasticity", gamma_scheme="willot"), device="cpu")
    # the sigma estimator runs in the linear modes too: a homogeneous
    # material converges at once to its stress
    lin = ft.convert.material_from_numpy(
        [("a", 1.0, 1.0, np.ones((4, 4, 4)))], device="cpu")
    s = ft.LSSolver(ft.Grid(4, 4, 4), lin, ft.SolverOptions(
        error_estimator="sigma"), device="cpu")
    s.set_strain([1.0, 0, 0, 0, 0, 0])
    assert not s.run()
    np.testing.assert_allclose(s.calc_mean_stress(), [3.0, 1, 1, 0, 0, 0],
                               atol=1e-14)
    # the loadstep options run in every mode (one loadstep loop)
    for m, mode in ((lin, "elasticity"), (mat, "hyperelasticity")):
        for kw in ({"loadsteps": 2}, {"first_loadstep": 0},
                   {"max_loadstep_splits": 2},
                   {"loadstep_extrapolation_order": 1},
                   {"loadstep_extrapolation_method": "transformation"},
                   {"bc_relax": 0.5}):
            ft.LSSolver(ft.Grid(4, 4, 4), m, ft.SolverOptions(
                mode=mode, **kw), device="cpu")
    s = ft.LSSolver(ft.Grid(4, 4, 4), mat, ft.SolverOptions(
        mode="hyperelasticity", loadsteps=2, newton_relax=0.9,
        outer_error_estimator="sigma"), device="cpu")
    assert s.dim == 9 and s.scheme == "staggered"


def test_set_strain_takes_six_values_in_dim_9():
    """Six values in dim 9 mirror their shear entries into the last three,
    as the JAX package's _fit_vec does; nine are kept, fewer padded."""
    mat = ft.convert.material_from_numpy(
        [("a", 1.0, 1.0, np.ones((4, 4, 4)))], dim=9, law="svk",
        device="cpu")
    s = ft.LSSolver(ft.Grid(4, 4, 4), mat, ft.SolverOptions(
        mode="hyperelasticity"), device="cpu")
    jmat = fg.VoigtMixed([fg.Phase("a", jlaws.SaintVenantKirchhoff(
        mu=1.0, lam=1.0), jnp.ones((4, 4, 4)))], dim=9)
    js = fg.LSSolver(fg.Grid(4, 4, 4), jmat, fg.SolverOptions(
        mode="hyperelasticity"))
    for e in ([1.02, 1.0, 0.99, 0.01, 0.02, 0.03],
              [1.02, 1.0, 0.99, 0.01, 0.02, 0.03, 0.04, 0.05, 0.06],
              [1.02, 1.0]):
        s.set_strain(e)
        s.set_stress(e)
        js.set_strain(e)
        np.testing.assert_array_equal(s.E, js.E)
        np.testing.assert_array_equal(s.S, s.E)
    s.set_strain([1.02, 1.0, 0.99, 0.01, 0.02, 0.03])
    np.testing.assert_array_equal(
        s.E, [1.02, 1.0, 0.99, 0.01, 0.02, 0.03, 0.01, 0.02, 0.03])
