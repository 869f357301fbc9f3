"""The port's collocated Gamma scheme against the JAX package, in float64 on
the CPU (the port's plain path):

* Grid.xi, the zero-trace transforms and the polarization laws;
* the K5 (6 and 3 components) and K6 chains' plain twins against
  fibergen_tpu's green.gamma_collocated_fused / _heat_fused / _zt_fused
  and against the Pallas middle they replace, in interpret mode;
* the collocated CG in elasticity, heat, porous flow and viscosity (also
  with a lambda phase), iteration for iteration; the basic scheme in the
  four modes and the polarization scheme in elasticity, heat and porous
  flow, with the same reference material;
* the x-laminates' analytic C11 and conductivity through the collocated CG.

The CUDA kernels against their twins are in test_torch_cuda.py.
"""
import contextlib
import math

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import fibergen_tpu as fg
import fibergen_tpu_torch as ft
from fibergen_tpu.core.grid import Grid as JGrid
from fibergen_tpu.materials import laws as jlaws
from fibergen_tpu.materials import mixing as jmixing
from fibergen_tpu.ops import fft as jfft
from fibergen_tpu.ops import green as jgreen
from fibergen_tpu.ops import pallas_chain as pc
from fibergen_tpu.utils.logging import LOG as JLOG
from fibergen_tpu_torch.core.grid import Grid
from fibergen_tpu_torch.materials import laws, mixing
from fibergen_tpu_torch.ops import fft, green
from fibergen_tpu_torch.utils.logging import LOG

torch.set_num_threads(2)

GRIDS = [((15, 13, 11), (1.2, 0.8, 1.0)),
         ((16, 12, 10), (1.2, 0.8, 1.0)),
         ((16, 12, 10), (1.0, 1.0, 1.0))]
MU0, LAM0 = 1.7, 0.3


@pytest.fixture(autouse=True)
def _quiet():
    old = (JLOG.enabled, LOG.enabled)
    JLOG.enabled = LOG.enabled = False
    yield
    JLOG.enabled, LOG.enabled = old


def _grids(shape, cell):
    kw = dict(dx=cell[0], dy=cell[1], dz=cell[2])
    return Grid(*shape, **kw), JGrid(*shape, **kw)


def _t(x, dtype=torch.float64):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _rel(a, ref):
    """Max-abs error relative to the reference's max-abs (complex values
    compare as their real and imaginary parts)."""
    a, ref = np.asarray(a), np.asarray(ref)
    if np.iscomplexobj(ref):
        a, ref = np.stack([a.real, a.imag]), np.stack([ref.real, ref.imag])
    return np.max(np.abs(a - ref)) / np.max(np.abs(ref))


def _traceless(rng, shape):
    tau = rng.standard_normal((6,) + shape)
    tau[0] = -(tau[1] + tau[2])
    return tau


# ------------------------------------------------- grid, transforms, laws

@pytest.mark.parametrize("shape,cell", GRIDS)
@pytest.mark.parametrize("two_pi", [False, True])
def test_grid_xi_matches_jax(shape, cell, two_pi):
    g, jg = _grids(shape, cell)
    for a, b in zip(g.xi(two_pi), jg.xi(two_pi)):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape,cell", GRIDS[:2])
def test_zero_trace_transforms_match_jax(shape, cell):
    x = _traceless(np.random.default_rng(8), shape)
    y = fft.fftn_zero_trace(_t(x))
    y_ref = jfft.fftn_zero_trace(jnp.asarray(x))
    assert _rel(y.numpy(), np.asarray(y_ref)) <= 1e-13
    back = fft.ifftn_zero_trace(y, shape)
    assert _rel(back, jfft.ifftn_zero_trace(y_ref, shape)) <= 1e-13
    assert _rel(back, x) <= 1e-13


@pytest.mark.parametrize("inv", [False, True])
def test_polarization_laws_match_jax(inv):
    """Both laws' Eyre-Milton transform and its inverse, and the
    phi-weighted VoigtMixed one.  The scalar law uses its own mu against
    C0 = 2 mu_0 I, not the halved iso_moduli mu."""
    shape = (5, 4, 3)
    rng = np.random.default_rng(11)
    F6, F3 = rng.standard_normal((6,) + shape), rng.standard_normal((3,) +
                                                                     shape)
    cases = [(laws.LinearIsotropic(mu=2.0, lam=3.5),
              jlaws.LinearIsotropic(mu=2.0, lam=3.5), F6),
             (laws.ScalarLinearIsotropic(mu=4.0),
              jlaws.ScalarLinearIsotropic(mu=4.0), F3),
             (laws.ScalarLinearIsotropic(mu=0.3, dim=6),
              jlaws.ScalarLinearIsotropic(mu=0.3, dim=6), F6)]
    for law, jlaw, F in cases:
        out = law.polarization(1.3, _t(F), inv)
        ref = jlaw.polarization(1.3, jnp.asarray(F), inv)
        assert _rel(out, ref) <= 1e-15
    phi = (rng.random(shape) < 0.4).astype(np.float64)
    pmat = ft.convert.material_from_numpy(
        [("a", 10.0, 5.0, phi), ("b", 1.0, 1.0, 1.0 - phi)], device="cpu")
    jmat = jmixing.VoigtMixed([
        jmixing.Phase("a", jlaws.LinearIsotropic(mu=10.0, lam=5.0),
                      jnp.asarray(phi)),
        jmixing.Phase("b", jlaws.LinearIsotropic(mu=1.0, lam=1.0),
                      jnp.asarray(1.0 - phi))], dim=6)
    assert _rel(pmat.polarization(2.2, _t(F6), inv),
                jmat.polarization(2.2, jnp.asarray(F6), inv)) <= 1e-15


def test_voigt_polarization_needs_phi():
    phi = np.ones((4, 4, 4))
    mat = ft.convert.material_from_numpy([("a", 1.0, 0.5, phi)],
                                         device="cpu")
    F = torch.ones((6, 4, 4, 4), dtype=torch.float64)
    assert mat.polarization(1.0, F).shape == F.shape
    mat.drop_phi()
    with pytest.raises(ValueError, match="drop_phi"):
        mat.polarization(1.0, F)


# ------------------------------------------------------ the chains' twins

@pytest.mark.parametrize("shape,cell", GRIDS)
def test_collocated_twins_match_jax(shape, cell):
    """K5 (6 and 3 components) and K6 twins, and the hat-space operators,
    against the JAX package with a random E and beta != 0."""
    g, jg = _grids(shape, cell)
    rng = np.random.default_rng(12)
    tau6, tau3 = _traceless(rng, shape), rng.standard_normal((3,) + shape)
    E6, E3 = rng.standard_normal(6), rng.standard_normal(3)
    beta, alpha = 0.37, -1.4

    out = green.gamma_collocated_fused(g, _t(E6), MU0, LAM0, _t(tau6), alpha,
                                       beta)
    ref = jgreen.gamma_collocated_fused(jg, E6, MU0, LAM0, jnp.asarray(tau6),
                                        alpha, beta)
    assert out.shape == tau6.shape and _rel(out, ref) <= 1e-10
    out = green.gamma_collocated_heat_fused(g, _t(E3), MU0, LAM0, _t(tau3),
                                            alpha, beta)
    ref = jgreen.gamma_collocated_heat_fused(jg, E3, MU0, LAM0,
                                             jnp.asarray(tau3), alpha, beta)
    assert out.shape == tau3.shape and _rel(out, ref) <= 1e-10
    # the viscosity Delta scheme's constants: (-mu0, inf), beta = 2 alpha mu0v
    out = green.gamma_collocated_zt_fused(g, _t(E6), -MU0, float("inf"),
                                          _t(tau6), -1.0, -0.5 / MU0)
    ref = jgreen.gamma_collocated_zt_fused(jg, E6, -MU0, float("inf"),
                                           jnp.asarray(tau6), -1.0,
                                           -0.5 / MU0)
    assert _rel(out, ref) <= 1e-10
    np.testing.assert_allclose(out[0], -(out[1] + out[2]), atol=1e-13)

    hat6, hat3 = jfft.fftn(jnp.asarray(tau6)), jfft.fftn(jnp.asarray(tau3))
    out = green.gamma_collocated(g, E6, MU0, LAM0, _t(np.asarray(hat6),
                                                      torch.complex128),
                                 alpha, beta)
    ref = jgreen.gamma_collocated(jg, E6, MU0, LAM0, hat6, alpha, beta)
    assert _rel(out.numpy(), np.asarray(ref)) <= 1e-12
    out = green.gamma_collocated_heat(g, E3, MU0, LAM0,
                                      _t(np.asarray(hat3), torch.complex128),
                                      alpha, beta)
    ref = jgreen.gamma_collocated_heat(jg, E3, MU0, LAM0, hat3, alpha, beta)
    assert _rel(out.numpy(), np.asarray(ref)) <= 1e-12


def test_collocated_constants_are_finite_for_the_dual_scheme():
    """B = -alpha/(mu0 (1 + mu0/(lam0 + mu0))) stays finite with the
    viscosity Delta scheme's (-mu0, inf), in float32 and float64."""
    for mu0 in (0.275, 1e-3, 40.0):
        A, B = green.collocated_constants(-mu0, float("inf"))
        assert A == 0.5 / mu0 and B == -1.0 / mu0
        assert np.isfinite(np.float32(B)) and np.isfinite(np.float32(A))
    # freq_hack symmetrizes the Nyquist bins of even axes: a no-op on an
    # odd grid, a change on an even one (test_torch_methods.py holds it to
    # the JAX package)
    tau = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (6, 5, 4, 3)))
    for g, same in ((Grid(5, 4, 3), False), (Grid(5, 3, 3), True)):
        t = tau[:, :, :g.ny]
        a = green.gamma_collocated_fused(g, np.zeros(6), 1.0, 0.0, t,
                                         freq_hack=True)
        b = green.gamma_collocated_fused(g, np.zeros(6), 1.0, 0.0, t)
        assert (_rel(a.numpy(), b.numpy()) <= 1e-14) == same


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
def test_collocated_twins_match_pallas_middle(dtype, tol, monkeypatch):
    """#9 pallas_chain._middle with _gamma_collocated_apply (6 and 3
    components) and #10 with _zt_apply against the K5 and K6 twins on
    (8, 6, 7), the JAX package's fused entry points routed through the
    Pallas middle in interpret mode."""
    shape = (8, 6, 7)
    g, jg = _grids(shape, (1.2, 0.8, 1.0))
    rng = np.random.default_rng(13)
    tau6 = _traceless(rng, shape).astype(dtype)
    tau3 = rng.standard_normal((3,) + shape).astype(dtype)
    E6 = rng.standard_normal(6).astype(dtype)
    beta = 0.37
    called = []
    for name in ("gamma_collocated_middle", "gamma_collocated_zt_middle"):
        orig = getattr(pc, name)
        monkeypatch.setattr(pc, name, lambda *a, _o=orig, _n=name, **k: (
            called.append(_n), _o(*a, **k))[1])
    with _forced_middle():
        ref6 = jgreen.gamma_collocated_fused(jg, E6, MU0, LAM0,
                                             jnp.asarray(tau6), -1.0, beta)
        ref3 = jgreen.gamma_collocated_heat_fused(jg, E6[:3], MU0, LAM0,
                                                  jnp.asarray(tau3), -1.0,
                                                  beta)
        refz = jgreen.gamma_collocated_zt_fused(jg, E6, -MU0, float("inf"),
                                                jnp.asarray(tau6), -1.0,
                                                -0.5 / MU0)
    assert called == ["gamma_collocated_middle"] * 2 + [
        "gamma_collocated_zt_middle"]
    t = lambda a: torch.as_tensor(a)
    out6 = green.gamma_collocated_fused(g, t(E6), MU0, LAM0, t(tau6), -1.0,
                                        beta)
    out3 = green.gamma_collocated_heat_fused(g, t(E6[:3]), MU0, LAM0,
                                             t(tau3), -1.0, beta)
    outz = green.gamma_collocated_zt_fused(g, t(E6), -MU0, float("inf"),
                                           t(tau6), -1.0, -0.5 / MU0)
    for out, ref in ((out6, ref6), (out3, ref3), (outz, refz)):
        assert out.dtype == t(tau6).dtype
        assert _rel(out, ref) <= tol


# ------------------------------------------------------------ the solves

def _sphere(shape):
    """bench.py's inclusion: a centred sphere of radius 0.3."""
    ax = [(np.arange(s) + 0.5) / s - 0.5 for s in shape]
    X, Y, Z = np.meshgrid(*ax, indexing="ij")
    return ((X * X + Y * Y + Z * Z) < 0.09).astype(np.float64)


# case -> (mode, dim, law, (fibre, matrix) moduli, loading)
CASES = {
    "elasticity": ("elasticity", 6, "isotropic", ((10.0, 5.0), (1.0, 1.0)),
                   [1.0, 0.0, 0.0, 0.0, 0.0, 0.0]),
    "heat": ("heat", 3, "scalar", ((10.0,), (1.0,)), [1.0, 0.0, 0.0]),
    "porous": ("porous", 3, "scalar", ((10.0,), (1.0,)), [0.0, 0.3, 1.0]),
    "viscosity": ("viscosity", 6, "scalar", ((0.1,), (1.0,)),
                  [0.0, 0.0, 0.0, 0.0, 1.0, 0.0]),
    "viscosity-lambda": ("viscosity", 6, "isotropic",
                         ((0.1, 0.3), (1.0, 0.5)),
                         [0.0, 0.0, 0.0, 0.0, 1.0, 0.0]),
}


def _solvers(case, shape, cell, **opts):
    """The JAX solver and the port's on the same problem, both set up."""
    mode, dim, law, moduli, load = CASES[case]
    phi = _sphere(shape)
    jlaw = (lambda m: jlaws.LinearIsotropic(mu=m[0], lam=m[1], dim=dim)) \
        if law == "isotropic" else \
        (lambda m: jlaws.ScalarLinearIsotropic(mu=m[0], dim=dim))
    jmat = fg.VoigtMixed([
        fg.Phase("fiber", jlaw(moduli[0]), jnp.asarray(phi)),
        fg.Phase("matrix", jlaw(moduli[1]), jnp.asarray(1.0 - phi))], dim=dim)
    opts = dict(mode=mode, dtype="float64", **opts)
    js = fg.LSSolver(fg.Grid(*shape, dx=cell[0], dy=cell[1], dz=cell[2]),
                     jmat, fg.SolverOptions(**opts))
    js.set_strain(load)
    pmat = ft.convert.material_from_numpy(
        [("fiber", *moduli[0], phi), ("matrix", *moduli[1], 1.0 - phi)],
        dim=dim, device="cpu", law=law)
    ps = ft.LSSolver(ft.convert.grid_from_numpy(shape, cell), pmat,
                     ft.convert.options_from_dict(opts), device="cpu")
    ps.set_strain(load)
    return js, ps


def _jax_eps_after(s, n_steps):
    """The JAX solver's CG state after exactly ``n_steps`` steps (its
    chunked host loop runs one chunk past the one where it detects
    convergence, the port none)."""
    mf = s.mat.fields()
    E = jnp.asarray(s.E, s.dtype)
    eps, r, p, gamma, gamma_prev, _ = s._k_cg_init(
        mf, E, None, mu0=s.mu_0, lam0=s.lambda_0)
    for _ in range(n_steps):
        eps, r, p, gamma, gamma_prev, _ = s._k_cg_step(
            mf, eps, r, p, gamma, gamma_prev, None, mu0=s.mu_0,
            lam0=s.lambda_0)
    return eps


def _same_history(js, ps, rtol=1e-9, atol=0.0):
    assert ps.mu_0 == js.mu_0 and ps.lambda_0 == js.lambda_0 == 0.0
    rj, rp = np.asarray(js.residuals), np.asarray(ps.residuals)
    assert len(rp) == len(rj)
    np.testing.assert_allclose(rp, rj, rtol=rtol, atol=atol)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("shape,cell", GRIDS[:2])
@pytest.mark.parametrize("check_every", [1, 4])
def test_collocated_cg_matches_jax(case, shape, cell, check_every):
    js, ps = _solvers(case, shape, cell, method="cg",
                      gamma_scheme="collocated", check_every=check_every,
                      error_estimator="residual", tol=1e-10, maxiter=500)
    assert js.scheme == ps.scheme == "collocated"
    assert not js.run() and not ps.run()
    _same_history(js, ps)
    steps = math.ceil(len(ps.residuals) / check_every) * check_every
    eps_ref = np.asarray(_jax_eps_after(js, steps))
    eps = ps.get_field("epsilon")
    assert eps.shape == eps_ref.shape
    assert np.max(np.abs(eps - eps_ref)) <= 1e-9
    S_ref = np.asarray(js.mat.mean_pk1(jnp.asarray(eps_ref)))
    np.testing.assert_allclose(ps.calc_mean_stress(), S_ref, rtol=0,
                               atol=1e-10 * np.max(np.abs(S_ref)))
    np.testing.assert_allclose(ps.calc_mean_strain(), CASES[case][4],
                               atol=1e-12)


def _fixed_point_matches(js, ps):
    """Basic and polarization schemes: one metric read per iteration, the
    epsilon estimator.  It subtracts two strain norms and divides by one,
    so rounding in the norms (1e-16 of them) reaches its relative error as
    an absolute 1e-15 or so: histories agree to 1e-9 relative or 1e-14
    absolute."""
    assert not js.run() and not ps.run()
    _same_history(js, ps, atol=1e-14)
    S_ref = np.asarray(js.calc_mean_stress())
    np.testing.assert_allclose(ps.calc_mean_stress(), S_ref, rtol=0,
                               atol=1e-10 * np.max(np.abs(S_ref)))
    assert np.max(np.abs(ps.get_field("epsilon")
                         - np.asarray(js.eps))) <= 1e-9


@pytest.mark.parametrize("case,scheme", [
    ("elasticity", "collocated"), ("heat", "collocated"),
    ("porous", "collocated"), ("viscosity", "collocated"),
    ("elasticity", "staggered"), ("heat", "staggered"),
    ("viscosity", "staggered")])
def test_basic_matches_jax(case, scheme):
    js, ps = _solvers(case, (15, 13, 11), (1.2, 0.8, 1.0), method="basic",
                      gamma_scheme=scheme, error_estimator="epsilon",
                      tol=1e-6, maxiter=500)
    _fixed_point_matches(js, ps)


@pytest.mark.parametrize("case", ["elasticity", "heat", "porous"])
def test_polarization_matches_jax(case):
    """Eyre-Milton on the collocated grid, 'auto' resolving to it, with the
    reference material mu_0 = 0.5 sqrt(lmin lmax)."""
    js, ps = _solvers(case, (15, 13, 11), (1.2, 0.8, 1.0),
                      method="polarization", error_estimator="epsilon",
                      tol=1e-6, maxiter=500)
    assert js.scheme == ps.scheme == "collocated"
    _fixed_point_matches(js, ps)
    lmin, lmax = (float(x) for x in ps.mat.eig_range())
    assert ps.mu_0 == 0.5 * math.sqrt(lmin * lmax)


def test_scheme_resolution_matches_jax():
    """'auto' is staggered except under polarization, which also overrides
    a staggered scheme (with a warning), as in the JAX package."""
    for method in ("cg", "basic", "polarization"):
        for scheme in ("auto", "staggered", "collocated"):
            kw = dict(method=method, gamma_scheme=scheme)
            assert ft.SolverOptions(**kw).resolved_scheme() == \
                fg.SolverOptions(**kw).resolved_scheme()


def test_collocated_laminate_oracles():
    """x-laminates: fields that vary along x alone see the exact projection,
    so the collocated CG gives the analytic C11 and series conductivity."""
    shape = (32, 4, 4)
    x = (np.arange(shape[0]) + 0.5) / shape[0]
    phi = np.broadcast_to((x < 0.5)[:, None, None], shape).astype(np.float64)
    mat = ft.convert.material_from_numpy(
        [("a", 1.0, 2.0, phi), ("b", 10.0, 5.0, 1.0 - phi)], device="cpu")
    s = ft.LSSolver(ft.Grid(*shape), mat, ft.SolverOptions(
        gamma_scheme="collocated", tol=1e-10, error_estimator="residual",
        check_every=4, maxiter=200), device="cpu")
    s.set_strain([1.0, 0, 0, 0, 0, 0])
    assert not s.run()
    exact = 1.0 / (0.5 / (2.0 + 2 * 1.0) + 0.5 / (5.0 + 2 * 10.0))
    assert s.calc_mean_stress()[0] == pytest.approx(exact, rel=1e-12)
    mat = ft.convert.material_from_numpy(
        [("a", 1.0, phi), ("b", 10.0, 1.0 - phi)], dim=3, device="cpu",
        law="scalar")
    s = ft.LSSolver(ft.Grid(*shape), mat, ft.SolverOptions(
        mode="heat", gamma_scheme="collocated", tol=1e-10,
        error_estimator="residual", check_every=4, maxiter=200),
        device="cpu")
    s.set_strain([1.0, 0, 0])
    assert not s.run()
    S = s.calc_mean_stress()
    assert S[0] == pytest.approx(20.0 / 11.0, rel=1e-12)
    np.testing.assert_allclose(S[1:], 0.0, atol=1e-12)
