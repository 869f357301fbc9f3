"""The port's heat, porous-flow and viscosity solves against the JAX package:
the same staggered CG on the bench's sphere RVE, iteration for iteration, in
float64 on the CPU (the port's plain path); the viscosity solve also against
the JAX package's fused sweep path in float32; and the series-laminate
conductivity oracle."""
import math

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import fibergen_tpu as fg
import fibergen_tpu_torch as ft
from fibergen_tpu.ops import pallas_kernels as pk
from fibergen_tpu.utils.logging import LOG as JLOG
from fibergen_tpu_torch.utils.logging import LOG

torch.set_num_threads(2)

# mode -> (dim, loading, (fibre, matrix) mu): conductivities for heat and
# porous flow, fluidities for viscosity (the bench's contrast of 10)
MODES = {
    "heat": (3, [1.0, 0.0, 0.0], (10.0, 1.0)),
    "porous": (3, [0.0, 0.3, 1.0], (10.0, 1.0)),
    "viscosity": (6, [0.0, 0.0, 0.0, 0.0, 1.0, 0.0], (0.1, 1.0)),
}


@pytest.fixture(autouse=True)
def _quiet():
    old = (JLOG.enabled, LOG.enabled)
    JLOG.enabled = LOG.enabled = False
    yield
    JLOG.enabled, LOG.enabled = old


def _sphere(shape):
    """bench.py's inclusion: a centred sphere of radius 0.3."""
    ax = [(np.arange(s) + 0.5) / s - 0.5 for s in shape]
    X, Y, Z = np.meshgrid(*ax, indexing="ij")
    return ((X * X + Y * Y + Z * Z) < 0.09).astype(np.float64)


def _jax_material(phi, dim, mus):
    return fg.VoigtMixed([
        fg.Phase("fiber", fg.ScalarLinearIsotropic(mu=mus[0], dim=dim),
                 jnp.asarray(phi)),
        fg.Phase("matrix", fg.ScalarLinearIsotropic(mu=mus[1], dim=dim),
                 jnp.asarray(1.0 - phi))], dim=dim)


def _port_solver(js, opts, dtype=np.float64):
    """The port's solver for the JAX solver ``js``'s problem, carried
    across as numpy values."""
    g = js.grid
    pmat = ft.convert.material_from_numpy(
        [(p.name, p.law.mu, np.asarray(p.phi, dtype)) for p in js.mat.phases],
        dim=js.mat.dim, device="cpu", law="scalar")
    ps = ft.LSSolver(
        ft.convert.grid_from_numpy(g.shape, (g.dx, g.dy, g.dz)), pmat,
        ft.convert.options_from_dict(opts), device="cpu")
    ps.set_strain(js.E)
    return ps


def _jax_eps_after(s, n_steps):
    """The JAX solver's CG state after exactly ``n_steps`` steps.  Its
    chunked host loop runs one chunk past the one where it detects
    convergence, the port none, so the fields compare at the port's step
    count."""
    mf = s.mat.fields()
    E = jnp.asarray(s.E, s.dtype)
    eps, r, p, gamma, gamma_prev, _ = s._k_cg_init(
        mf, E, None, mu0=s.mu_0, lam0=s.lambda_0)
    for _ in range(n_steps):
        eps, r, p, gamma, gamma_prev, _ = s._k_cg_step(
            mf, eps, r, p, gamma, gamma_prev, None, mu0=s.mu_0,
            lam0=s.lambda_0)
    return eps


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("shape", [(15, 13, 11), (16, 12, 10)])
@pytest.mark.parametrize("check_every", [1, 4])
def test_mode_solve_matches_jax(mode, shape, check_every):
    dim, load, mus = MODES[mode]
    opts = dict(mode=mode, method="cg", gamma_scheme="staggered",
                dtype="float64", check_every=check_every,
                error_estimator="residual", tol=1e-10, maxiter=500)
    js = fg.LSSolver(fg.Grid(*shape), _jax_material(_sphere(shape), dim, mus),
                     fg.SolverOptions(**opts))
    js.set_strain(load)
    assert not js.run()
    ps = _port_solver(js, opts)
    assert not ps.run()

    assert ps.mu_0 == js.mu_0 and ps.lambda_0 == js.lambda_0 == 0.0
    rj, rp = np.asarray(js.residuals), np.asarray(ps.residuals)
    assert len(rp) == len(rj)
    np.testing.assert_allclose(rp, rj, rtol=1e-9, atol=0)

    steps = math.ceil(len(rp) / check_every) * check_every
    eps_ref = _jax_eps_after(js, steps)
    eps = ps.get_field("epsilon")
    assert eps.shape == (dim,) + shape
    assert np.max(np.abs(eps - np.asarray(eps_ref))) <= 1e-9
    S_ref = np.asarray(js.mat.mean_pk1(eps_ref))
    np.testing.assert_allclose(ps.calc_mean_stress(), S_ref, rtol=0,
                               atol=1e-10 * np.max(np.abs(S_ref)))
    np.testing.assert_allclose(ps.calc_mean_strain(), load, atol=1e-12)


@pytest.mark.parametrize("mode", ["heat", "viscosity"])
def test_mode_solve_with_epsilon_estimator_matches_jax(mode):
    """The epsilon estimator on dim-3 and dim-6 fields of the new modes."""
    shape = (15, 13, 11)
    dim, load, mus = MODES[mode]
    opts = dict(mode=mode, method="cg", gamma_scheme="staggered",
                dtype="float64", check_every=4, error_estimator="epsilon",
                tol=1e-6, maxiter=500)
    js = fg.LSSolver(fg.Grid(*shape), _jax_material(_sphere(shape), dim, mus),
                     fg.SolverOptions(**opts))
    js.set_strain(load)
    assert not js.run()
    ps = _port_solver(js, opts)
    assert not ps.run()
    rj, rp = np.asarray(js.residuals), np.asarray(ps.residuals)
    assert len(rp) == len(rj)
    np.testing.assert_allclose(rp, rj, rtol=1e-9, atol=1e-15)


def test_viscosity_matches_jax_fused_sweep_path():
    """The port's viscosity CG (K1 tau-sum, dual K3, K2 Delta twins) against
    the JAX package's fused sweep path (Pallas interpret mode) in float32 at
    (8, 8, 128): iterations within 1 and mean stress within 5e-4, the
    tolerances of the JAX package's own fused-vs-generic test (its sweep
    sums with Kahan in float32, the port in float64)."""
    shape = (8, 8, 128)
    x = (np.arange(shape[0]) + 0.5) / shape[0]
    phi = np.broadcast_to((x < 0.5)[:, None, None], shape).astype(np.float32)
    opts = dict(mode="viscosity", method="cg", gamma_scheme="staggered",
                tol=1e-5, maxiter=400, dtype="float32")
    old = pk.INTERPRET
    pk.INTERPRET = True
    try:
        js = fg.LSSolver(fg.Grid(*shape), _jax_material(phi, 6, (1.0, 8.0)),
                         fg.SolverOptions(use_pallas="on", **opts))
        assert js._visc_pallas, "the fused viscosity path must engage"
        js.set_strain([0, 0, 0, 0, 1.0, 0])
        assert not js.run()
    finally:
        pk.INTERPRET = old
    ps = _port_solver(js, opts, np.float32)
    assert not ps.run()
    assert ps.mu_0 == js.mu_0
    assert abs(len(ps.residuals) - len(js.residuals)) <= 1
    np.testing.assert_allclose(ps.calc_mean_stress(),
                               np.asarray(js.calc_mean_stress()), rtol=5e-4,
                               atol=1e-5)


def test_heat_laminate_oracle():
    """x-laminate under a unit x gradient: the effective conductivity is
    the harmonic mean of the phases' (series conduction), exact on the
    staggered grid."""
    shape = (32, 4, 4)
    x = (np.arange(shape[0]) + 0.5) / shape[0]
    phi = np.broadcast_to((x < 0.5)[:, None, None], shape).astype(np.float64)
    k1, k2 = 1.0, 10.0
    mat = ft.convert.material_from_numpy(
        [("a", k1, phi), ("b", k2, 1.0 - phi)], dim=3, device="cpu",
        law="scalar")
    s = ft.LSSolver(ft.Grid(*shape), mat, ft.SolverOptions(
        mode="heat", tol=1e-10, error_estimator="residual", check_every=4,
        maxiter=200), device="cpu")
    s.set_strain([1.0, 0, 0])
    assert not s.run()
    assert len(s.residuals) < s.opt.maxiter
    S = s.calc_mean_stress()
    assert S[0] == pytest.approx(2 * k1 * k2 / (k1 + k2), rel=1e-12)
    np.testing.assert_allclose(S[1:], 0.0, atol=1e-12)


def test_unported_viscosity_variants_raise():
    """Lambda-carrying viscosity laws and the half/full staggered schemes
    go through the JAX package's generic Delta path, not ported yet."""
    phi = np.ones((4, 4, 4))
    iso = ft.convert.material_from_numpy([("a", 1.0, 0.5, phi)],
                                         device="cpu")
    with pytest.raises(NotImplementedError, match="lambda"):
        ft.LSSolver(ft.Grid(4, 4, 4), iso,
                    ft.SolverOptions(mode="viscosity"), device="cpu")
    scal = ft.convert.material_from_numpy([("a", 1.0, phi)], device="cpu",
                                          law="scalar")
    for scheme in ("half_staggered", "full_staggered"):
        with pytest.raises(NotImplementedError):
            ft.LSSolver(ft.Grid(4, 4, 4), scal, ft.SolverOptions(
                mode="viscosity", gamma_scheme=scheme), device="cpu")
    with pytest.raises(ft.solvers.ls.SolverError):
        ft.LSSolver(ft.Grid(4, 4, 4), scal, ft.SolverOptions(mode="heat"),
                    device="cpu")
    with pytest.raises(ValueError, match="law"):
        ft.convert.material_from_numpy([("a", 1.0, phi)], device="cpu",
                                       law="general")
