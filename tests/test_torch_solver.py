"""The port's whole slice against the JAX package: the same staggered CG
solve on the bench's sphere RVE, iteration for iteration, in float64 on the
CPU (the port's plain path)."""
import math

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import fibergen_tpu as fg
import fibergen_tpu_torch as ft
from fibergen_tpu.utils.logging import LOG as JLOG
from fibergen_tpu_torch.utils.logging import LOG

torch.set_num_threads(2)


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


@pytest.mark.parametrize("shape", [(15, 13, 11), (16, 12, 10)])
@pytest.mark.parametrize("check_every", [1, 4])
@pytest.mark.parametrize("estimator,tol", [("residual", 1e-10),
                                           ("epsilon", 1e-5)])
def test_solve_matches_jax(shape, check_every, estimator, tol):
    phi = _sphere(shape)
    grid = fg.Grid(*shape)
    mat = fg.VoigtMixed([
        fg.Phase("fiber", fg.LinearIsotropic(mu=10.0, lam=5.0),
                 jnp.asarray(phi)),
        fg.Phase("matrix", fg.LinearIsotropic(mu=1.0, lam=1.0),
                 jnp.asarray(1.0 - phi))], dim=6)
    opts = dict(mode="elasticity", method="cg", gamma_scheme="staggered",
                dtype="float64", check_every=check_every,
                error_estimator=estimator, tol=tol, maxiter=500)
    js = fg.LSSolver(grid, mat, fg.SolverOptions(**opts))
    js.set_strain([1.0, 0, 0, 0, 0, 0])
    assert not js.run()

    pgrid = ft.convert.grid_from_numpy(shape, (grid.dx, grid.dy, grid.dz))
    pmat = ft.convert.material_from_numpy(
        [(p.name, p.law.mu, p.law.lam, np.asarray(p.phi))
         for p in mat.phases], dim=6, device="cpu")
    ps = ft.LSSolver(pgrid, pmat, ft.convert.options_from_dict(opts),
                     device="cpu")
    ps.set_strain([1.0, 0, 0, 0, 0, 0])
    assert not ps.run()

    assert ps.mu_0 == js.mu_0 and ps.lambda_0 == js.lambda_0 == 0.0
    rj, rp = np.asarray(js.residuals), np.asarray(ps.residuals)
    assert len(rp) == len(rj)
    np.testing.assert_allclose(rp, rj, rtol=1e-9, atol=0)

    steps = math.ceil(len(rp) / check_every) * check_every
    eps_ref = _jax_eps_after(js, steps)
    eps = ps.get_field("epsilon")
    assert eps.shape == (6,) + shape
    assert np.max(np.abs(eps - np.asarray(eps_ref))) <= 1e-9
    S_ref = np.asarray(js.mat.mean_pk1(eps_ref))
    np.testing.assert_allclose(ps.calc_mean_stress(), S_ref, rtol=0,
                               atol=1e-10 * np.max(np.abs(S_ref)))
    np.testing.assert_allclose(ps.calc_mean_strain(), [1, 0, 0, 0, 0, 0],
                               atol=1e-12)


def test_laminate_oracle():
    """x-laminate under e_xx = 1: C11 is the harmonic mean of the phases'
    M = lam + 2 mu (series stiffness), exact on the staggered grid."""
    shape = (32, 4, 4)
    x = (np.arange(shape[0]) + 0.5) / shape[0]
    phi = np.broadcast_to((x < 0.5)[:, None, None], shape).astype(np.float64)
    (mu1, lam1), (mu2, lam2) = (1.0, 2.0), (10.0, 5.0)
    mat = ft.convert.material_from_numpy(
        [("a", mu1, lam1, phi), ("b", mu2, lam2, 1.0 - phi)], device="cpu")
    s = ft.LSSolver(ft.Grid(*shape), mat, ft.SolverOptions(
        tol=1e-10, error_estimator="residual", check_every=4, maxiter=200),
        device="cpu")
    s.set_strain([1.0, 0, 0, 0, 0, 0])
    assert not s.run()
    assert len(s.residuals) < s.opt.maxiter
    m1, m2 = lam1 + 2 * mu1, lam2 + 2 * mu2
    assert s.calc_mean_stress()[0] == pytest.approx(
        1.0 / (0.5 / m1 + 0.5 / m2), rel=1e-8)
