"""The port's multigrid G0 (solvers/multigrid.py) against the JAX package's,
in float64 on the CPU.

``poisson_multigrid`` and ``g0_multigrid_staggered`` on the same seeded
input as the JAX functions agree within 1e-10; the G0 they apply is the
FFT G0 (the K3 chain's twin) within 1e-10, by V-cycles and by the
V-cycle-preconditioned CG; and a solve with ``g0_solver="multigrid"``
walks the JAX package's multigrid solve (tests/test_solver.py:252-280)
and reaches the laminate's exact C11, without a chain application.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fibergen_tpu as fg
import fibergen_tpu_torch as ft
from fibergen_tpu.solvers import multigrid as jmg
from fibergen_tpu.utils.logging import LOG as JLOG
from fibergen_tpu_torch.ops import green, spectral_kernels
from fibergen_tpu_torch.solvers import multigrid as mg
from fibergen_tpu_torch.utils.logging import LOG

import _torch_demos as demos

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _quiet():
    old = (JLOG.enabled, LOG.enabled)
    JLOG.enabled = LOG.enabled = False
    yield
    JLOG.enabled, LOG.enabled = old


def _rand(shape, seed=3):
    return np.random.default_rng(seed).standard_normal(shape)


GRIDS = [((8, 8, 8), (1.0, 1.0, 1.0)), ((16, 8, 8), (1.3, 0.9, 1.1)),
         ((9, 7, 5), (1.0, 1.0, 1.0))]


@pytest.mark.parametrize("shape,cell", GRIDS)
def test_poisson_multigrid_matches_jax(shape, cell):
    b = _rand(shape)
    jgrid = fg.Grid(*shape, *cell)
    grid = ft.Grid(*shape, *cell)
    opt = dict(maxiter=6)
    u_j = np.asarray(jmg.poisson_multigrid(jgrid, jnp.asarray(b),
                                           jmg.MGOptions(**opt)))
    u = mg.poisson_multigrid(grid, torch.as_tensor(b), mg.MGOptions(**opt))
    np.testing.assert_allclose(u.numpy(), u_j, rtol=0,
                               atol=1e-10 * np.abs(u_j).max())
    # the FFT scheme solves outright: the V-cycles converge to it
    u_fft = mg.poisson_multigrid(grid, torch.as_tensor(b),
                                 mg.MGOptions(scheme="fft"))
    u_mg = mg.poisson_multigrid(grid, torch.as_tensor(b),
                                mg.MGOptions(maxiter=30))
    np.testing.assert_allclose(u_mg.numpy(), u_fft.numpy(), rtol=0,
                               atol=1e-10 * u_fft.abs().max().item())


@pytest.mark.parametrize("shape,cell", GRIDS)
@pytest.mark.parametrize("mu0,lam0,alpha", [(1.3, 0.0, -1.0),
                                            (2.5, 1.7, 0.5)])
def test_g0_multigrid_matches_jax_and_fft(shape, cell, mu0, lam0, alpha):
    tau = _rand((3,) + shape, seed=7)
    jgrid = fg.Grid(*shape, *cell)
    grid = ft.Grid(*shape, *cell)
    u_j = np.asarray(jmg.g0_multigrid_staggered(
        jgrid, mu0, lam0, jnp.asarray(tau), alpha, jmg.MGOptions(maxiter=8)))
    u = mg.g0_multigrid_staggered(grid, mu0, lam0, torch.as_tensor(tau),
                                  alpha, mg.MGOptions(maxiter=8))
    scale = np.abs(u_j).max()
    np.testing.assert_allclose(u.numpy(), u_j, rtol=0, atol=1e-10 * scale)
    u_fft = green.g0_staggered_fused(grid, mu0, lam0, torch.as_tensor(tau),
                                     alpha).numpy()
    for opt in (mg.MGOptions(maxiter=40),
                mg.MGOptions(scheme="pcg", tol=1e-14, maxiter=40)):
        u = mg.g0_multigrid_staggered(grid, mu0, lam0, torch.as_tensor(tau),
                                      alpha, opt)
        np.testing.assert_allclose(u.numpy(), u_fft, rtol=0,
                                   atol=1e-10 * np.abs(u_fft).max())


def test_pcg_converges_faster_than_direct():
    """One symmetric V-cycle preconditions CG: after ten V-cycles its error
    is a hundredth of the plain cycling's at most, and it reaches 1e-10
    within 30."""
    grid = ft.Grid(32, 32, 16)
    b = torch.as_tensor(_rand(grid.shape))
    u_fft = mg.poisson_multigrid(grid, b, mg.MGOptions(scheme="fft"))

    def err(scheme, n):
        u = mg.poisson_multigrid(grid, b, mg.MGOptions(scheme=scheme,
                                                       maxiter=n, tol=0.0))
        return float((u - u_fft).abs().max() / u_fft.abs().max())

    assert err("pcg", 10) <= 1e-2 * err("direct", 10)
    assert err("pcg", 30) <= 1e-10


def test_unknown_scheme_raises():
    with pytest.raises(ValueError, match="multigrid scheme"):
        mg.poisson_multigrid(ft.Grid(4, 4, 4), torch.zeros(4, 4, 4),
                             mg.MGOptions(scheme="w-cycle"))


def _laminate(shape):
    x = (np.arange(shape[0]) + 0.5) / shape[0]
    return np.broadcast_to((x < 0.5)[:, None, None], shape).astype(
        np.float64)


def _solvers(shape, phi, g0_solver="multigrid", jax=True):
    m1, m2 = (1.0, 1.0), (5.0, 2.0)
    opts = dict(mode="elasticity", method="cg", gamma_scheme="staggered",
                g0_solver=g0_solver, tol=1e-8, maxiter=200,
                dtype="float64", error_estimator="residual")
    pmat = ft.convert.material_from_numpy(
        [("a", *m1, phi), ("b", *m2, 1.0 - phi)], device="cpu")
    ps = ft.LSSolver(ft.Grid(*shape), pmat, ft.SolverOptions(**opts),
                     device="cpu")
    ps.set_strain([1, 0, 0, 0, 0, 0])
    if not jax:
        return ps
    jmat = fg.VoigtMixed([
        fg.Phase("a", fg.LinearIsotropic(*m1), jnp.asarray(phi)),
        fg.Phase("b", fg.LinearIsotropic(*m2), jnp.asarray(1.0 - phi))],
        dim=6)
    js = fg.LSSolver(fg.Grid(*shape), jmat, fg.SolverOptions(**opts))
    js.set_strain([1, 0, 0, 0, 0, 0])
    return js, ps


def _same(ps, js, rtol=1e-9):
    rj, rp = np.asarray(js.residuals), np.asarray(ps.residuals)
    assert len(rp) == len(rj) < 200
    np.testing.assert_allclose(rp, rj, rtol=rtol)
    S = np.asarray(js.calc_mean_stress())
    np.testing.assert_allclose(ps.calc_mean_stress(), S, rtol=0,
                               atol=1e-10 * np.abs(S).max())


def test_solve_with_multigrid_matches_jax():
    """The staggered elasticity CG with the multigrid G0 against the JAX
    package's (gamma_operator's multigrid branch) on an odd grid, where
    both take the FFT coarse solve on the one level (the JAX package's
    multigrid solve on an even grid compiles for minutes): the same
    iterations, histories within 1e-9, mean stress within 1e-10; no chain
    is applied (the chains' calls stay)."""
    shape = (9, 7, 5)
    js, ps = _solvers(shape, np.random.default_rng(1).random(shape))
    calls = dict(spectral_kernels.calls)
    assert not js.run() and not ps.run()
    assert not ps._k1_route
    assert spectral_kernels.calls == calls
    _same(ps, js)


def test_solve_with_multigrid_v_cycles_matches_fft():
    """On even grids the G0 runs V-cycles over the levels: a random
    material's solve walks the FFT G0's (K3's twin) within 1e-9, and the
    laminate reaches its exact C11."""
    shape = (16, 8, 8)
    phi = np.random.default_rng(1).random(shape)
    s_mg, s_fft = _solvers(shape, phi, jax=False), \
        _solvers(shape, phi, "fft", jax=False)
    assert not s_mg.run() and not s_fft.run()
    _same(s_mg, s_fft)
    s = _solvers((8, 8, 8), _laminate((8, 8, 8)), jax=False)
    assert not s.run()
    M1, M2 = 1.0 + 2 * 1.0, 2.0 + 2 * 5.0
    c11 = 2 * M1 * M2 / (M1 + M2)
    assert abs(s.calc_mean_stress()[0] - c11) <= 1e-7 * c11


def test_fg_project_with_multigrid_matches_jax():
    """<G0_solver>multigrid through FG: the hashin demo at n = 15 on both
    packages' FG."""
    path = os.path.join(demos.DEMO_DIR, "elasticity/hashin/project.xml")
    out = []
    for F, kw in ((fg.FG, {}), (ft.FG, dict(device="cpu"))):
        f = F(path, **kw)
        f.set("variables.res..value", 15)
        f.set("solver.G0_solver", "multigrid")
        f.set("solver.tol", 1e-8)
        assert f.run() == 0
        out.append(f)
    assert out[1].solver.opt.g0_solver == "multigrid"
    assert len(out[1].solver.residuals) == len(out[0].solver.residuals)
    assert demos.rel(out[1].get_mean_stress(), out[0].get_mean_stress()) \
        <= 1e-10
