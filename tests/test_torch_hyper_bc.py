"""Newton-Krylov under mixed boundary conditions against the JAX package, in
float64 on the CPU (the port's plain path): the load of the
``hyperelasticity/mixed_bc`` demo (mean P11 = 1 prescribed through the
projector p11 = 0, F22 = 1.1) on a 7x5x5 SVK sphere, on both grids, with
both tangents and with a two-loadstep run; the outer and inner iteration
counts, the residual history, the mean PK1 and the prescribed P11.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

import fibergen_tpu as fg
import fibergen_tpu_torch as ft
from fibergen_tpu.materials import laws as jlaws
from fibergen_tpu.utils.logging import LOG as JLOG
from fibergen_tpu_torch.core import voigt
from fibergen_tpu_torch.utils.logging import LOG

torch.set_num_threads(2)

SHAPE = (7, 5, 5)
# the demo's phases: the matrix mu = lam = 10, the sphere (R = 0.3) mu = 10,
# lam = 100; its load: p11 = 0, s11 = 1, e22 = 0.1
MODULI = ((10.0, 100.0), (10.0, 10.0))
P = voigt.id4(9)
P[0, 0] = 0.0
S = np.zeros(9)
S[0] = 1.0
E = np.zeros(9)
E[1] = 0.1
E = E + voigt.dyad4_mv(P, voigt.identity_vec(9))     # F22 = 1.1, F11 free


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


def _solvers(**opts):
    phi = _sphere(SHAPE)
    jmat = fg.VoigtMixed([
        fg.Phase("pore", jlaws.SaintVenantKirchhoff(*MODULI[0]),
                 jnp.asarray(phi)),
        fg.Phase("matrix", jlaws.SaintVenantKirchhoff(*MODULI[1]),
                 jnp.asarray(1.0 - phi))], dim=9)
    opts = dict(mode="hyperelasticity", method="cg", dtype="float64",
                maxiter=500, error_estimator="residual",
                outer_error_estimator="epsilon", tol=1e-5, **opts)
    js = fg.LSSolver(fg.Grid(*SHAPE), jmat, fg.SolverOptions(**opts))
    pmat = ft.convert.material_from_numpy(
        [("pore", *MODULI[0], phi), ("matrix", *MODULI[1], 1.0 - phi)],
        dim=9, law="svk", device="cpu")
    ps = ft.LSSolver(ft.Grid(*SHAPE), pmat, ft.convert.options_from_dict(opts),
                     device="cpu")
    for s in (js, ps):
        s.set_bc_projector(P)
        s.set_strain(E)
        s.set_stress(S)
    return js, ps


@pytest.mark.parametrize("scheme,tangent", [
    ("staggered", "exact"), ("collocated", "exact"),
    ("staggered", "frozen_iso")])
def test_mixed_bc_newton_matches_jax(scheme, tangent):
    """The same outer and inner iterations, mean PK1 within 1e-9 of the
    largest, the boundary condition error within 1e-10; P11 meets its
    prescribed value within ``bc_tol`` and F22 stays 1.1.  The
    residual histories agree within 1e-6: the recursive CG residual
    carries float64 rounding below about 1e-5 of the first inner residual
    here (the mean correction is one more reduction per Gamma
    application), and each epsilon entry, a difference of norms, within
    1e-14 absolute."""
    js, ps = _solvers(gamma_scheme=scheme, newton_tangent=tangent)
    assert not js.run() and not ps.run()
    assert ps.mu_0 == pytest.approx(js.mu_0, rel=1e-12)
    rj, rp = np.asarray(js.residuals), np.asarray(ps.residuals)
    assert len(rp) == len(rj)
    np.testing.assert_allclose(rp, rj, rtol=1e-6, atol=1e-14)
    outer, inner = ps.newton_iterations
    assert outer >= 2 and outer + inner == len(rp)
    S_ref = np.asarray(js.calc_mean_stress())
    Sp = ps.calc_mean_stress()
    np.testing.assert_allclose(Sp, S_ref, rtol=0,
                               atol=1e-9 * np.max(np.abs(S_ref)))
    assert abs(ps.bc_error() - js.bc_error()) <= 1e-10
    assert ps.bc_error() <= ps.opt.bc_tol
    assert abs(Sp[0] - 1.0) <= ps.opt.bc_tol
    assert ps.calc_mean_strain()[1] == pytest.approx(1.1, rel=1e-12)


def test_mixed_bc_newton_loadsteps_reach_the_jax_solution():
    """Two loadsteps, E(t) = t E + (1 - t) P:Id and S(t) = t S: the same
    solution as the JAX package's (mean PK1 within 1e-6 of the largest,
    the outer tolerance's reach).  The iterations are not compared: the
    JAX package memoizes the tangent bounds of the first loadstep for the
    material (its VoigtMixed flags itself iso-linear), the port recomputes
    mu_0 at each loadstep as update_ref="loadstep" asks."""
    js, ps = _solvers(gamma_scheme="collocated", loadsteps=2)
    assert not js.run() and not ps.run()
    S_ref = np.asarray(js.calc_mean_stress())
    np.testing.assert_allclose(ps.calc_mean_stress(), S_ref, rtol=0,
                               atol=1e-6 * np.max(np.abs(S_ref)))
    assert ps.bc_error() <= ps.opt.bc_tol
    assert ps.calc_mean_strain()[1] == pytest.approx(1.1, rel=1e-12)
