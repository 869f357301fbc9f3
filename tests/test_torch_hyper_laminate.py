"""The laminate and the infinity-laminate over SVK phases (dim 9), in
float64 on the CPU: the stress (the jump's eight Newton steps) and the
tangent (the port differentiates the converged jump, the JAX package its
eight steps) on a loaded field against the JAX package, and a port Newton
solve held to the linear laminate at a small strain.  A JAX laminate
Newton solve takes minutes to compile and run on the CPU (159 s on a
5 x 5 x 3 grid), so the solve is held to the port's linear laminate.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

import fibergen_tpu_torch as ft
from fibergen_tpu.utils.logging import LOG as JLOG
from fibergen_tpu_torch.utils.logging import LOG

from test_torch_hyper_rules import F_LOAD, OPTS, PHASES, _materials, \
    _smooth_sphere

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _quiet():
    old = (JLOG.enabled, LOG.enabled)
    JLOG.enabled = LOG.enabled = False
    yield
    JLOG.enabled, LOG.enabled = old


@pytest.mark.parametrize("rule", ["laminate", "infinity_laminate"])
def test_nonlinear_laminate_stress_and_tangent_match_jax(rule):
    shape = (5, 5, 3)
    jmat, pmat = _materials(rule, shape, with_normals=True)
    rng = np.random.default_rng(4)
    F = np.asarray(F_LOAD).reshape(9, 1, 1, 1) \
        + 0.02 * rng.standard_normal((9,) + shape)
    W = rng.standard_normal((9,) + shape)
    Fj, Ft = jnp.asarray(F), torch.as_tensor(F)
    P = np.asarray(jmat.pk1(Fj))
    assert np.max(np.abs(pmat.pk1(Ft).numpy() - P)) <= 1e-12 * np.max(
        np.abs(P))
    T = np.asarray(jmat.dpk1(Fj, jnp.asarray(W)))
    out = pmat.dpk1(Ft, torch.as_tensor(W)).numpy()
    assert np.max(np.abs(out - T)) <= 1e-12 * np.max(np.abs(T))
    assert np.max(np.abs(pmat.w(Ft).numpy() - np.asarray(jmat.w(Fj)))) \
        <= 1e-12


def test_nonlinear_laminate_newton_reaches_the_linear_laminate():
    """At F = I + h e_xx with h = 1e-4 the SVK laminate's mean P11 is the
    linear laminate's sigma_11 h to O(h): the port's Newton solve through
    the nonlinear jump against its CG on the linear phases."""
    h = 1e-4
    phi, nrm = _smooth_sphere((7, 5, 5))
    out = []
    for law, dim, load, mode in (
            ("svk", 9, [1.0 + h, 1, 1, 0, 0, 0, 0, 0, 0], "hyperelasticity"),
            ("isotropic", 6, [h, 0, 0, 0, 0, 0], "elasticity")):
        mat = ft.convert.material_from_numpy(
            [("i", *PHASES[0], phi), ("m", *PHASES[1], 1.0 - phi)], dim=dim,
            law=law, device="cpu", rule="laminate", normals=nrm)
        s = ft.LSSolver(ft.Grid(7, 5, 5), mat, ft.SolverOptions(
            **dict(OPTS, mode=mode, tol=1e-8)), device="cpu")
        s.set_strain(load)
        assert not s.run()
        out.append(s.calc_mean_stress()[0])
    assert out[0] == pytest.approx(out[1], rel=2e-3)
