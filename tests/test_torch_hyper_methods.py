"""The port's hyperelastic methods other than Newton-Krylov against the JAX
package, in float64 on the CPU (the port's plain path), on the SVK sphere
(mu 10/1, lambda 5/1) at F = diag(1.02, 1, 1):

* nonlinear CG under each beta scheme (staggered) and Polak-Ribiere on
  the collocated grid, iteration for iteration;
* the basic and nesterov schemes on the nine-component Gamma (K3 with the
  full-gradient constants, K5 at C = 9), iteration for iteration;
* basic+el, the mixed-BC mean of nl_cg's gradient, and the refusals that
  stay (polarization: the hyperelastic laws have none).

The JAX package memoizes the reference material's tangent bounds of a
solver whose material it takes for linear (VoigtMixed), so its nl_cg keeps
the bounds of the field before the first basic step; the port takes them
at the field, as its calc_ref_material says.  The parity runs reset the
JAX memo at each call, which is that package's answer without it.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

import fibergen_tpu as fg
import fibergen_tpu_torch as ft
from fibergen_tpu.materials import laws as jlaws
from fibergen_tpu.utils.logging import LOG as JLOG
from fibergen_tpu_torch.utils.logging import LOG

torch.set_num_threads(2)

SHAPE = (9, 7, 5)
F_LOAD = [1.02, 1, 1, 0, 0, 0, 0, 0, 0]
PHASES = ((10.0, 5.0), (1.0, 1.0))


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


def _fresh_bounds(js):
    """The JAX solver with its tangent-bound memo reset at each call."""
    calc = js.calc_ref_material

    def fresh():
        js._eig_memo = None
        return calc()
    js.calc_ref_material = fresh
    return js


def _solvers(shape=SHAPE, **opt):
    phi = _sphere(shape)
    jmat = fg.VoigtMixed([
        fg.Phase("i", jlaws.SaintVenantKirchhoff(*PHASES[0]),
                 jnp.asarray(phi)),
        fg.Phase("m", jlaws.SaintVenantKirchhoff(*PHASES[1]),
                 jnp.asarray(1.0 - phi))], dim=9)
    pmat = ft.convert.material_from_numpy(
        [("i", *PHASES[0], phi), ("m", *PHASES[1], 1.0 - phi)], dim=9,
        law="svk", device="cpu")
    o = dict(mode="hyperelasticity", dtype="float64", **opt)
    js = _fresh_bounds(fg.LSSolver(fg.Grid(*shape), jmat,
                                   fg.SolverOptions(**o)))
    ps = ft.LSSolver(ft.Grid(*shape), pmat, ft.SolverOptions(**o),
                     device="cpu")
    js.set_strain(F_LOAD)
    ps.set_strain(F_LOAD)
    return js, ps


def _same_solve(js, ps):
    """The same iterations, histories within 1e-9 relative or 1e-14
    absolute, mean PK1 within 1e-10 of its size."""
    assert not js.run() and not ps.run()
    assert ps.mu_0 == pytest.approx(js.mu_0, rel=1e-13)
    rj, rp = np.asarray(js.residuals), np.asarray(ps.residuals)
    assert len(rp) == len(rj) < ps.opt.maxiter
    np.testing.assert_allclose(rp, rj, rtol=1e-9, atol=1e-14)
    S_ref = np.asarray(js.calc_mean_stress())
    np.testing.assert_allclose(ps.calc_mean_stress(), S_ref, rtol=0,
                               atol=1e-10 * np.max(np.abs(S_ref)))


@pytest.mark.parametrize("scheme,beta", [
    ("staggered", "polak_ribiere"), ("staggered", "fletcher_reeves"),
    ("staggered", "hestenes_stiefel"), ("staggered", "day_yuan"),
    ("staggered", "steepest_descent"), ("collocated", "polak_ribiere")])
def test_nl_cg_matches_jax(scheme, beta):
    js, ps = _solvers(method="nl_cg", gamma_scheme=scheme,
                      nl_cg_beta_scheme=beta, tol=1e-6, maxiter=400)
    _same_solve(js, ps)


def test_nl_cg_alpha_and_mixed_bc_mean_match_jax():
    """A step length nl_cg_alpha other than 1, and a projector with a
    prescribed stress: the gradient's mean is M:S0."""
    P = np.eye(9)
    P[0, 0] = 0.0
    S = np.zeros(9)
    S[0] = 0.5
    js, ps = _solvers(method="nl_cg", nl_cg_alpha=0.8, tol=1e-6,
                      maxiter=400)
    for s in (js, ps):
        s.set_bc_projector(P)
        s.set_stress(S)
        s.set_strain([0.0, 1, 1, 0, 0, 0, 0, 0, 0])
    _same_solve(js, ps)


@pytest.mark.parametrize("method", ["basic", "nesterov"])
@pytest.mark.parametrize("scheme", ["staggered", "collocated"])
def test_basic_and_nesterov_match_jax(method, scheme):
    js, ps = _solvers(method=method, gamma_scheme=scheme,
                      error_estimator="epsilon", tol=1e-8, maxiter=400)
    _same_solve(js, ps)


def test_basic_el_reaches_newton():
    """basic+el in hyperelasticity: the line step is one Newton step on
    the line (exact for linear laws); it ends near Newton's P11."""
    _, pn = _solvers(error_estimator="residual",
                     outer_error_estimator="epsilon", tol=1e-10,
                     maxiter=400)
    _, pb = _solvers(method="basic+el", tol=1e-10, maxiter=3000)
    assert not pn.run() and not pb.run()
    ref = pn.calc_mean_stress()[0]
    assert abs(pb.calc_mean_stress()[0] - ref) <= 1e-5 * abs(ref)


@pytest.mark.parametrize("method", ["nl_cg", "basic"])
def test_hyper_methods_on_slabs_match_the_unsharded_solve(method):
    """nl_cg and the basic scheme on two x-slabs of the CPU (the kz-slab
    K3 chain with the full-gradient constants, per-slab stencils) take the
    unsharded solve's iterations and end at its mean PK1."""
    from fibergen_tpu_torch import parallel
    shape = (8, 6, 5)
    phi = _sphere(shape)
    out = []
    for sharding in (None, parallel.field_sharding(
            parallel.make_mesh(["cpu"] * 2))):
        mat = ft.convert.material_from_numpy(
            [("i", *PHASES[0], phi), ("m", *PHASES[1], 1.0 - phi)], dim=9,
            law="svk", device="cpu")
        s = ft.LSSolver(ft.Grid(*shape), mat, ft.SolverOptions(
            mode="hyperelasticity", method=method, error_estimator="sigma",
            tol=1e-6, maxiter=400), device="cpu", sharding=sharding)
        s.set_strain(F_LOAD)
        assert not s.run()
        out.append((np.asarray(s.residuals), s.calc_mean_stress()))
    assert len(out[0][0]) == len(out[1][0])
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-9, atol=1e-14)
    np.testing.assert_allclose(out[1][1], out[0][1], rtol=1e-12, atol=1e-15)


def test_polarization_stays_refused():
    _, ps = _solvers()
    with pytest.raises(NotImplementedError, match="no polarization"):
        ft.LSSolver(ft.Grid(*SHAPE), ps.mat, ft.SolverOptions(
            mode="hyperelasticity", method="polarization"), device="cpu")
