"""The port's batched multi-RHS CG (``LSSolver.run_batched``) against the
JAX package's, in float64 on the CPU (the port's plain path): the load
cases of calc_effective_properties (np.eye(6) in elasticity, np.eye(3) in
heat conduction, two shear cases in viscosity) on both grids, with the
epsilon and the residual estimator, checking every step and every fourth.
The residual histories agree entry for entry.  The JAX package's host loop
runs one chunk past the one in which it detects convergence and the port
none, so the fields and mean stresses are held against the JAX package's
batched state after as many steps as the port took.
"""
import math

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import fibergen_tpu as fg
import fibergen_tpu_torch as ft
from fibergen_tpu.materials import laws as jlaws
from fibergen_tpu.utils.logging import LOG as JLOG
from fibergen_tpu_torch import parallel
from fibergen_tpu_torch.core import voigt
from fibergen_tpu_torch.solvers.ls import SolverError
from fibergen_tpu_torch.utils.logging import LOG

torch.set_num_threads(2)

SHAPE, CELL = (9, 7, 5), (1.2, 0.8, 1.0)
VISC = np.array([[0, 0, 0, 0, 1.0, 0], [0, 0, 0, 0, 2.0, 0]])
# mode -> (dim, law, (fibre, matrix) moduli, load cases)
CASES = {
    "elasticity": (6, "isotropic", ((10.0, 5.0), (1.0, 1.0)), np.eye(6)),
    "heat": (3, "scalar", ((10.0,), (1.0,)), np.eye(3)),
    "viscosity": (6, "scalar", ((0.1,), (1.0,)), VISC),
}


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


def _jax_batch_after(js, Es, steps):
    """The JAX package's batched CG state after exactly ``steps`` steps
    (its init chunk of that length) and its (B, dim) mean stresses."""
    mf = js.mat.fields()
    eps = js._cg_b_init_chunk_n(steps)(
        mf, jnp.asarray(Es, js.dtype), mu0=js.mu_0, lam0=js.lambda_0,
        pallas_mid=True)[0]
    return np.asarray(eps), np.asarray(js._k_b_means(mf, eps)[1])


def _solvers(mode, **opts):
    dim, law, moduli, _ = CASES[mode]
    phi = _sphere(SHAPE)
    jlaw = (lambda m: jlaws.LinearIsotropic(mu=m[0], lam=m[1], dim=dim)) \
        if law == "isotropic" else \
        (lambda m: jlaws.ScalarLinearIsotropic(mu=m[0], dim=dim))
    jmat = fg.VoigtMixed([
        fg.Phase("fiber", jlaw(moduli[0]), jnp.asarray(phi)),
        fg.Phase("matrix", jlaw(moduli[1]), jnp.asarray(1.0 - phi))], dim=dim)
    opts = dict(mode=mode, dtype="float64", maxiter=500, **opts)
    js = fg.LSSolver(fg.Grid(*SHAPE, dx=CELL[0], dy=CELL[1], dz=CELL[2]),
                     jmat, fg.SolverOptions(**opts))
    pmat = ft.convert.material_from_numpy(
        [("fiber", *moduli[0], phi), ("matrix", *moduli[1], 1.0 - phi)],
        dim=dim, device="cpu", law=law)
    ps = ft.LSSolver(ft.convert.grid_from_numpy(SHAPE, CELL), pmat,
                     ft.convert.options_from_dict(opts), device="cpu")
    return js, ps


@pytest.mark.parametrize("mode,scheme,estimator,check_every", [
    ("elasticity", "staggered", "residual", 1),
    ("elasticity", "staggered", "epsilon", 4),
    ("elasticity", "collocated", "residual", 4),
    ("elasticity", "collocated", "epsilon", 1),
    ("heat", "staggered", "residual", 4),
    ("heat", "collocated", "epsilon", 1),
    ("viscosity", "staggered", "residual", 1),
    ("viscosity", "collocated", "residual", 4)])
def test_run_batched_matches_jax(mode, scheme, estimator, check_every):
    tol = 1e-9 if estimator == "residual" else 1e-6
    js, ps = _solvers(mode, gamma_scheme=scheme, error_estimator=estimator,
                      tol=tol, check_every=check_every)
    Es = CASES[mode][3]
    assert not js.run_batched(Es)
    assert not ps.run_batched(Es)
    assert ps.mu_0 == js.mu_0
    rj, rp = np.asarray(js.residuals), np.asarray(ps.residuals)
    assert len(rp) == len(rj) and len(rp) < 500
    # entries at the rounding floor (a sudden Krylov convergence, the
    # epsilon estimator's differences of norms) agree to 1e-14 absolute
    np.testing.assert_allclose(rp, rj, rtol=1e-9, atol=1e-14)
    # the JAX package's own means, one chunk further, within 1e-8 at the
    # residual estimator's tolerance
    ref = np.asarray(js.calc_mean_stress_batched())
    out = ps.calc_mean_stress_batched()
    assert out.shape == ref.shape == (len(Es), CASES[mode][0])
    if estimator == "residual":
        np.testing.assert_allclose(out, ref, rtol=0,
                                   atol=1e-8 * np.max(np.abs(ref)))
    steps = math.ceil(len(rp) / check_every) * check_every
    eps_ref, S_ref = _jax_batch_after(js, Es, steps)
    assert ps.eps_batch.shape == eps_ref.shape == \
        (len(Es), CASES[mode][0]) + SHAPE
    assert np.max(np.abs(ps.eps_batch.numpy() - eps_ref)) <= 1e-9
    np.testing.assert_allclose(out, S_ref, rtol=0,
                               atol=1e-10 * np.max(np.abs(S_ref)))
    assert torch.equal(ps.eps, ps.eps_batch[-1])
    # each case keeps its prescribed mean strain
    np.testing.assert_allclose(
        ps.eps_batch.mean(dim=(2, 3, 4)).numpy(), Es, atol=1e-12)


def test_run_batched_matches_sequential_runs():
    """The batch's means equal the sequential solves' (run() after
    set_bc_projector(id4) and set_stress(0), as the effective-property
    load cases run them) within the CG's tolerance."""
    _, ps = _solvers("elasticity", tol=1e-10, error_estimator="residual",
                     check_every=4)
    assert not ps.run_batched(np.eye(6))
    Sb = ps.calc_mean_stress_batched()
    for i in range(6):
        ps.set_bc_projector(voigt.id4(6))
        ps.set_strain(np.eye(6)[i])
        ps.set_stress(np.zeros(6))
        assert not ps.run()
        np.testing.assert_allclose(ps.calc_mean_stress(), Sb[i], rtol=0,
                                   atol=1e-8 * np.max(np.abs(Sb)))


def test_run_batched_refusals():
    """Only the linear CG runs batched, as in the JAX package."""
    _, ps = _solvers("elasticity", method="basic")
    with pytest.raises(SolverError, match="linear CG"):
        ps.run_batched(np.eye(6))
    mat = ft.convert.material_from_numpy(
        [("a", 1.0, 1.0, np.ones((4, 4, 4)))], dim=9, law="svk",
        device="cpu")
    s = ft.LSSolver(ft.Grid(4, 4, 4), mat, ft.SolverOptions(
        mode="hyperelasticity"), device="cpu")
    with pytest.raises(SolverError, match="linear CG"):
        s.run_batched(np.eye(9)[:1])
    # a replicated sharding has no slab layout: refused, as in the JAX
    # package, rather than solved on the mesh's first device
    phi = _sphere(SHAPE)
    mat = ft.convert.material_from_numpy(
        [("a", 10.0, 5.0, phi), ("b", 1.0, 1.0, 1.0 - phi)], device="cpu")
    mesh = parallel.make_mesh(["cpu"])
    s = ft.LSSolver(ft.Grid(*SHAPE), mat, ft.SolverOptions(dtype="float64"),
                    sharding=parallel.NamedSharding(mesh, (None,) * 4))
    assert s.par is None
    with pytest.raises(SolverError, match="slab-FFT layout"):
        s.run_batched(np.eye(6))


def test_run_batched_takes_the_pallas_mid_keyword():
    """run_batched(Es, pallas_mid=...) as the JAX package's signature has
    it; the keyword changes nothing in the port."""
    runs = []
    for kw in ({}, {"pallas_mid": "auto"}, {"pallas_mid": False}):
        _, ps = _solvers("heat", tol=1e-9, error_estimator="residual")
        assert not ps.run_batched(np.eye(3), **kw)
        runs.append((ps.residuals, ps.calc_mean_stress_batched()))
    for res, S in runs[1:]:
        assert res == runs[0][0]
        np.testing.assert_array_equal(S, runs[0][1])
