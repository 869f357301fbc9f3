"""Hyperelastic (dim 9) phases under the mixing rules other than Voigt, in
float64 on the CPU, against the JAX package:

* Maximum, Random and 50-50 over SVK on a partial-volume sphere: Newton
  solves iteration for iteration (the reference material from the rule's
  tangent eigenvalues), and calc_min_eig_h at the solution;
* (the laminates over SVK are in test_torch_hyper_laminate.py);
* the doubly-fine grid over dim-9 fields (full_staggered), a Newton solve
  iteration for iteration;
* the rules that need isotropic laws (Reuss, Split, Iso) refuse SVK, as
  in the JAX package.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

import fibergen_tpu as fg
import fibergen_tpu_torch as ft
from fibergen_tpu.materials import dfg as jdfg
from fibergen_tpu.materials import laws as jlaws
from fibergen_tpu.materials import mixing as jmixing
from fibergen_tpu.utils.logging import LOG as JLOG
from fibergen_tpu_torch.materials import dfg, laws, mixing
from fibergen_tpu_torch.utils.logging import LOG

torch.set_num_threads(2)

SHAPE = (9, 7, 5)
F_LOAD = [1.02, 1, 1, 0, 0, 0, 0, 0, 0]
PHASES = ((10.0, 5.0), (1.0, 1.0))
OPTS = dict(mode="hyperelasticity", dtype="float64", tol=1e-6, maxiter=400,
            error_estimator="residual", outer_error_estimator="epsilon")


@pytest.fixture(autouse=True)
def _quiet():
    old = (JLOG.enabled, LOG.enabled)
    JLOG.enabled = LOG.enabled = False
    yield
    JLOG.enabled, LOG.enabled = old


def _smooth_sphere(shape, r=0.3, w=0.3):
    """A sphere whose phi falls linearly over a shell of width ``w`` (many
    partial-volume voxels), and its outward normals negated (pointing from
    the matrix, phase 2, into the inclusion, phase 1)."""
    ax = [(np.arange(s) + 0.5) / s - 0.5 for s in shape]
    X, Y, Z = np.meshgrid(*ax, indexing="ij")
    R = np.sqrt(X * X + Y * Y + Z * Z)
    phi = np.clip(0.5 - (R - r) / w, 0.0, 1.0)
    return phi, -np.stack([X, Y, Z]) / np.maximum(R, 1e-12)


def _materials(rule, shape=SHAPE, with_normals=False):
    phi, nrm = _smooth_sphere(shape)
    jmat = jmixing.make_mixed(rule, [
        fg.Phase("i", jlaws.SaintVenantKirchhoff(*PHASES[0]),
                 jnp.asarray(phi)),
        fg.Phase("m", jlaws.SaintVenantKirchhoff(*PHASES[1]),
                 jnp.asarray(1.0 - phi))], dim=9)
    if with_normals:
        jmat.normals = jnp.asarray(nrm)
    pmat = ft.convert.material_from_numpy(
        [("i", *PHASES[0], phi), ("m", *PHASES[1], 1.0 - phi)], dim=9,
        law="svk", device="cpu", rule=rule,
        normals=nrm if with_normals else None)
    return jmat, pmat


def _newton_pair(jmat, pmat, shape=SHAPE, atol=1e-14, **opt):
    o = dict(OPTS, **opt)
    js = fg.LSSolver(fg.Grid(*shape), jmat, fg.SolverOptions(**o))
    ps = ft.LSSolver(ft.Grid(*shape), pmat, ft.SolverOptions(**o),
                     device="cpu")
    js.set_strain(F_LOAD)
    ps.set_strain(F_LOAD)
    assert not js.run() and not ps.run()
    # the histories hold every inner iteration of every outer one
    rj, rp = np.asarray(js.residuals), np.asarray(ps.residuals)
    assert len(rp) == len(rj) < ps.opt.maxiter
    np.testing.assert_allclose(rp, rj, rtol=1e-9, atol=atol)
    S_ref = np.asarray(js.calc_mean_stress())
    np.testing.assert_allclose(ps.calc_mean_stress(), S_ref, rtol=0,
                               atol=1e-10 * np.max(np.abs(S_ref)))
    return js, ps


@pytest.mark.parametrize("rule", ["maximum", "random", "fiftyfifty"])
def test_selector_rules_newton_matches_jax(rule):
    jmat, pmat = _materials(rule)
    js, ps = _newton_pair(jmat, pmat)
    # the tangent bounds of the rule's selection, at the solution
    for zt in (False, True):
        lo, hi = (float(x) for x in pmat.eig_range(ps.eps, zero_trace=zt))
        jlo, jhi = (float(x) for x in jmat.eig_range(js.eps, zero_trace=zt))
        assert lo == pytest.approx(jlo, rel=1e-9)
        assert hi == pytest.approx(jhi, rel=1e-9)
    assert abs(ps.calc_min_eig_h() - js.calc_min_eig_h()) <= 1e-12


def test_doubly_fine_grid_over_dim9_matches_jax():
    fine = tuple(2 * n for n in SHAPE)
    phi, _ = _smooth_sphere(fine)
    jmat = jdfg.DfgMaterial(fg.VoigtMixed([
        fg.Phase("i", jlaws.SaintVenantKirchhoff(*PHASES[0]),
                 jnp.asarray(phi)),
        fg.Phase("m", jlaws.SaintVenantKirchhoff(*PHASES[1]),
                 jnp.asarray(1.0 - phi))], dim=9))
    pmat = dfg.DfgMaterial(ft.convert.material_from_numpy(
        [("i", *PHASES[0], phi), ("m", *PHASES[1], 1.0 - phi)], dim=9,
        law="svk", device="cpu"))
    F = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (9,) + SHAPE))
    np.testing.assert_array_equal(dfg.restrict(dfg.prolong(F)).numpy(),
                                  F.numpy())
    # the fine grid's 2x2x2 block sums round in another order than the
    # JAX package's strided slices, and the inner CG's recursive residual
    # carries it: histories agree to 1e-9 relative or 1e-12 absolute (of
    # the first inner residual, 1)
    _newton_pair(jmat, pmat, atol=1e-12, gamma_scheme="full_staggered")


def test_rules_that_need_isotropic_laws_refuse_svk():
    phi = torch.full((3, 3, 3), 0.5, dtype=torch.float64)
    svk = [mixing.Phase(f"p{i}", laws.SaintVenantKirchhoff(mu=1.0, lam=1.0),
                        phi) for i in range(2)]
    for rule, match in (("reuss", "reuss mixing needs isotropic laws"),
                        ("split", "reuss mixing needs isotropic laws"),
                        ("iso", "iso mixing needs isotropic laws")):
        with pytest.raises(NotImplementedError, match=match):
            mixing.make_mixed(rule, svk, dim=9)
    with pytest.raises(ValueError, match="fluidity mixing requires dim 6"):
        mixing.make_mixed("fluidity", svk, dim=9)
