"""Mixed-precision refinement in the port (solvers/refine.py) against the
JAX package, on the CPU: the cases of tests/test_refine.py.

A float32 solve at tol 1e-10 refines with float64 residuals and float32
corrections, in both packages; the port's refined mean stress, strain and
energy lie within 1e-9 (relative to the largest component) of the JAX
package's float64 solve of the same discrete problem (phi quantized to
float32 first, so both precisions see the same phases), in heat and
elasticity, on the staggered and the collocated grid, after the plain CG
and after the lm6 low-memory CG.  Refinement stays off at a loose
tolerance and warns where it cannot engage.  Two defects of the JAX
package are not copied: a sweep that raises leaves the solution in
``eps``, and the float64 material follows the phases when they change.
"""
import io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fibergen_tpu as fg
import fibergen_tpu_torch as ft
from fibergen_tpu.utils.logging import LOG as JLOG
from fibergen_tpu_torch import parallel
from fibergen_tpu_torch.utils.logging import LOG

import _torch_demos as demos

torch.set_num_threads(2)

SHAPE = (15, 9, 5)
M1 = (1.0, 2.0)          # matrix mu, lambda
M2 = (10.0, 5.0)         # inclusion


@pytest.fixture(autouse=True)
def _quiet():
    old = (JLOG.enabled, LOG.enabled)
    JLOG.enabled = LOG.enabled = False
    yield
    JLOG.enabled, LOG.enabled = old


@pytest.fixture
def warnings():
    """The port's log while the test runs, as text."""
    buf = io.StringIO()
    old = (LOG.enabled, LOG.stream)
    LOG.enabled, LOG.stream = True, buf
    yield buf
    LOG.enabled, LOG.stream = old


def _sphere_phi(shape, r=0.35):
    """A smooth sphere of partial-volume voxels, quantized to float32 so
    that the float32 and the float64 solves see the same phases."""
    ax = [(np.arange(n) + 0.5) / n - 0.5 for n in shape]
    X, Y, Z = np.meshgrid(*ax, indexing="ij")
    d = np.sqrt(X ** 2 + Y ** 2 + Z ** 2)
    phi = np.clip((r - d) * shape[0] + 0.5, 0.0, 1.0).astype(np.float32)
    return phi, (1.0 - phi).astype(np.float32)


def _load(mode):
    return {"heat": [1.0, 0.0, 0.0], "viscosity": [0, 0, 0, 1.0, 0, 0]}.get(
        mode, [1.0, 1.0, 1.0, 0.0, 0.0, 0.0])


def _jax(mode, dtype, shape=SHAPE, **opt):
    phi1, phi2 = (jnp.asarray(p, dtype) for p in _sphere_phi(shape))
    if mode == "heat":
        laws = (fg.ScalarLinearIsotropic(mu=10.0, dim=3),
                fg.ScalarLinearIsotropic(mu=1.0, dim=3))
    else:
        laws = (fg.LinearIsotropic(*M2), fg.LinearIsotropic(*M1))
    dim = 3 if mode == "heat" else 6
    mat = fg.VoigtMixed([fg.Phase("incl", laws[0], phi1),
                         fg.Phase("matrix", laws[1], phi2)], dim=dim)
    s = fg.LSSolver(fg.Grid(*shape), mat, fg.SolverOptions(
        mode=mode, method="cg", maxiter=3000, dtype=dtype, **opt))
    s.set_strain(_load(mode))
    assert not s.run()
    return s


def _port(mode, dtype, shape=SHAPE, mesh=None, run=True, **opt):
    phi1, phi2 = (p.astype(dtype) for p in _sphere_phi(shape))
    if mode == "heat":
        phases = [("incl", 10.0, phi1), ("matrix", 1.0, phi2)]
        kw = dict(dim=3, law="scalar")
    elif mode == "viscosity":
        phases = [("incl", 2.5, phi1), ("matrix", 0.5, phi2)]
        kw = dict(dim=6, law="scalar")
    else:
        phases = [("incl", *M2, phi1), ("matrix", *M1, phi2)]
        kw = {}
    mat = ft.convert.material_from_numpy(phases, device="cpu", **kw)
    sharding = None if mesh is None else \
        parallel.field_sharding(parallel.make_mesh(mesh))
    opt = dict(dict(maxiter=3000), **opt)
    s = ft.LSSolver(ft.Grid(*shape), mat, ft.SolverOptions(
        mode=mode, method="cg", dtype=dtype, **opt),
        device=None if mesh else "cpu", sharding=sharding)
    s.set_strain(_load(mode))
    if run:
        assert not s.run()
    return s


_REF = {}


def _jax64(mode, scheme="staggered"):
    """The JAX package's float64 solve to 1e-13, once per process."""
    if (mode, scheme) not in _REF:
        _REF[mode, scheme] = _jax(mode, "float64", tol=1e-13,
                                  gamma_scheme=scheme,
                                  error_estimator="residual")
    return _REF[mode, scheme]


def _rel(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(x - ref)) / np.max(np.abs(ref)))


@pytest.mark.parametrize("mode", ["heat", "elasticity"])
@pytest.mark.parametrize("check_every", [1, 8])
def test_refined_f32_matches_jax_f64_solve(mode, check_every):
    """float32 + refinement at tol 1e-10 lands within 1e-9 of the JAX
    package's float64 solve, as the JAX package's own refined solve does;
    bare float32 stays at its floor, ten times further off at least."""
    ref = np.asarray(_jax64(mode).calc_mean_stress())
    s = _port(mode, "float32", tol=1e-10, check_every=check_every)
    assert s.eps64 is not None and s.eps64.dtype == torch.float64
    assert s.eps.dtype == torch.float32 and s.refine_sweeps >= 1
    assert s.residuals[-1] <= 1e-10
    assert _rel(s.calc_mean_stress(), ref) <= 1e-9
    j = _jax(mode, "float32", tol=1e-10, check_every=check_every)
    assert j.eps64 is not None
    assert _rel(np.asarray(j.calc_mean_stress()), ref) <= 1e-9
    bare = _port(mode, "float32", tol=1e-10, refine="off")
    assert bare.eps64 is None
    err_bare = np.max(np.abs(bare.calc_mean_stress() - ref))
    assert np.max(np.abs(s.calc_mean_stress() - ref)) < err_bare / 10


def test_refined_mean_strain_and_energy():
    j = _jax64("elasticity")
    s = _port("elasticity", "float32", tol=1e-10)
    np.testing.assert_allclose(s.calc_mean_strain(),
                               np.asarray(j.calc_mean_strain()), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(s.calc_mean_energy(), j.calc_mean_energy(),
                               rtol=1e-9)


@pytest.mark.parametrize("mode", ["heat", "elasticity"])
def test_refined_collocated_scheme(mode):
    """The float64 residual runs the solver's own operators: K5's twin on
    the collocated grid."""
    ref = np.asarray(_jax64(mode, "collocated").calc_mean_stress())
    s = _port(mode, "float32", tol=1e-10, gamma_scheme="collocated")
    assert s.eps64 is not None
    assert _rel(s.calc_mean_stress(), ref) <= 1e-9


def test_refine_off_at_a_loose_tol():
    s = _port("heat", "float32", tol=1e-5)
    assert s.eps64 is None and s.refine_sweeps == 0
    s = _port("heat", "float64", tol=1e-10)
    assert s.eps64 is None


def test_refine_on_forces_it_at_a_loose_tol():
    s = _port("heat", "float32", tol=1e-5, refine="on")
    assert s.eps64 is not None and s.residuals[-1] <= 1e-5


@pytest.mark.parametrize("case", ["mixed_bc", "hyperelasticity", "sharded"])
def test_refine_warns_where_it_cannot_engage(case, warnings):
    """Mixed BCs, hyperelasticity and a sharded solve are out of scope: the
    solve warns with the JAX package's message and the stagnation guard
    stops it at the float32 floor."""
    msg = "mixed-precision refinement cannot engage"
    if case == "mixed_bc":
        s = _port("elasticity", "float32", shape=(8, 4, 4), tol=1e-9,
                  maxiter=300, run=False)
        P = np.zeros((6, 6))
        P[0, 0] = 1.0
        s.set_bc_projector(P)
        s.set_strain([1.0, 0, 0, 0, 0, 0])
        assert not s.run()
        why = "mixed BCs are out of refinement scope"
    elif case == "sharded":
        s = _port("elasticity", "float32", shape=(8, 4, 4), tol=1e-9,
                  maxiter=300, mesh=["cpu"] * 2)
        why = "sharded solves are out of refinement scope"
    else:
        phi = np.zeros((5, 4, 3))
        phi[:2] = 1.0
        mat = ft.convert.material_from_numpy(
            [("a", 1.0, 1.0, phi), ("b", 2.0, 1.0, 1.0 - phi)], dim=9,
            law="svk", device="cpu")
        s = ft.LSSolver(ft.Grid(5, 4, 3), mat, ft.SolverOptions(
            mode="hyperelasticity", dtype="float32", tol=1e-9, maxiter=200,
            error_estimator="residual", outer_error_estimator="epsilon"),
            device="cpu")
        s.set_strain([1.01, 1, 1, 0, 0, 0, 0, 0, 0])
        s.run()
        why = "hyperelastic Newton is out of refinement scope"
    assert s.eps64 is None
    assert msg in warnings.getvalue() and why in warnings.getvalue()


@pytest.mark.parametrize("mode", ["elasticity", "viscosity"])
def test_refined_after_lm6(mode):
    """Refinement over the lm6 tuple-state CG (low_mem="on", check_every
    4): its corrections take the lm6 step, and the refined solve meets the
    plain-layout refined solve and the float64 solve."""
    opt = dict(tol=1e-10, check_every=4, error_estimator="residual")
    plain = _port(mode, "float32", low_mem="off", **opt)
    lm6 = _port(mode, "float32", low_mem="on", **opt)
    assert lm6._route == "lm6" and plain._route is None
    assert plain.eps64 is not None and lm6.eps64 is not None
    assert lm6.residuals[-1] <= 1e-10
    assert _rel(lm6.calc_mean_stress(), plain.calc_mean_stress()) <= 5e-9
    s64 = _port(mode, "float64", tol=1e-13, error_estimator="residual")
    assert _rel(lm6.calc_mean_stress(), s64.calc_mean_stress()) <= 1e-9


def test_eps_survives_a_raising_sweep(monkeypatch):
    """The JAX package sets eps to None for the sweeps and leaves it so
    when one raises (fibergen_tpu/solvers/ls.py:1854); the port keeps the
    latest solution in eps and eps64."""
    s = _port("elasticity", "float32", tol=1e-10, run=False)
    calls = []
    solve = type(s)._solve_correction

    def second_raises(self, rhs):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("correction failed")
        return solve(self, rhs)

    monkeypatch.setattr(type(s), "_solve_correction", second_raises)
    with pytest.raises(RuntimeError, match="correction failed"):
        s.run()
    assert s.eps is not None and s.eps.dtype == torch.float32
    assert s.eps.shape == (6,) + SHAPE and bool(torch.isfinite(s.eps).all())
    assert s.eps64 is not None
    torch.testing.assert_close(s.eps, s.eps64.to(torch.float32))
    np.testing.assert_allclose(s.calc_mean_strain(), _load("elasticity"),
                               atol=1e-12)


def test_float64_material_follows_the_phases():
    """The JAX package caches its float64 material on the solver and never
    rebuilds it (fibergen_tpu/solvers/refine.py:90): a second refined solve
    after the phases change would take the old material's residual.  The
    port rebuilds its float64 twin when the material's tensors change."""
    s = _port("elasticity", "float32", tol=1e-10)
    first = s.calc_mean_stress()
    phi = np.roll(_sphere_phi(SHAPE, r=0.3)[0], 2, axis=0)
    for p, f in zip(s.mat.phases, (phi, 1.0 - phi)):
        p.phi = torch.as_tensor(f, dtype=torch.float32)
    assert not s.run()
    fresh = _port("elasticity", "float32", tol=1e-10, run=False)
    for p, f in zip(fresh.mat.phases, (phi, 1.0 - phi)):
        p.phi = torch.as_tensor(f, dtype=torch.float32)
    assert not fresh.run()
    assert _rel(s.calc_mean_stress(), first) > 1e-3
    np.testing.assert_allclose(s.calc_mean_stress(),
                               fresh.calc_mean_stress(), rtol=1e-12)


def test_fg_hashin_demo_refines_in_float32():
    """The hashin demo at its shipped tol 1e-10 through the port's FG in
    float32 refines (the batched load cases stay off under a deep tol) and
    meets the float64 project run within 1e-8."""
    path = os.path.join(demos.DEMO_DIR, "elasticity/hashin/project.xml")
    runs = {}
    for dt in ("float", "double"):
        f = ft.FG(path, device="cpu")
        f.set("variables.res..value", 16)
        f.set("datatype", dt)
        assert f.run() == 0
        runs[dt] = f
    s32 = runs["float"].solver
    assert s32.dtype == torch.float32 and s32.eps64 is not None
    k32 = np.asarray(runs["float"].get_mean_stress())[:3].mean()
    k64 = np.asarray(runs["double"].get_mean_stress())[:3].mean()
    assert abs(k32 - k64) <= 1e-8 * abs(k64)
