"""The port's sharded Newton-Krylov and polarization solves, on the CPU.

* the sharded Newton solve against the port's own unsharded one over
  D = 1, 2 and 4 CPU slabs, on (16, 8, 9) (kz = 5 splits unevenly) and
  (16, 8, 7) (kz = 4 splits evenly), on both grids; the sigma and energy
  estimators; the loadstep split of a divergent SVK compression on four
  slabs;
* sharded polarization (Eyre-Milton) in elasticity and heat against the
  JAX package's sharded polarization solve on four devices;
* polarization reports no boundary condition error, as the JAX package's
  does not test one there;
* a sharded Newton solve never gathers its slabs.

The JAX package's sharded Newton solves are held against the port's in
test_torch_parallel_hyper.py.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh, NamedSharding as JSharding
from jax.sharding import PartitionSpec as P

import fibergen_tpu as fg
from fibergen_tpu.utils.logging import LOG as JLOG
import fibergen_tpu_torch as ft
from fibergen_tpu_torch import parallel
from fibergen_tpu_torch.parallel import slabs
from fibergen_tpu_torch.utils.logging import LOG

torch.set_num_threads(2)

LOAD = [1.02, 1, 1, 0, 0, 0, 0, 0, 0]


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


def _sharding(d):
    return parallel.field_sharding(parallel.make_mesh(["cpu"] * d))


def _newton(shape, d=None, **opt):
    """The two-phase SVK sphere at 2 % stretch (the hyperelastic bench's
    RVE) on ``shape``, float64; with ``d`` sharded over D CPU slabs."""
    phi = _sphere(shape)
    mat = ft.convert.material_from_numpy(
        [("fiber", 10.0, 5.0, phi), ("matrix", 1.0, 1.0, 1.0 - phi)], dim=9,
        law="svk", device="cpu")
    opt = dict(dict(mode="hyperelasticity", dtype="float64", maxiter=500,
                    error_estimator="residual",
                    outer_error_estimator="epsilon", tol=1e-6), **opt)
    s = ft.LSSolver(ft.Grid(*shape), mat, ft.SolverOptions(**opt),
                    device="cpu",
                    sharding=None if d is None else _sharding(d))
    s.set_strain(LOAD)
    return s


_UNSHARDED = {}


def _unsharded(shape, **opt):
    """The port's unsharded solve, run once per shape and options."""
    key = (shape, tuple(sorted(opt.items())))
    if key not in _UNSHARDED:
        s = _newton(shape, **opt)
        assert not s.run()
        _UNSHARDED[key] = s
    return _UNSHARDED[key]


def _same_solve(s1, s0, field_tol=1e-12):
    """Equal iteration counts, histories within 1e-9 (or 1e-14 absolute
    on entries that are differences of two numbers), the gathered field
    and the means within ``field_tol``."""
    assert s1.newton_iterations == s0.newton_iterations
    r1, r0 = np.asarray(s1.residuals), np.asarray(s0.residuals)
    assert len(r1) == len(r0)
    np.testing.assert_allclose(r1, r0, rtol=1e-9, atol=1e-14)
    assert np.max(np.abs(s1.get_field("epsilon")
                         - s0.get_field("epsilon"))) <= field_tol
    np.testing.assert_allclose(s1.calc_mean_stress(), s0.calc_mean_stress(),
                               rtol=0, atol=field_tol)
    np.testing.assert_allclose(s1.calc_mean_cauchy(), s0.calc_mean_cauchy(),
                               rtol=0, atol=field_tol)
    assert abs(s1.calc_mean_energy() - s0.calc_mean_energy()) <= field_tol
    assert abs(s1.calc_min_det_f() - s0.calc_min_det_f()) <= field_tol


@pytest.mark.parametrize("d", [1, 2, 4])
@pytest.mark.parametrize("scheme", ["staggered", "collocated"])
@pytest.mark.parametrize("shape", [(16, 8, 9), (16, 8, 7)])
def test_sharded_newton_matches_unsharded(shape, scheme, d):
    """The port against itself, modified Newton (the frozen tangent): D
    slabs (D = 1: one slab that wraps its own halo) against the unsharded
    solve, float64, the same iterations, histories within 1e-9, fields
    and means within 1e-12."""
    opt = dict(gamma_scheme=scheme, newton_tangent="frozen_iso")
    s0 = _unsharded(shape, **opt)
    s1 = _newton(shape, d, **opt)
    assert not s1.run()
    assert isinstance(s1.eps, list) and len(s1.eps) == d
    _same_solve(s1, s0)


@pytest.mark.parametrize("scheme", ["staggered", "collocated"])
def test_sharded_newton_exact_tangent_matches_unsharded(scheme):
    """The exact tangent on four slabs of the evenly split (16, 8, 7)
    against the unsharded solve."""
    opt = dict(gamma_scheme=scheme)
    s1 = _newton((16, 8, 7), 4, **opt)
    assert not s1.run()
    _same_solve(s1, _unsharded((16, 8, 7), **opt))


def test_sharded_newton_sigma_and_energy_estimators():
    """The sigma estimator inside and the energy estimator outside, on
    four slabs: their metrics are means reduced over the slabs."""
    opt = dict(gamma_scheme="collocated", newton_tangent="frozen_iso",
               error_estimator="sigma", outer_error_estimator="energy")
    s1 = _newton((16, 8, 9), 4, **opt)
    assert not s1.run()
    assert s1.newton_iterations[0] >= 2
    _same_solve(s1, _unsharded((16, 8, 9), **opt))


def _compression(lmbda, splits, d=None):
    x = (np.arange(8) + 0.5) / 8
    phi = np.broadcast_to((x < 0.5)[:, None, None], (8, 4, 4)).astype(float)
    mat = ft.convert.material_from_numpy(
        [("m1", 1.0, 1.0, phi), ("m2", 3.0, 2.0, 1.0 - phi)], dim=9,
        law="svk", device="cpu")
    s = ft.LSSolver(ft.Grid(8, 4, 4), mat, ft.SolverOptions(
        mode="hyperelasticity", tol=1e-8, maxiter=400,
        max_loadstep_splits=splits),
        device="cpu", sharding=None if d is None else _sharding(d))
    s.set_strain([lmbda, 1, 1, 0, 0, 0, 0, 0, 0])
    return s


def test_sharded_loadstep_split_recovers_divergent_svk():
    """28 % SVK compression in one loadstep on four slabs meets an
    indefinite inner operator: without splits the run fails; with them it
    restores the slabs, inserts midpoint loadsteps and converges to the
    unsharded solve's stress.  Which loadsteps fail is decided by
    denominators of order 1e-35, whose rounding the slab-order sums
    change, so the iteration counts may differ from the unsharded run's."""
    s = _compression(0.72, splits=0, d=4)
    assert s.run() and s._diverged
    s1, s0 = _compression(0.72, splits=8, d=4), _compression(0.72, splits=8)
    assert not s1.run() and not s0.run()
    assert isinstance(s1.eps, list) and len(s1.eps) == 4
    np.testing.assert_allclose(s1.calc_mean_strain(), s0.calc_mean_strain(),
                               rtol=0, atol=1e-12)
    assert s1.calc_mean_strain()[0] == pytest.approx(0.72, rel=1e-6)
    S0 = s0.calc_mean_stress()
    np.testing.assert_allclose(s1.calc_mean_stress(), S0, rtol=0,
                               atol=1e-7 * np.max(np.abs(S0)))


def test_sharded_newton_never_gathers(monkeypatch):
    """No whole field inside the sharded solve: gathering the slabs
    raises."""
    def refuse(*a, **k):
        raise AssertionError("a sharded solve gathered its slabs")
    monkeypatch.setattr(parallel, "gather_field", refuse)
    monkeypatch.setattr(slabs, "gather_field", refuse)
    for scheme in ("staggered", "collocated"):
        s = _newton((16, 8, 9), 4, gamma_scheme=scheme,
                    newton_tangent="frozen_iso")
        assert not s.run()
        assert np.all(np.isfinite(s.calc_mean_stress()))
        assert s.calc_min_det_f() > 0
    with pytest.raises(AssertionError, match="gathered"):
        s.get_field("epsilon")


# ----------------------------------------------------------- polarization
# mode -> (dim, port law, (fibre, matrix) moduli, load)
POLAR = {
    "elasticity": (6, "isotropic", ((10.0, 5.0), (1.0, 1.0)),
                   [1.0, 0, 0, 0, 0, 0]),
    "heat": (3, "scalar", ((10.0,), (1.0,)), [1.0, 0, 0]),
}
POLAR_OPT = dict(method="polarization", error_estimator="epsilon",
                 tol=1e-6, maxiter=500, dtype="float64")


def _polar_port(mode, d, shape=(16, 8, 9)):
    dim, law, (mf, mm), load = POLAR[mode]
    phi = _sphere(shape)
    mat = ft.convert.material_from_numpy(
        [("fiber", *mf, phi), ("matrix", *mm, 1.0 - phi)], dim=dim, law=law,
        device="cpu")
    s = ft.LSSolver(ft.Grid(*shape), mat, ft.SolverOptions(
        mode=mode, **POLAR_OPT), device="cpu",
        sharding=None if d is None else _sharding(d))
    s.set_strain(load)
    return s


def _polar_jax(mode, shape=(16, 8, 9)):
    dim, law, (mf, mm), load = POLAR[mode]
    mesh = Mesh(np.array(jax.devices()[:4]), axis_names=("x",))
    phi = jax.device_put(jnp.asarray(_sphere(shape)),
                         JSharding(mesh, P("x", None, None)))
    mk = (lambda m: fg.LinearIsotropic(mu=m[0], lam=m[1])) \
        if law == "isotropic" else \
        (lambda m: fg.ScalarLinearIsotropic(mu=m[0], dim=dim))
    mat = fg.VoigtMixed([fg.Phase("fiber", mk(mf), phi),
                         fg.Phase("matrix", mk(mm), 1.0 - phi)], dim=dim)
    s = fg.LSSolver(fg.Grid(*shape), mat, fg.SolverOptions(
        mode=mode, use_pallas="off", **POLAR_OPT),
        sharding=JSharding(mesh, P(None, "x", None, None)))
    s.set_strain(load)
    return s


@pytest.mark.parametrize("mode", list(POLAR))
def test_sharded_polarization_matches_jax(mode):
    """Eyre-Milton on four CPU slabs (the kz-slab K5 twin) against the JAX
    package's sharded polarization on four devices, float64: the same
    reference material and iterations, histories within 1e-9 (or 1e-14
    absolute: epsilon entries are differences of two norms), fields and
    mean stress within 1e-10."""
    js, ps = _polar_jax(mode), _polar_port(mode, 4)
    assert js.par is not None and ps.par is not None
    assert ps.scheme == js.scheme == "collocated"
    assert not js.run() and not ps.run()
    assert ps.mu_0 == pytest.approx(js.mu_0, rel=1e-12)
    rj, rp = np.asarray(js.residuals), np.asarray(ps.residuals)
    assert len(rp) == len(rj)
    np.testing.assert_allclose(rp, rj, rtol=1e-9, atol=1e-14)
    assert np.max(np.abs(ps.get_field("epsilon") - np.asarray(js.eps))) \
        <= 1e-10
    S_ref = np.asarray(js.calc_mean_stress())
    np.testing.assert_allclose(ps.calc_mean_stress(), S_ref, rtol=0,
                               atol=1e-10 * np.max(np.abs(S_ref)))


@pytest.mark.parametrize("d", [None, 4])
def test_polarization_reports_no_boundary_condition_error(d, capsys):
    """Polarization does not test the boundary condition, as in the JAX
    package (check_bc=False): its log has no boundary condition line,
    sharded or not, where CG's has one."""
    LOG.enabled = True
    s = _polar_port("elasticity", d, shape=(8, 4, 5))
    assert not s.run()
    polar = capsys.readouterr().out
    assert "Converged." in polar
    assert "Boundary condition error" not in polar
    cg = _polar_port("elasticity", d, shape=(8, 4, 5))
    cg.opt.method = "cg"
    assert not cg.run()
    assert "Boundary condition error" in capsys.readouterr().out
