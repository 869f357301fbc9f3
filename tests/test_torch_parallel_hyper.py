"""The port's sharded finite-strain operators and Newton-Krylov solve
against the JAX package's, on the CPU.

A mesh of repeated CPU devices (``parallel.make_mesh(["cpu"] * D)``) runs
the slab code with the plain twins, as the JAX package's tests run its
sharded code on forced host devices (conftest):

* op level: the twins of the two finite-strain slab chains (K5 at C = 9,
  K3 with the full-gradient constants) through ``green.*_hyper_fused(...,
  par=)`` against the JAX package's, whose ``pallas_chain.*_middle_slab``
  runs in interpret mode, on eight devices at (16, 16, 128) float32;
* the halo forms of the full-gradient stencils against the unsharded
  stencils;
* solve level in float64: the port's sharded Newton-Krylov on four CPU
  slabs against the JAX package's sharded ``LSSolver`` on four devices,
  on both grids with both tangents, entry for entry in the residual
  history.

The port's sharded solves against its own unsharded ones, sharded
polarization and the solver-level checks are in
test_torch_parallel_hyper_solve.py; the CUDA kernels against these twins
in test_torch_cuda.py.
"""
import contextlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh, NamedSharding as JSharding
from jax.sharding import PartitionSpec as P

import fibergen_tpu as fg
from fibergen_tpu.materials import laws as jlaws
from fibergen_tpu.ops import fft as jfft
from fibergen_tpu.ops import green as jgreen
from fibergen_tpu.ops import pallas_chain as pc
from fibergen_tpu.parallel.fft import SlabFFT
from fibergen_tpu.utils.logging import LOG as JLOG
import fibergen_tpu_torch as ft
from fibergen_tpu_torch import parallel
from fibergen_tpu_torch.ops import green, staggered
from fibergen_tpu_torch.parallel import comm
from fibergen_tpu_torch.utils.logging import LOG

torch.set_num_threads(2)

MU0 = 1.7
OP_SHAPE = (16, 16, 128)
SHAPE = (16, 8, 9)
LOAD = [1.02, 1, 1, 0, 0, 0, 0, 0, 0]


@pytest.fixture(autouse=True)
def _quiet():
    old = (JLOG.enabled, LOG.enabled)
    JLOG.enabled = LOG.enabled = False
    yield
    JLOG.enabled, LOG.enabled = old


def _jmesh(d):
    devs = jax.devices()
    assert len(devs) >= d, "conftest must force 8 virtual CPU devices"
    return Mesh(np.array(devs[:d]), axis_names=("x",))


def _rel(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return np.max(np.abs(a - ref)) / np.max(np.abs(ref))


@contextlib.contextmanager
def _forced_middle():
    old = (pc.MM_MIDDLE, pc.INTERPRET, jfft.FFT_BACKEND)
    pc.MM_MIDDLE, pc.INTERPRET = "on", True
    jfft.FFT_BACKEND = "matmul"
    try:
        yield
    finally:
        pc.MM_MIDDLE, pc.INTERPRET, jfft.FFT_BACKEND = old


# ------------------------------------------------------------- op level
@pytest.mark.parametrize("lam0", [0.0, 0.4])
@pytest.mark.parametrize("kind", ["gamma9", "g0_hyper"])
def test_hyper_slab_chains_match_middle_slab(kind, lam0, monkeypatch):
    """The finite-strain slab chains' twins on eight x-slabs, through
    green's ``par=`` entry points, against the JAX package's
    ``green.gamma_collocated_hyper_fused`` and ``g0_staggered_hyper_fused``
    with ``par=SlabFFT``, whose kz-slab middle
    (pallas_chain.*_middle_slab, interpret mode) must run: float32, within
    1e-6 of the reference's max."""
    rng = np.random.default_rng(31)
    cell = dict(dx=1.2, dy=0.9, dz=1.0)
    jgrid, pgrid = fg.Grid(*OP_SHAPE, **cell), ft.Grid(*OP_SHAPE, **cell)
    jm = _jmesh(8)
    jpar = SlabFFT(jm, "x")
    spec = JSharding(jm, P(None, "x", None, None))
    mesh = parallel.make_mesh(["cpu"] * 8)
    par = parallel.slab_fft_for(parallel.field_sharding(mesh), pgrid)
    called = []
    for name in ("g0_staggered_middle_slab", "gamma_collocated_middle_slab"):
        orig = getattr(pc, name)
        monkeypatch.setattr(pc, name, lambda *a, _o=orig, _n=name, **k: (
            called.append(_n), _o(*a, **k))[1])
    ncomp = 9 if kind == "gamma9" else 3
    x = rng.standard_normal((ncomp,) + OP_SHAPE).astype(np.float32)
    E = rng.standard_normal(9).astype(np.float32)
    xj = jax.device_put(jnp.asarray(x), spec)
    xs = parallel.shard_field(torch.as_tensor(x), mesh)
    with _forced_middle():
        if kind == "gamma9":
            ref = jgreen.gamma_collocated_hyper_fused(
                jgrid, E, MU0, lam0, xj, -1.0, 0.37, par=jpar)
            out = green.gamma_collocated_hyper_fused(
                pgrid, comm.replicate(torch.as_tensor(E), par.devices), MU0,
                lam0, xs, -1.0, 0.37, par=par)
        else:
            ref = jgreen.g0_staggered_hyper_fused(jgrid, MU0, lam0, xj,
                                                  par=jpar)
            out = green.g0_staggered_hyper_fused(pgrid, MU0, lam0, xs,
                                                 par=par)
    want = "gamma_collocated" if kind == "gamma9" else "g0_staggered"
    assert called == [f"{want}_middle_slab"]
    assert len(out) == 8 and all(o.dtype == torch.float32 for o in out)
    assert _rel(parallel.gather_field(out), ref) <= 1e-6


@pytest.mark.parametrize("d", [1, 4])
def test_hyper_halo_stencils_match_unsharded(d):
    """The full-gradient stencils on D x-slabs with the neighbours' halo
    planes equal the unsharded stencils (D = 1: one slab wraps its own
    halo)."""
    rng = np.random.default_rng(32)
    g = ft.Grid(16, 4, 5, dx=1.1, dy=0.8, dz=1.3)
    u = torch.as_tensor(rng.standard_normal((3,) + g.shape))
    tau = torch.as_tensor(rng.standard_normal((9,) + g.shape))
    E = torch.as_tensor(rng.standard_normal(9))
    mesh = parallel.make_mesh(["cpu"] * d)
    us, ts = parallel.shard_field(u, mesh), parallel.shard_field(tau, mesh)
    uh, th = comm.halo_x(us), comm.halo_x(ts)
    eps = [staggered.eps_staggered_hyper(g, E, x, halo=(uh[0][i], uh[1][i]))
           for i, x in enumerate(us)]
    div = [staggered.div_staggered_hyper(g, x, halo=(th[0][i], th[1][i]))
           for i, x in enumerate(ts)]
    assert torch.equal(parallel.gather_field(eps),
                       staggered.eps_staggered_hyper(g, E, u))
    assert torch.equal(parallel.gather_field(div),
                       staggered.div_staggered_hyper(g, tau))


# ------------------------------------------------------------ solve level
def _sphere(shape):
    ax = [(np.arange(s) + 0.5) / s - 0.5 for s in shape]
    X, Y, Z = np.meshgrid(*ax, indexing="ij")
    return ((X * X + Y * Y + Z * Z) < 0.09).astype(np.float64)


# the estimators and tolerance of the SVK sphere's parity solves in
# test_torch_hyper.py (ESTIMATORS): below about 3e-7 of the first inner
# residual the recursive CG residual carries float64 rounding noise
OPTS = dict(mode="hyperelasticity", method="cg", dtype="float64",
            maxiter=500, error_estimator="residual",
            outer_error_estimator="epsilon", tol=1e-6)
MODULI = ((10.0, 5.0), (1.0, 1.0))        # SVK fibre, matrix (mu, lam)


def _jax_solver(scheme, tangent):
    mesh = _jmesh(4)
    phi = jax.device_put(jnp.asarray(_sphere(SHAPE)),
                         JSharding(mesh, P("x", None, None)))
    mat = fg.VoigtMixed([
        fg.Phase("fiber", jlaws.SaintVenantKirchhoff(*MODULI[0]), phi),
        fg.Phase("matrix", jlaws.SaintVenantKirchhoff(*MODULI[1]),
                 1.0 - phi)], dim=9)
    s = fg.LSSolver(fg.Grid(*SHAPE), mat, fg.SolverOptions(
        gamma_scheme=scheme, newton_tangent=tangent, **OPTS),
        sharding=JSharding(mesh, P(None, "x", None, None)))
    s.set_strain(LOAD)
    return s


def _port_solver(scheme, tangent, d=4):
    phi = _sphere(SHAPE)
    mat = ft.convert.material_from_numpy(
        [("fiber", *MODULI[0], phi), ("matrix", *MODULI[1], 1.0 - phi)],
        dim=9, law="svk", device="cpu")
    s = ft.LSSolver(ft.Grid(*SHAPE), mat, ft.SolverOptions(
        gamma_scheme=scheme, newton_tangent=tangent, **OPTS), device="cpu",
        sharding=parallel.field_sharding(parallel.make_mesh(["cpu"] * d)))
    s.set_strain(LOAD)
    return s


@pytest.fixture(scope="module")
def jax_solves():
    """The JAX package's sharded Newton solves, each run once for the
    module."""
    cache = {}

    def get(scheme, tangent):
        if (scheme, tangent) not in cache:
            s = _jax_solver(scheme, tangent)
            assert s.par is not None
            assert not s.run()
            cache[scheme, tangent] = s
        return cache[scheme, tangent]
    return get


@pytest.mark.parametrize("tangent", ["exact", "frozen_iso"])
@pytest.mark.parametrize("scheme", ["staggered", "collocated"])
def test_sharded_newton_matches_jax(jax_solves, scheme, tangent):
    """Four CPU slabs against the JAX package's sharded Newton on four
    devices, float64 on (16, 8, 9) (kz = 5 does not split evenly): the
    same reference material, residual histories of equal length (inner and
    outer entries) within 1e-9 (the outer epsilon entries, differences of
    two norms, within 1e-14 absolute), the gathered field within 1e-9, and
    the means and min det F within 1e-10."""
    js = jax_solves(scheme, tangent)
    ps = _port_solver(scheme, tangent)
    assert ps.par is not None and ps.par.n_devices == 4
    assert not ps.run()
    assert isinstance(ps.eps, list) and len(ps.eps) == 4
    assert ps.mu_0 == pytest.approx(js.mu_0, rel=1e-12)
    assert ps.lambda_0 == js.lambda_0 == 0.0
    rj, rp = np.asarray(js.residuals), np.asarray(ps.residuals)
    assert len(rp) == len(rj)
    np.testing.assert_allclose(rp, rj, rtol=1e-9, atol=1e-14)
    outer, inner = ps.newton_iterations
    assert outer >= 2 and inner + outer == len(rp)
    assert np.max(np.abs(ps.get_field("epsilon") - np.asarray(js.eps))) \
        <= 1e-9
    S_ref = np.asarray(js.calc_mean_stress())
    np.testing.assert_allclose(ps.calc_mean_stress(), S_ref, rtol=0,
                               atol=1e-10 * np.max(np.abs(S_ref)))
    np.testing.assert_allclose(ps.calc_mean_strain(), LOAD, atol=1e-12)
    np.testing.assert_allclose(ps.calc_mean_cauchy(), js.calc_mean_cauchy(),
                               rtol=0, atol=1e-10)
    assert ps.calc_mean_energy() == pytest.approx(js.calc_mean_energy(),
                                                  rel=1e-10)
    assert ps.calc_min_det_f() == pytest.approx(js.calc_min_det_f(),
                                                rel=1e-10)
