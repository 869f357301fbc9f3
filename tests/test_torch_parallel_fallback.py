"""``sharding_fallback="warn"`` and the two public slab helpers of the
port, in float64 on the CPU:

* a mesh whose ny does not divide it warns with the JAX package's message
  and the port's own line, then solves whole on the mesh's first device:
  bitwise the unsharded port's solve, and the JAX package's fallback solve
  on four host devices at the limits of
  ``test_torch_parallel.py::test_sharded_solve_matches_jax``;
* ``"error"`` raises the same ``SolverError`` as before;
* ``parallel.scalar_sharding`` is replicated;
* ``parallel.SlabFFT``'s four transforms against the JAX package's
  ``SlabFFT`` on four devices within 1e-12.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh, NamedSharding as JSharding
from jax.sharding import PartitionSpec as P

import fibergen_tpu as fg
from fibergen_tpu.parallel.fft import SlabFFT as JSlabFFT
from fibergen_tpu.utils.logging import LOG as JLOG
import fibergen_tpu_torch as ft
from fibergen_tpu_torch import parallel
from fibergen_tpu_torch.solvers.ls import SolverError
from fibergen_tpu_torch.utils.logging import LOG

torch.set_num_threads(2)

SHAPE = (8, 6, 7)        # ny = 6 does not divide a four-slab mesh


@pytest.fixture(autouse=True)
def _quiet():
    old = (JLOG.enabled, LOG.enabled)
    JLOG.enabled = LOG.enabled = False
    yield
    JLOG.enabled, LOG.enabled = old


def _jmesh(d):
    return Mesh(np.array(jax.devices()[:d]), axis_names=("x",))


def _sphere(shape):
    ax = [(np.arange(s) + 0.5) / s - 0.5 for s in shape]
    X, Y, Z = np.meshgrid(*ax, indexing="ij")
    return ((X * X + Y * Y + Z * Z) < 0.09).astype(np.float64)


def _port(sharding=None, **opt):
    phi = _sphere(SHAPE)
    mat = ft.convert.material_from_numpy(
        [("fiber", 10.0, 5.0, phi), ("matrix", 1.0, 1.0, 1.0 - phi)],
        device="cpu")
    s = ft.LSSolver(ft.Grid(*SHAPE), mat, ft.SolverOptions(
        tol=1e-8, maxiter=400, **opt), device="cpu", sharding=sharding)
    s.set_strain([1.0, 0, 0, 0, 0.3, 0])
    return s


def _four_slabs():
    return parallel.field_sharding(parallel.make_mesh(["cpu"] * 4))


def test_fallback_warns_and_error_raises(capsys):
    """The JAX package's warning, then the port's line; under "error" the
    same SolverError with the reason and the way out."""
    LOG.enabled = True
    s = _port(_four_slabs(), sharding_fallback="warn")
    out = capsys.readouterr()
    text = out.out + out.err
    assert "sharded solve cannot use the slab FFT: ny=6 not divisible by " \
        "the 4-device mesh" in text
    assert "neither memory nor ICI traffic scales with the mesh" in text
    assert "SolverOptions(sharding_fallback='warn') to proceed with " \
        "replicated FFTs anyway." in text
    assert "the port solves this 8x6x7 mesh whole on its first device, " \
        "cpu" in text
    assert s.par is None and s.device.type == "cpu"
    with pytest.raises(SolverError, match="ny=6 not divisible") as e:
        _port(_four_slabs())
    assert "sharding_fallback='warn'" in str(e.value)


@pytest.mark.parametrize("method", ["cg", "basic"])
def test_fallback_solve_is_the_unsharded_solve(method):
    """Bitwise: residuals, the strain field and the mean stress of the
    fallback solve are the unsharded port's; the fields are whole."""
    est = "residual" if method == "cg" else "epsilon"
    s = _port(_four_slabs(), sharding_fallback="warn", method=method,
              error_estimator=est)
    ref = _port(method=method, error_estimator=est)
    assert not s.run() and not ref.run()
    assert s.residuals == ref.residuals
    assert isinstance(s.eps, torch.Tensor) and torch.equal(s.eps, ref.eps)
    assert np.array_equal(s.calc_mean_stress(), ref.calc_mean_stress())
    assert s.get_field("epsilon").shape == (6,) + SHAPE


def test_fallback_solve_matches_jax_fallback():
    """The port's fallback against the JAX package's on four host devices
    (use_pallas="off", the replicated FFTs): the same iterations,
    histories within 1e-9, the field within 1e-9, mean stress within 1e-10
    of its max."""
    phi = jax.device_put(jnp.asarray(_sphere(SHAPE)),
                         JSharding(_jmesh(4), P("x", None, None)))
    mat = fg.VoigtMixed([
        fg.Phase("fiber", fg.LinearIsotropic(mu=10.0, lam=5.0), phi),
        fg.Phase("matrix", fg.LinearIsotropic(mu=1.0, lam=1.0), 1.0 - phi)],
        dim=6)
    js = fg.LSSolver(fg.Grid(*SHAPE), mat, fg.SolverOptions(
        dtype="float64", tol=1e-8, maxiter=400, method="basic",
        error_estimator="epsilon", use_pallas="off",
        sharding_fallback="warn"),
        sharding=JSharding(_jmesh(4), P(None, "x", None, None)))
    assert js.par is None
    js.set_strain([1.0, 0, 0, 0, 0.3, 0])
    ps = _port(_four_slabs(), sharding_fallback="warn", method="basic",
               error_estimator="epsilon")
    assert not js.run() and not ps.run()
    rj, rp = np.asarray(js.residuals), np.asarray(ps.residuals)
    assert len(rp) == len(rj)
    np.testing.assert_allclose(rp, rj, rtol=1e-9, atol=1e-14)
    eps_ref = np.asarray(js.eps)
    assert np.max(np.abs(ps.get_field("epsilon") - eps_ref)) <= 1e-9
    S_ref = np.asarray(js.calc_mean_stress())
    np.testing.assert_allclose(ps.calc_mean_stress(), S_ref, rtol=0,
                               atol=1e-10 * np.max(np.abs(S_ref)))


def test_scalar_sharding_is_replicated():
    mesh = parallel.make_mesh(["cpu"] * 4)
    sh = parallel.scalar_sharding(mesh)
    assert isinstance(sh, parallel.NamedSharding) and sh.mesh is mesh
    assert sh.is_fully_replicated and sh.spec == ()
    assert parallel.slab_reject_reason(sh, ft.Grid(8, 8, 8)).startswith(
        "field spec PartitionSpec() is replicated")


@pytest.mark.parametrize("shape", [(8, 8, 9), (16, 8, 6)])
def test_slab_fft_matches_jax(shape):
    """fftn, ifftn and the two zero-trace transforms over four slabs: the
    gathered spectrum against the JAX package's SlabFFT (gathered from its
    y-split hat field) within 1e-12, the inverses back to the field."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((6,) + shape)
    x[0] = -(x[1] + x[2])
    mesh = parallel.make_mesh(["cpu"] * 4)
    F, JF = parallel.SlabFFT(mesh), JSlabFFT(_jmesh(4))
    assert F.supports(*shape) == JF.supports(*shape) is True
    jx = jax.device_put(jnp.asarray(x), JF.field_sharding())
    xs = parallel.shard_field(torch.as_tensor(x), mesh)
    for fwd, inv in (("fftn", "ifftn"), ("fftn_zero_trace", "ifftn_zero_trace")):
        y = getattr(F, fwd)(xs)
        jy = np.asarray(getattr(JF, fwd)(jx))
        np.testing.assert_allclose(F.gather(y).numpy(), jy, rtol=0,
                                   atol=1e-12)
        back = parallel.gather_field(getattr(F, inv)(y, shape)).numpy()
        jback = np.asarray(getattr(JF, inv)(jnp.asarray(jy), shape))
        np.testing.assert_allclose(back, jback, rtol=0, atol=1e-12)
        np.testing.assert_allclose(back, x, rtol=0, atol=1e-12)
