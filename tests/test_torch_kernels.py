"""The port's kernel functions against the JAX package.

* The plain twins of K1 (stress_div_beta, also in tau-sum mode), K2
  (eps_from_u_dot, also in Delta mode), K3 (g0_staggered_chain) and K4
  (g0_staggered_heat_chain), and the plain heat stencils, against
  fibergen_tpu's plain operators in float64.
* The same twins in float32 against the Pallas kernels they replace, run
  in Pallas interpret mode as the JAX package's own tests run them.

The CUDA kernels against their twins are in test_torch_cuda.py.
"""
import contextlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from fibergen_tpu.core import fields as jfields
from fibergen_tpu.core.grid import Grid as JGrid
from fibergen_tpu.materials import laws as jlaws
from fibergen_tpu.materials import mixing as jmixing
from fibergen_tpu.ops import fft as jfft
from fibergen_tpu.ops import green as jgreen
from fibergen_tpu.ops import pallas_chain as pc
from fibergen_tpu.ops import pallas_kernels as pk
from fibergen_tpu.ops import pallas_sweep as psw
from fibergen_tpu.ops import staggered as jstag
from fibergen_tpu_torch.core.grid import Grid
from fibergen_tpu_torch.ops import fft, green, staggered, stencil_kernels

torch.set_num_threads(2)

GRIDS = [((15, 13, 11), (1.0, 1.0, 1.0)),
         ((16, 12, 10), (1.0, 1.0, 1.0)),
         ((15, 13, 11), (2.0, 0.5, 1.3))]
MU0, LAM0 = 2.75, 0.0


def _grids(shape, cell):
    kw = dict(dx=cell[0], dy=cell[1], dz=cell[2])
    return Grid(*shape, **kw), JGrid(*shape, **kw)


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    return dict(r=rng.standard_normal((6,) + shape),
                pp=rng.standard_normal((6,) + shape),
                u=rng.standard_normal((3,) + shape),
                phi=rng.random(shape),
                E=np.array([0.1, -0.2, 0.3, 0.05, 0.0, -0.07]),
                beta=0.37)


def _jax_material(phi):
    """Two isotropic phases mixed by the JAX Voigt rule; returns the
    material and its per-voxel moduli as numpy."""
    mat = jmixing.VoigtMixed([
        jmixing.Phase("a", jlaws.LinearIsotropic(mu=10.0, lam=5.0),
                      jnp.asarray(phi)),
        jmixing.Phase("b", jlaws.LinearIsotropic(mu=1.0, lam=1.0),
                      jnp.asarray(1.0 - phi))], dim=6)
    mu_x, lam_x = (np.asarray(t) for t in mat._all_iso())
    return mat, mu_x, lam_x


def _t(x, dtype=torch.float64):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _rel(a, ref):
    """Max-abs error relative to the reference's max-abs (complex values
    compare as their real and imaginary parts)."""
    a, ref = np.asarray(a), np.asarray(ref)
    if np.iscomplexobj(ref):
        a, ref = np.stack([a.real, a.imag]), np.stack([ref.real, ref.imag])
    a, ref = a.astype(np.float64), ref.astype(np.float64)
    return np.max(np.abs(a - ref)) / np.max(np.abs(ref))


# ------------------------------------------------ twins vs JAX (float64)

@pytest.mark.parametrize("shape,cell", GRIDS)
def test_stress_div_beta_twin_matches_jax(shape, cell):
    g, jg = _grids(shape, cell)
    x = _inputs(shape)
    mat, mu_x, lam_x = _jax_material(x["phi"])
    beta = jnp.asarray(x["beta"])
    p_ref = jnp.asarray(x["r"]) + beta * jnp.asarray(x["pp"])
    f_ref = jstag.div_staggered(jg, mat.stress_diff(p_ref, MU0, LAM0))
    f, p = stencil_kernels.stress_div_beta(
        g, _t(x["r"]), _t(x["pp"]), _t(x["beta"]), _t(mu_x), _t(lam_x),
        MU0, LAM0)
    assert _rel(p, p_ref) <= 1e-15
    assert _rel(f, f_ref) <= 1e-12
    # init mode: no direction update
    f0_ref = jstag.div_staggered(
        jg, mat.stress_diff(jnp.asarray(x["r"]), MU0, LAM0))
    f0, p0 = stencil_kernels.stress_div_beta(
        g, _t(x["r"]), None, None, _t(mu_x), _t(lam_x), MU0, LAM0)
    assert p0 is None
    assert _rel(f0, f0_ref) <= 1e-12


@pytest.mark.parametrize("shape,cell", GRIDS)
def test_eps_from_u_dot_twin_matches_jax(shape, cell):
    g, jg = _grids(shape, cell)
    x = _inputs(shape, seed=1)
    w_ref = jstag.eps_staggered(jg, jnp.asarray(x["E"]), jnp.asarray(x["u"]))
    p = jnp.asarray(x["r"])
    dot_ref = float(jfields.inner_l2_diff(p, p, w_ref)) * g.nxyz
    w, dot = stencil_kernels.eps_from_u_dot(g, _t(x["E"]), _t(x["u"]),
                                            _t(x["r"]))
    assert _rel(w, w_ref) <= 1e-12
    assert float(dot) == pytest.approx(dot_ref, rel=1e-12)
    w2, none = stencil_kernels.eps_from_u_dot(g, _t(x["E"]), _t(x["u"]))
    assert none is None
    assert _rel(w2, w_ref) <= 1e-12


@pytest.mark.parametrize("shape,cell", GRIDS)
def test_g0_staggered_twin_matches_jax(shape, cell):
    g, jg = _grids(shape, cell)
    f = np.random.default_rng(2).standard_normal((3,) + shape)
    ref_hat = jgreen.g0_staggered(jg, MU0, LAM0, jfft.fftn(jnp.asarray(f)))
    out_hat = green.g0_staggered(g, MU0, LAM0, fft.fftn(_t(f)))
    assert _rel(out_hat.numpy(), np.asarray(ref_hat)) <= 1e-12
    ref = jfft.ifftn(ref_hat, shape)
    out = green.g0_staggered_fused(g, MU0, LAM0, _t(f))
    assert _rel(out, ref) <= 1e-12


@pytest.mark.parametrize("shape,cell", GRIDS)
def test_tau_sum_and_delta_twins_match_jax(shape, cell):
    """K1 tau-sum mode against the JAX stress difference summed over the
    grid; K2 Delta mode against the plain gradient plus the Delta term."""
    g, jg = _grids(shape, cell)
    x = _inputs(shape, seed=5)
    mat, mu_x, lam_x = _jax_material(x["phi"])
    p_ref = jnp.asarray(x["r"]) + x["beta"] * jnp.asarray(x["pp"])
    for pp, p_in in ((x["pp"], p_ref), (None, jnp.asarray(x["r"]))):
        tau_ref = mat.stress_diff(p_in, MU0, LAM0)
        f, p, ts = stencil_kernels.stress_div_beta(
            g, _t(x["r"]), None if pp is None else _t(pp), _t(x["beta"]),
            _t(mu_x), _t(lam_x), MU0, LAM0, want_tau_sum=True)
        assert (p is None) == (pp is None)
        assert _rel(f, jstag.div_staggered(jg, tau_ref)) <= 1e-12
        assert _rel(ts, tau_ref.sum(axis=(1, 2, 3))) <= 1e-12
    tau2c, mu0 = -0.4, 1.3
    pv = jnp.asarray(x["r"])
    w_ref = (jstag.eps_staggered(jg, jnp.asarray(x["E"]), jnp.asarray(x["u"]))
             + tau2c * 2.0 * (jnp.asarray(mu_x) - mu0)[None] * pv)
    dot_ref = float(jfields.inner_l2_diff(pv, pv, w_ref)) * g.nxyz
    w, dot = stencil_kernels.eps_from_u_dot(g, _t(x["E"]), _t(x["u"]),
                                            _t(x["r"]), mu_x=_t(mu_x),
                                            tau2c=tau2c, mu0=mu0)
    assert _rel(w, w_ref) <= 1e-12
    assert float(dot) == pytest.approx(dot_ref, rel=1e-12)
    with pytest.raises(ValueError, match="Delta"):
        stencil_kernels.eps_from_u_dot(g, _t(x["E"]), _t(x["u"]),
                                       mu_x=_t(mu_x))


@pytest.mark.parametrize("shape,cell", GRIDS)
def test_heat_stencils_and_g0_twin_match_jax(shape, cell):
    """The plain scalar stencils, the scalar G0 on the half-spectrum and
    the K4 chain's twin against the JAX package."""
    g, jg = _grids(shape, cell)
    rng = np.random.default_rng(6)
    tau, u, E = (rng.standard_normal((3,) + shape),
                 rng.standard_normal((1,) + shape), np.array([0.3, -1.0, 0.2]))
    f_ref = jstag.div_staggered_heat(jg, jnp.asarray(tau))
    f = staggered.div_staggered_heat(g, _t(tau))
    assert f.shape == (1,) + shape and _rel(f, f_ref) <= 1e-12
    w = staggered.eps_staggered_heat(g, _t(E), _t(u))
    assert _rel(w, jstag.eps_staggered_heat(jg, jnp.asarray(E),
                                            jnp.asarray(u))) <= 1e-12
    ref_hat = jgreen.g0_staggered_heat(jg, MU0, 0.0, jfft.fftn(f_ref))
    out_hat = green.g0_staggered_heat(g, MU0, 0.0, fft.fftn(f))
    assert _rel(out_hat.numpy(), np.asarray(ref_hat)) <= 1e-12
    out = green.g0_staggered_heat_fused(g, MU0, 0.0, f)
    assert out.shape == (1,) + shape
    assert _rel(out, jfft.ifftn(ref_hat, shape)) <= 1e-12


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_dual_constants_are_finite_and_equal(dtype):
    """The viscosity Delta scheme's G0 constants (-mu0, lambda -> inf) give
    c20 = c10 = -1/mu0, finite in float32 and float64, also for a rigid
    phase (mu = 0, so lmin = 0 and mu0 = lmax / 4 > 0)."""
    for lmin in (0.1, 0.0):
        mu0 = 0.5 * (0.5 * (lmin + 1.0))
        c10, c20 = (dtype(c) for c in green.g0_constants(-mu0, float("inf")))
        assert np.isfinite(c10) and np.isfinite(c20)
        assert c10 == c20 == dtype(-1.0 / mu0)
        jc = jgreen.g0_staggered(JGrid(4, 4, 4), -mu0, float("inf"),
                                 jnp.ones((3, 4, 4, 3), jnp.complex128))
        assert np.all(np.isfinite(np.asarray(jc)))


# --------------------------- twins vs the Pallas kernels (interpret mode)

@pytest.fixture
def pallas_interpret():
    old = pk.INTERPRET
    pk.INTERPRET = True
    yield
    pk.INTERPRET = old


def _f32(x):
    return jnp.asarray(np.asarray(x, np.float32))


def test_stencil_twins_match_pallas_kernels(pallas_interpret):
    """#1 stress_div_staggered, #2 stress_div_beta_staggered and #5
    stress_div_beta_sweep against the K1 twin; #3 eps_from_u_staggered,
    #4 eps_from_u_dot_staggered and #6 eps_from_u_dot_sweep against the K2
    twin, in float32 at (8, 8, 128)."""
    shape = (8, 8, 128)
    g, jg = Grid(*shape), JGrid(*shape)
    x = _inputs(shape, seed=3)
    mu = 1.0 + x["phi"]
    lam = 0.5 + x["phi"][::-1].copy()
    r, pp, u, E = (x[k].astype(np.float32) for k in ("r", "pp", "u", "E"))
    beta = np.float32(x["beta"])
    t32 = lambda a: _t(a, torch.float32)
    mu32, lam32 = t32(mu), t32(lam)

    f, p = stencil_kernels.stress_div_beta(g, t32(r), t32(pp), t32(beta),
                                           mu32, lam32, MU0, LAM0)
    for kern in (pk.stress_div_beta_staggered, psw.stress_div_beta_sweep):
        f_ref, p_ref = kern(jg, _f32(r), _f32(pp), jnp.float32(beta),
                            _f32(mu), _f32(lam), MU0, LAM0)
        assert _rel(p, p_ref) <= 1e-6
        assert _rel(f, f_ref) <= 1e-5
    f0, _ = stencil_kernels.stress_div_beta(g, t32(r), None, None, mu32,
                                            lam32, MU0, LAM0)
    f0_ref = pk.stress_div_staggered(jg, _f32(r), _f32(mu), _f32(lam), MU0,
                                     LAM0)
    assert _rel(f0, f0_ref) <= 1e-5

    w, dot = stencil_kernels.eps_from_u_dot(g, t32(E), t32(u), t32(r))
    for kern in (pk.eps_from_u_dot_staggered, psw.eps_from_u_dot_sweep):
        w_ref, dot_ref = kern(jg, E, _f32(u), _f32(r))
        assert _rel(w, w_ref) <= 1e-5
        assert float(dot) == pytest.approx(float(dot_ref), rel=1e-5)
    w0, _ = stencil_kernels.eps_from_u_dot(g, t32(E), t32(u))
    assert _rel(w0, pk.eps_from_u_staggered(jg, E, _f32(u))) <= 1e-5


@contextlib.contextmanager
def _forced_middle():
    old = (pc.MM_MIDDLE, pc.INTERPRET, jfft.FFT_BACKEND)
    pc.MM_MIDDLE, pc.INTERPRET = "on", True
    jfft.FFT_BACKEND = "matmul"
    try:
        yield
    finally:
        pc.MM_MIDDLE, pc.INTERPRET, jfft.FFT_BACKEND = old


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-10),
                                       (np.float32, 1e-5)])
def test_g0_chain_matches_pallas_middle(dtype, tol):
    """#7 pallas_chain._middle with _g0_apply (g0_staggered_middle) against
    the K3 chain's plain twin (rfftn -> G0 apply -> irfftn)."""
    shape = (8, 6, 10)
    g, jg = Grid(*shape), JGrid(*shape)
    f = np.random.default_rng(4).standard_normal((3,) + shape).astype(dtype)
    c10, c20 = green.g0_constants(MU0, 0.4)
    with _forced_middle():
        ref = pc.g0_staggered_middle(jg, jnp.asarray(f), c10, c20)
    out = green.g0_staggered_fused(g, MU0, 0.4, torch.as_tensor(f))
    assert out.dtype == torch.as_tensor(f).dtype
    assert _rel(out, ref) <= tol


def test_mode_twins_match_pallas_sweep(pallas_interpret):
    """#5' stress_div_beta_sweep(want_tau_sum=True) against the K1 tau-sum
    twin and #6' eps_from_u_dot_sweep(mu_x, tau2c, mu0) against the K2
    Delta twin, in float32 at (8, 8, 128)."""
    shape = (8, 8, 128)
    g, jg = Grid(*shape), JGrid(*shape)
    x = _inputs(shape, seed=7)
    mu = 1.0 + x["phi"]
    lam = np.zeros(shape)
    r, pp, u, E = (x[k].astype(np.float32) for k in ("r", "pp", "u", "E"))
    beta = np.float32(0.61)
    mu0, tau2c = 1.5, -0.375
    t32 = lambda a: _t(a, torch.float32)

    f, p, ts = stencil_kernels.stress_div_beta(
        g, t32(r), t32(pp), t32(beta), t32(mu), t32(lam), mu0, 0.0,
        want_tau_sum=True)
    f_ref, p_ref, ts_ref = psw.stress_div_beta_sweep(
        jg, _f32(r), _f32(pp), jnp.float32(beta), _f32(mu), _f32(lam), mu0,
        0.0, want_tau_sum=True)
    assert ts.dtype == torch.float32 and ts.shape == (6,)
    assert _rel(p, p_ref) <= 1e-6
    assert _rel(f, f_ref) <= 1e-5
    assert _rel(ts, ts_ref) <= 1e-5

    w, dot = stencil_kernels.eps_from_u_dot(g, t32(E), t32(u), t32(r),
                                            mu_x=t32(mu), tau2c=tau2c,
                                            mu0=mu0)
    w_ref, dot_ref = psw.eps_from_u_dot_sweep(jg, E, _f32(u), _f32(r),
                                              mu_x=_f32(mu), tau2c=tau2c,
                                              mu0=mu0)
    assert _rel(w, w_ref) <= 1e-5
    assert float(dot) == pytest.approx(float(dot_ref), rel=1e-5)


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-10),
                                       (np.float32, 1e-5)])
def test_g0_heat_chain_matches_pallas_middle(dtype, tol):
    """#8 pallas_chain._middle with _g0_heat_apply (g0_staggered_heat_middle)
    against the K4 chain's plain twin, set up as the JAX package's own
    test of that middle."""
    shape = (8, 6, 5)
    g = Grid(*shape, dx=1.5, dy=0.7, dz=1.0)
    jg = JGrid(*shape, dx=1.5, dy=0.7, dz=1.0)
    f = np.random.default_rng(4).standard_normal((1,) + shape).astype(dtype)
    c10 = 1.0 / 1.3          # -alpha / (2 mu_0) with alpha = -1, mu_0 = 0.65
    with _forced_middle():
        ref = pc.g0_staggered_heat_middle(jg, jnp.asarray(f), c10)
    out = green.g0_staggered_heat_fused(g, 0.65, 0.0, torch.as_tensor(f))
    assert out.dtype == torch.as_tensor(f).dtype
    assert _rel(out, ref) <= tol
