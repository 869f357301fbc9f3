"""The batched chains (``spectral_kernels.*_chain_batched``) and the batched
CG that runs them (``LSSolver.run_batched``), in the port's plain path on
the CPU.

* Each batched chain's plain twin (K3, K4, K5 at C = 6 and 3, K6), B = 3 on
  (8, 6, 10) with a distinct DC vector per case, against ``jax.vmap`` of
  the JAX package's fused operator through its Pallas middle
  (pallas_chain._middle under vmap: the batching rule adds B to its grid),
  run in interpret mode as the JAX package's own tests run it; and
  against B calls of the single twin.
* run_batched on every whole-field path that reaches a chain: only the
  batched wrappers are called, once per step and once for the init, and
  the residual histories and means equal the per-case loop's.
* The batched wrappers' refusals, K1's and K2's ``out=``, get_fft_time
  after a batched solve, and the heat and Nunan-Keller demos' load cases
  through FG reaching the batched chain.

The CUDA kernels against these twins, bitwise against B single launches,
are in test_torch_cuda.py.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_demos as demos
import fibergen_tpu_torch as ft
from fibergen_tpu.core.grid import Grid as JGrid
from fibergen_tpu.ops import fft as jfft
from fibergen_tpu.ops import green as jgreen
from fibergen_tpu.ops import pallas_chain as pc
from fibergen_tpu_torch.core.grid import Grid
from fibergen_tpu_torch.ops import green, spectral_kernels, stencil_kernels
from fibergen_tpu_torch.solvers import ls
from fibergen_tpu_torch.utils.logging import LOG

torch.set_num_threads(2)

SHAPE, B = (8, 6, 10), 3
MU0, LAM0, BETA = 2.75, 0.4, 0.3


@pytest.fixture(autouse=True)
def _quiet():
    old = LOG.enabled
    LOG.enabled = False
    yield
    LOG.enabled = old


@contextlib.contextmanager
def _forced_middle():
    """The JAX package's Pallas middle on the CPU: interpret mode, the
    matmul FFT backend (as tests/test_torch_kernels.py runs it)."""
    old = (pc.MM_MIDDLE, pc.INTERPRET, jfft.FFT_BACKEND)
    pc.MM_MIDDLE, pc.INTERPRET = "on", True
    jfft.FFT_BACKEND = "matmul"
    try:
        yield
    finally:
        pc.MM_MIDDLE, pc.INTERPRET, jfft.FFT_BACKEND = old


# chain -> (components C of its batch, E's length or None, the JAX fused
# operator of one case (jg, field, E), the port's batched operator (g,
# batch, E))
CHAINS = {
    "K3": (3, None,
           lambda jg, f, E: jgreen.g0_staggered_fused(jg, MU0, LAM0, f),
           lambda g, f, E: green.g0_staggered_fused_batched(g, MU0, LAM0, f)),
    "K4": (1, None,
           lambda jg, f, E: jgreen.g0_staggered_heat_fused(jg, MU0, LAM0, f),
           lambda g, f, E: green.g0_staggered_heat_fused_batched(g, MU0, LAM0,
                                                                  f)),
    "K5-6": (6, 6,
             lambda jg, t, E: jgreen.gamma_collocated_fused(
                 jg, E, MU0, LAM0, t, -1.0, BETA),
             lambda g, t, E: green.gamma_collocated_fused_batched(
                 g, E, MU0, LAM0, t, -1.0, BETA)),
    "K5-3": (3, 3,
             lambda jg, t, E: jgreen.gamma_collocated_heat_fused(
                 jg, E, MU0, LAM0, t, -1.0, BETA),
             lambda g, t, E: green.gamma_collocated_heat_fused_batched(
                 g, E, MU0, LAM0, t, -1.0, BETA)),
    "K6": (6, 6,
           lambda jg, t, E: jgreen.gamma_collocated_zt_fused(
               jg, E, MU0, LAM0, t, -1.0, BETA),
           lambda g, t, E: green.gamma_collocated_zt_fused_batched(
               g, E, MU0, LAM0, t, -1.0, BETA)),
}


def _batch(chain, dtype, seed=3):
    """A (B, C, *SHAPE) batch from ``seed`` (K6's traceless) and the cases'
    E, a (B, n) table of distinct rows (None where the chain has none)."""
    C, ne, _, _ = CHAINS[chain]
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((B, C) + SHAPE).astype(dtype)
    if chain == "K6":
        f[:, 0] = -(f[:, 1] + f[:, 2])
    E = None if ne is None else rng.standard_normal((B, ne)).astype(dtype)
    return f, E


def _rel(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(a - ref)) / np.max(np.abs(ref)))


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-10),
                                       (np.float32, 1e-5)])
@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_batched_twin_matches_vmapped_pallas_middle(chain, dtype, tol):
    """#7 under jax.vmap (the route the JAX package's run_batched takes)
    against the batched twin, each case with its own E."""
    _, _, jax_op, port_op = CHAINS[chain]
    f, E = _batch(chain, dtype)
    jg, g = JGrid(*SHAPE), Grid(*SHAPE)
    Ej = jnp.zeros((B, 1), dtype) if E is None else jnp.asarray(E)
    with _forced_middle():
        assert pc.middle_enabled(SHAPE, 3)
        ref = jax.vmap(lambda x, e: jax_op(jg, x, e))(jnp.asarray(f), Ej)
    out = port_op(g, torch.as_tensor(f), None if E is None
                  else torch.as_tensor(E))
    assert out.dtype == torch.as_tensor(f).dtype
    assert tuple(out.shape) == f.shape
    assert _rel(out, ref) <= tol


SINGLE = {
    "K3": lambda g, x, E: green.g0_staggered_fused(g, MU0, LAM0, x),
    "K4": lambda g, x, E: green.g0_staggered_heat_fused(g, MU0, LAM0, x),
    "K5-6": lambda g, x, E: green.gamma_collocated_fused(g, E, MU0, LAM0, x,
                                                         -1.0, BETA),
    "K5-3": lambda g, x, E: green.gamma_collocated_heat_fused(
        g, E, MU0, LAM0, x, -1.0, BETA),
    "K6": lambda g, x, E: green.gamma_collocated_zt_fused(g, E, MU0, LAM0, x,
                                                          -1.0, BETA),
}


@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_batched_twin_matches_single_twins(chain):
    """The batched twin against B calls of the single twin, float64, and
    one ``calls`` entry per batched call; one E for every case broadcasts."""
    f, E = _batch(chain, np.float64, seed=11)
    g = Grid(*SHAPE, dx=1.2, dy=0.8, dz=1.0)
    f, E = torch.as_tensor(f), None if E is None else torch.as_tensor(E)
    before = dict(spectral_kernels.calls)
    out = CHAINS[chain][3](g, f, E)
    moved = {k: v - before.get(k, 0) for k, v in spectral_kernels.calls.items()
             if v != before.get(k, 0)}
    assert len(moved) == 1
    (name, ncomp), n = next(iter(moved.items()))
    assert name.endswith("_batched") and ncomp == f.shape[1] and n == 1
    ref = torch.stack([SINGLE[chain](g, f[b], None if E is None else E[b])
                       for b in range(B)])
    assert float((out - ref).abs().max()) <= 1e-14 * float(ref.abs().max())
    if E is not None:
        one = CHAINS[chain][3](g, f, E[1])
        ref1 = torch.stack([SINGLE[chain](g, f[b], E[1]) for b in range(B)])
        assert float((one - ref1).abs().max()) <= \
            1e-14 * float(ref1.abs().max())


def test_batched_wrappers_refuse_bad_input():
    g = Grid(*SHAPE)
    sk = spectral_kernels
    f3 = torch.zeros((B, 3) + SHAPE, dtype=torch.float64)
    t6 = torch.zeros((B, 6) + SHAPE, dtype=torch.float64)
    E6 = torch.zeros((B, 6), dtype=torch.float64)
    with pytest.raises(ValueError, match="expected"):
        sk.g0_staggered_chain_batched(g, f3[0], 1.0, 0.5)       # no B axis
    with pytest.raises(ValueError, match="expected"):
        sk.g0_staggered_chain_batched(g, f3[:, :1].contiguous(), 1.0, 0.5)
    with pytest.raises(ValueError, match="expected"):
        sk.g0_staggered_heat_chain_batched(g, f3, 1.0)
    with pytest.raises(ValueError, match="expected"):
        sk.g0_staggered_chain_batched(Grid(8, 6, 9), f3, 1.0, 0.5)
    with pytest.raises(ValueError, match="contiguous"):
        sk.g0_staggered_chain_batched(
            g, torch.zeros((3, B) + SHAPE, dtype=torch.float64).transpose(0, 1),
            1.0, 0.5)
    with pytest.raises(ValueError, match="contiguous"):
        sk.gamma_collocated_zt_chain_batched(g, t6.transpose(3, 4)
                                             .contiguous().transpose(3, 4),
                                             1.0, 0.5, E6, 0.0)
    with pytest.raises(TypeError):
        sk.g0_staggered_chain_batched(g, f3.to(torch.int32), 1.0, 0.5)
    with pytest.raises(ValueError, match="expected"):
        sk.gamma_collocated_chain_batched(g, t6[:, :5].contiguous(), 1.0, 0.5,
                                          E6[:, :5], 0.0)
    with pytest.raises(ValueError, match="E has"):
        sk.gamma_collocated_chain_batched(g, t6, 1.0, 0.5, E6[:2], 0.0)
    with pytest.raises(ValueError, match="E has"):
        sk.gamma_collocated_chain_batched(g, f3, 1.0, 0.5, E6, 0.0)
    with pytest.raises(ValueError, match="E has"):
        sk.gamma_collocated_zt_chain_batched(g, t6, 1.0, 0.5, E6[:, :5], 0.0)
    with pytest.raises(ValueError, match="expected"):
        sk.gamma_collocated_zt_chain_batched(g, f3, 1.0, 0.5, E6, 0.0)


def test_k1_k2_write_into_out():
    """K1's f and K2's w go into ``out=`` (here rows of a batch), with the
    values of the calls without it."""
    g = Grid(*SHAPE)
    rng = np.random.default_rng(2)
    t = lambda *s: torch.as_tensor(rng.standard_normal(s))
    r, pp, u, E = t(6, *SHAPE), t(6, *SHAPE), t(3, *SHAPE), t(6)
    mu, lam = 1.0 + t(*SHAPE).abs(), t(*SHAPE).abs()
    beta = (torch.tensor(0.7, dtype=torch.float64),
            torch.tensor(2.0, dtype=torch.float64))
    fb = torch.zeros((2, 3) + SHAPE, dtype=torch.float64)
    f, p = stencil_kernels.stress_div_beta(g, r, pp, beta, mu, lam, MU0, LAM0)
    f1, p1, ts1 = stencil_kernels.stress_div_beta(
        g, r, pp, beta, mu, lam, MU0, LAM0, want_tau_sum=True, out=fb[1])
    assert f1.data_ptr() == fb[1].data_ptr() and torch.equal(fb[1], f)
    assert torch.equal(p1, p) and ts1.shape == (6,)
    assert torch.equal(fb[0], torch.zeros_like(f))
    wb = torch.zeros((2, 6) + SHAPE, dtype=torch.float64)
    w, dot = stencil_kernels.eps_from_u_dot(g, E, u, r)
    w1, dot1 = stencil_kernels.eps_from_u_dot(g, E, u, r, out=wb[0])
    assert w1.data_ptr() == wb[0].data_ptr() and torch.equal(wb[0], w)
    assert torch.equal(dot1, dot)


def _sphere(shape):
    ax = [(np.arange(s) + 0.5) / s - 0.5 for s in shape]
    X, Y, Z = np.meshgrid(*ax, indexing="ij")
    return ((X * X + Y * Y + Z * Z) < 0.09).astype(np.float64)


GRID, CELL = (9, 7, 5), (1.2, 0.8, 1.0)
VISC = np.array([[0, 0, 0, 0, 1.0, 0], [0, 0, 0, 0, 2.0, 0]])
# path -> (mode, scheme, law, (fibre, matrix) moduli, rule, load cases,
# the batched chain wrapper it takes)
PATHS = {
    "elasticity-k1": ("elasticity", "staggered", "isotropic",
                      ((10.0, 5.0), (1.0, 1.0)), "voigt", np.eye(6),
                      "g0_staggered_chain_batched"),
    "elasticity-generic": ("elasticity", "staggered", "isotropic",
                           ((10.0, 5.0), (1.0, 1.0)), "maximum", np.eye(6),
                           "g0_staggered_chain_batched"),
    "viscosity-k1": ("viscosity", "staggered", "scalar", ((0.1,), (1.0,)),
                     "voigt", VISC, "g0_staggered_chain_batched"),
    "viscosity-generic": ("viscosity", "staggered", "scalar",
                          ((0.1,), (1.0,)), "maximum", VISC,
                          "g0_staggered_chain_batched"),
    "heat": ("heat", "staggered", "scalar", ((10.0,), (1.0,)), "voigt",
             np.eye(3), "g0_staggered_heat_chain_batched"),
    "elasticity-collocated": ("elasticity", "collocated", "isotropic",
                              ((10.0, 5.0), (1.0, 1.0)), "voigt", np.eye(6),
                              "gamma_collocated_chain_batched"),
    "heat-collocated": ("heat", "collocated", "scalar", ((10.0,), (1.0,)),
                        "voigt", np.eye(3), "gamma_collocated_chain_batched"),
    "viscosity-collocated": ("viscosity", "collocated", "scalar",
                             ((0.1,), (1.0,)), "voigt", VISC,
                             "gamma_collocated_zt_chain_batched"),
}


def _solver(path, check_every=4):
    mode, scheme, law, moduli, rule, _, _ = PATHS[path]
    dim = 3 if mode == "heat" else 6
    phi = _sphere(GRID)
    mat = ft.convert.material_from_numpy(
        [("fiber", *moduli[0], phi), ("matrix", *moduli[1], 1.0 - phi)],
        dim=dim, device="cpu", law=law, rule=rule)
    return ft.LSSolver(ft.convert.grid_from_numpy(GRID, CELL), mat,
                       ft.SolverOptions(mode=mode, gamma_scheme=scheme,
                                        dtype="float64", tol=1e-9,
                                        error_estimator="residual",
                                        check_every=check_every,
                                        maxiter=500), device="cpu")


@pytest.mark.parametrize("path", sorted(PATHS))
def test_run_batched_takes_one_batched_chain_per_step(path, monkeypatch):
    """run_batched calls only its path's batched chain wrapper, once per
    step and once for the init, and lands where the per-case loop (one
    single chain per case and step) lands: the same residual history and
    means."""
    Es, wrapper = PATHS[path][5], PATHS[path][6]
    s = _solver(path)
    assert s._batched_chain()
    calls0 = dict(spectral_kernels.calls)
    assert not s.run_batched(Es)
    moved = {k: v - calls0.get(k, 0) for k, v in spectral_kernels.calls.items()
             if v != calls0.get(k, 0)}
    steps = -(-len(s.residuals) // 4) * 4          # whole chunks of 4
    assert moved == {(wrapper, _components(path)): steps + 1}
    assert s._k1_route == path.endswith("-k1")
    res, S = list(s.residuals), s.calc_mean_stress_batched()

    ref = _solver(path)
    monkeypatch.setattr(ls.LSSolver, "_batched_chain", lambda self: False)
    calls0 = dict(spectral_kernels.calls)
    assert not ref.run_batched(Es)
    moved = {k for k, v in spectral_kernels.calls.items()
             if v != calls0.get(k, 0)}
    assert all(not k[0].endswith("_batched") for k in moved)
    np.testing.assert_allclose(res, ref.residuals, rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(S, ref.calc_mean_stress_batched(), rtol=0,
                               atol=1e-12 * np.max(np.abs(S)))


def _components(path):
    """The components of the batch a path's chain takes."""
    mode, scheme = PATHS[path][:2]
    if scheme == "collocated":
        return 6 if mode != "heat" else 3
    return 1 if mode == "heat" else 3


def test_run_batched_keeps_the_per_case_loop_without_a_chain():
    """Willot's Gamma (torch.fft, no chain) steps case by case, as before;
    get_fft_time after a batched solve times the batched chain."""
    s = _solver("elasticity-k1")
    assert not s.run_batched(np.eye(6)[:2])
    assert set(s._chain_calls) == {("g0_staggered_chain_batched", 3)}
    t = s.get_fft_time()
    assert 0.0 < t <= s.solve_time
    phi = _sphere(GRID)
    mat = ft.convert.material_from_numpy(
        [("fiber", 10.0, 5.0, phi), ("matrix", 1.0, 1.0, 1.0 - phi)],
        device="cpu")
    w = ft.LSSolver(ft.convert.grid_from_numpy(GRID, CELL), mat,
                    ft.SolverOptions(gamma_scheme="willot", dtype="float64",
                                     tol=1e-6, error_estimator="residual"),
                    device="cpu")
    assert not w._batched_chain()
    assert not w.run_batched(np.eye(6)[:2])
    assert w._chain_calls == {}


@pytest.mark.parametrize("name,wrapper", [
    ("heat", ("g0_staggered_heat_chain_batched", 1)),
    ("nunan_keller", ("g0_staggered_chain_batched", 3))])
def test_fg_demos_batch_their_load_cases(name, wrapper):
    """calc_effective_properties of the heat and Nunan-Keller demos (at
    the test sizes of tests/_torch_demos.py) reaches the batched chain
    through run_batched: one call per step and one for the init, no
    single chain."""
    f = demos.load(ft.FG, name, sequential=False, device="cpu")
    assert f.run() == 0
    s = f.solver
    K = max(1, int(s.opt.check_every))
    assert s.eps_batch.shape[0] == (3 if name == "heat" else 5)
    assert s._chain_calls == {wrapper: -(-len(s.residuals) // K) * K + 1}
