"""Each CUDA kernel of the port against its plain PyTorch twin.

These need a card (the kernels have no CPU mode) and skip without one.
The module imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from fibergen_tpu_torch.core.grid import Grid
from fibergen_tpu_torch.ops import green, spectral_kernels, stencil_kernels

MU0, LAM0 = 2.75, 0.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _rel(out, ref):
    if out.is_complex():
        out, ref = torch.view_as_real(out), torch.view_as_real(ref)
    out, ref = out.double().cpu(), ref.double().cpu()
    return float((out - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("shape", [(33, 17, 29), (16, 12, 10), (32, 64, 1)])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_cuda_kernels_match_twins(cuda, shape, dtype, tol):
    g = Grid(*shape, dx=1.0, dy=0.7, dz=1.3)
    rng = np.random.default_rng(5)
    dev = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=cuda)
    r, pp = dev(rng.standard_normal((6,) + shape)), \
        dev(rng.standard_normal((6,) + shape))
    u, E = dev(rng.standard_normal((3,) + shape)), dev(rng.standard_normal(6))
    mu, lam = dev(1.0 + rng.random(shape)), dev(0.5 + rng.random(shape))
    gam, gam_prev = dev(0.74), dev(2.0)
    before = dict(stencil_kernels.launches, **spectral_kernels.launches)

    f, p = stencil_kernels.stress_div_beta(g, r, pp, (gam, gam_prev), mu,
                                           lam, MU0, LAM0)
    f_ref, p_ref = stencil_kernels.stress_div_beta_plain(
        g, r, pp, gam / gam_prev, mu, lam, MU0, LAM0)
    assert _rel(p, p_ref) <= tol and _rel(f, f_ref) <= tol
    f0, _ = stencil_kernels.stress_div_beta(g, r, None, None, mu, lam, MU0,
                                            LAM0)
    f0_ref, _ = stencil_kernels.stress_div_beta_plain(g, r, None, None, mu,
                                                      lam, MU0, LAM0)
    assert _rel(f0, f0_ref) <= tol

    w, dot = stencil_kernels.eps_from_u_dot(g, E, u, r)
    w_ref, dot_ref = stencil_kernels.eps_from_u_dot_plain(g, E, u, r)
    assert _rel(w, w_ref) <= tol
    assert float(dot) == pytest.approx(float(dot_ref), rel=tol)
    w0, none = stencil_kernels.eps_from_u_dot(g, E, u)
    assert none is None and _rel(w0, w_ref) <= tol

    c10, c20 = green.g0_constants(MU0, LAM0)
    u = spectral_kernels.g0_staggered_chain(g, f_ref, c10, c20)
    u_ref = spectral_kernels.g0_staggered_chain_plain(g, f_ref, c10, c20)
    torch.cuda.synchronize()
    assert _rel(u, u_ref) <= tol
    after = dict(stencil_kernels.launches, **spectral_kernels.launches)
    assert {k: after[k] - before[k] for k in after} == {
        "stress_div_beta": 2, "eps_from_u_dot": 2, "g0_staggered_chain": 1,
        "g0_staggered_heat_chain": 0}


@pytest.mark.parametrize("shape,dtype,tol", [
    ((33, 17, 29), torch.float64, 1e-12),
    ((16, 12, 10), torch.float64, 1e-12),
    ((256, 256, 256), torch.float32, 1e-5)])
def test_cuda_mode_kernels_match_twins(cuda, shape, dtype, tol):
    """K1 tau-sum mode (step and init), K2 Delta mode and the K4 scalar
    chain against their twins, with the launch counts they add."""
    g = Grid(*shape, dx=1.0, dy=0.7, dz=1.3)
    gen = torch.Generator(device=cuda).manual_seed(7)
    rnd = lambda *s: torch.randn(s, generator=gen, device=cuda, dtype=dtype)
    r, pp, u = rnd(6, *shape), rnd(6, *shape), rnd(3, *shape)
    mu, lam, E = 1.0 + rnd(*shape).abs(), 0.5 + rnd(*shape).abs(), rnd(6)
    gam, gam_prev = torch.tensor(0.74, dtype=dtype, device=cuda), \
        torch.tensor(2.0, dtype=dtype, device=cuda)
    mu0, tau2c = 1.25, -0.2
    before = dict(stencil_kernels.launches, **spectral_kernels.launches)

    f, p, ts = stencil_kernels.stress_div_beta(
        g, r, pp, (gam, gam_prev), mu, lam, mu0, LAM0, want_tau_sum=True)
    f_ref, p_ref, ts_ref = stencil_kernels.stress_div_beta_plain(
        g, r, pp, gam / gam_prev, mu, lam, mu0, LAM0, want_tau_sum=True)
    assert _rel(p, p_ref) <= tol and _rel(f, f_ref) <= tol
    assert _rel(ts, ts_ref) <= tol
    f0, none, ts0 = stencil_kernels.stress_div_beta(
        g, r, None, None, mu, lam, mu0, LAM0, want_tau_sum=True)
    f0_ref, _, ts0_ref = stencil_kernels.stress_div_beta_plain(
        g, r, None, None, mu, lam, mu0, LAM0, want_tau_sum=True)
    assert none is None and _rel(f0, f0_ref) <= tol
    assert _rel(ts0, ts0_ref) <= tol

    w, dot = stencil_kernels.eps_from_u_dot(g, E, u, r, mu_x=mu,
                                            tau2c=tau2c, mu0=mu0)
    w_ref, dot_ref = stencil_kernels.eps_from_u_dot_plain(
        g, E, u, r, mu_x=mu, tau2c=tau2c, mu0=mu0)
    assert _rel(w, w_ref) <= tol
    assert float(dot) == pytest.approx(float(dot_ref), rel=tol)

    c10 = 1.0 / (2.0 * mu0)
    h = spectral_kernels.g0_staggered_heat_chain(g, f_ref[:1], c10)
    h_ref = spectral_kernels.g0_staggered_heat_chain_plain(g, f_ref[:1], c10)
    torch.cuda.synchronize()
    assert h.shape == (1,) + shape and _rel(h, h_ref) <= tol
    after = dict(stencil_kernels.launches, **spectral_kernels.launches)
    assert {k: after[k] - before[k] for k in after} == {
        "stress_div_beta": 2, "eps_from_u_dot": 1, "g0_staggered_chain": 0,
        "g0_staggered_heat_chain": 1}


def test_cuda_wrappers_reject_bad_input(cuda):
    g = Grid(4, 4, 4)
    r = torch.zeros((6, 4, 4, 4), device=cuda)
    mu = torch.ones((4, 4, 4), device=cuda)
    with pytest.raises(TypeError):
        stencil_kernels.stress_div_beta(g, r, None, None, mu.double(), mu,
                                        1.0, 0.0)
    with pytest.raises(ValueError):
        stencil_kernels.stress_div_beta(g, r[:, :, :, :2], None, None, mu,
                                        mu, 1.0, 0.0)
    with pytest.raises(ValueError):
        stencil_kernels.eps_from_u_dot(
            g, torch.zeros(6, device=cuda),
            torch.zeros((3, 4, 4, 4), device=cuda).transpose(1, 2))
    with pytest.raises(ValueError, match="Delta"):
        stencil_kernels.eps_from_u_dot(
            g, torch.zeros(6, device=cuda), torch.zeros((3, 4, 4, 4),
                                                        device=cuda), mu_x=mu)
    with pytest.raises(ValueError):
        spectral_kernels.g0_staggered_heat_chain(g, r[:3].contiguous(), 1.0)
