"""Each CUDA kernel of the port against its plain PyTorch twin.

These need a card (the kernels have no CPU mode) and skip without one.
The module imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

import fibergen_tpu_torch as ft
from fibergen_tpu_torch import parallel
from fibergen_tpu_torch.core.grid import Grid
from fibergen_tpu_torch.ops import green, spectral_kernels, stencil_kernels
from fibergen_tpu_torch.parallel import comm

MU0, LAM0 = 2.75, 0.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _launched(before, after):
    """The launch counts that moved between two snapshots."""
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


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
    assert _launched(before, after) == {
        "stress_div_beta": 2, "eps_from_u_dot": 2, "g0_staggered_chain": 1}


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
    assert _launched(before, after) == {
        "stress_div_beta": 2, "eps_from_u_dot": 1,
        "g0_staggered_heat_chain": 1}


@pytest.mark.parametrize("shape,dtype,tol", [
    ((33, 17, 29), torch.float64, 1e-12),
    ((16, 12, 10), torch.float64, 1e-12),
    ((32, 64, 1), torch.float32, 1e-5),
    ((256, 256, 256), torch.float32, 1e-5)])
def test_cuda_collocated_chains_match_twins(cuda, shape, dtype, tol):
    """K5 (6 and 3 components) and K6 against their twins, with a device E
    and beta != 0, and the launch counts they add."""
    g = Grid(*shape, dx=1.2, dy=0.8, dz=1.0)
    gen = torch.Generator(device=cuda).manual_seed(9)
    rnd = lambda *s: torch.randn(s, generator=gen, device=cuda, dtype=dtype)
    tau6, tau3, E6, E3 = rnd(6, *shape), rnd(3, *shape), rnd(6), rnd(3)
    tau6[0] = -(tau6[1] + tau6[2])
    A, B = green.collocated_constants(1.7, 0.3)
    before = dict(stencil_kernels.launches, **spectral_kernels.launches)
    for tau, E in ((tau6, E6), (tau3, E3)):
        out = spectral_kernels.gamma_collocated_chain(g, tau, A, B, E, 0.37)
        ref = spectral_kernels.gamma_collocated_chain_plain(g, tau, A, B, E,
                                                            0.37)
        torch.cuda.synchronize()
        assert out.shape == tau.shape and _rel(out, ref) <= tol
    A, B = green.collocated_constants(-1.7, float("inf"))
    out = spectral_kernels.gamma_collocated_zt_chain(g, tau6, A, B, E6, -0.3)
    ref = spectral_kernels.gamma_collocated_zt_chain_plain(g, tau6, A, B, E6,
                                                           -0.3)
    torch.cuda.synchronize()
    assert out.shape == tau6.shape and _rel(out, ref) <= tol
    after = dict(stencil_kernels.launches, **spectral_kernels.launches)
    assert _launched(before, after) == {
        "gamma_collocated_chain": 2, "gamma_collocated_zt_chain": 1}


@pytest.mark.parametrize("shape,dtype,tol", [
    ((33, 17, 29), torch.float64, 1e-12),
    ((16, 12, 10), torch.float64, 1e-12),
    ((32, 64, 1), torch.float32, 1e-5),
    ((256, 256, 256), torch.float32, 1e-5)])
def test_cuda_hyper_chains_match_twins(cuda, shape, dtype, tol):
    """K5 at C = 9 (the finite-strain collocated Gamma, lambda_0 = 0 and
    finite, device E, beta != 0) and K3 with the full-gradient constants
    against their twins; all K5 launches count as gamma_collocated_chain."""
    g = Grid(*shape, dx=1.2, dy=0.8, dz=1.0)
    gen = torch.Generator(device=cuda).manual_seed(11)
    rnd = lambda *s: torch.randn(s, generator=gen, device=cuda, dtype=dtype)
    tau, E, f = rnd(9, *shape), rnd(9), rnd(3, *shape)
    before = dict(stencil_kernels.launches, **spectral_kernels.launches)
    for lam0, beta in ((0.0, 0.0), (0.3, 0.37)):
        A, B = green.hyper_constants(1.7, lam0)
        out = spectral_kernels.gamma_collocated_hyper_chain(g, tau, A, B, E,
                                                            beta)
        ref = spectral_kernels.gamma_collocated_hyper_chain_plain(g, tau, A,
                                                                  B, E, beta)
        torch.cuda.synchronize()
        assert out.shape == tau.shape and _rel(out, ref) <= tol
    A, B = green.hyper_constants(1.7, 0.0)
    u = green.g0_staggered_hyper_fused(g, 1.7, 0.0, f)
    u_ref = spectral_kernels.g0_staggered_chain_plain(g, f, -A, B)
    torch.cuda.synchronize()
    assert _rel(u, u_ref) <= tol
    after = dict(stencil_kernels.launches, **spectral_kernels.launches)
    assert _launched(before, after) == {
        "g0_staggered_chain": 1, "gamma_collocated_chain": 2}


@pytest.mark.parametrize("scheme,chain", [
    ("staggered", "g0_staggered_chain"),
    ("collocated", "gamma_collocated_chain")])
def test_cuda_hyper_solve_matches_cpu(cuda, scheme, chain):
    """A float64 Newton-Krylov solve (two-phase SVK sphere, 2 % stretch) on
    the card against the CPU: the same residual history within 1e-9 and
    mean PK1 within 1e-10; the card's run launches only its chain."""
    n = 16
    a = ((np.arange(n) + 0.5) / n - 0.5) ** 2
    phi = ((a[:, None, None] + a[None, :, None] + a[None, None, :])
           < 0.09).astype(np.float64)
    res = {}
    for dev in ("cpu", "cuda"):
        mat = ft.convert.material_from_numpy(
            [("fiber", 10.0, 5.0, phi), ("matrix", 1.0, 1.0, 1.0 - phi)],
            dim=9, law="svk", device=dev)
        s = ft.LSSolver(Grid(n, n, n), mat, ft.SolverOptions(
            mode="hyperelasticity", gamma_scheme=scheme, tol=1e-6,
            error_estimator="residual", outer_error_estimator="epsilon",
            check_every=4), device=dev)
        s.set_strain([1.02, 1, 1, 0, 0, 0, 0, 0, 0])
        before = dict(stencil_kernels.launches, **spectral_kernels.launches)
        assert not s.run()
        after = dict(stencil_kernels.launches, **spectral_kernels.launches)
        res[dev] = (np.asarray(s.residuals), s.calc_mean_stress(),
                    {k for k in after if after[k] > before[k]})
    (rc, Sc, kc), (rg, Sg, kg) = res["cpu"], res["cuda"]
    assert kc == set() and kg == {chain}
    assert len(rg) == len(rc)
    np.testing.assert_allclose(rg, rc, rtol=1e-9, atol=1e-14)
    np.testing.assert_allclose(Sg, Sc, rtol=0,
                               atol=1e-10 * np.max(np.abs(Sc)))


# Every length of the register line FFT (spectral_kernels.LINE_PLANS) on
# each axis, beside a length that is not a power of two (the direct DFT)
# on another axis; and powers of two outside 16..512 (the shared-memory
# radix-4 FFT).
REG_SHAPES = [s for n in (16, 32, 64, 128, 256, 512)
              for s in ((n, 17, 16), (33, n, 16), (12, 17, n))] + [
                  (8, 1024, 12), (1024, 4, 17)]


@pytest.mark.parametrize("shape", REG_SHAPES)
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_cuda_register_fft_chains_match_twins(cuda, shape, dtype, tol):
    """K6 and K3 against their twins at every length the register FFT
    takes, on each axis, and at powers of two it leaves to the
    shared-memory FFT."""
    g = Grid(*shape, dx=1.2, dy=0.8, dz=1.0)
    gen = torch.Generator(device=cuda).manual_seed(17)
    rnd = lambda *s: torch.randn(s, generator=gen, device=cuda, dtype=dtype)
    tau, E, f = rnd(6, *shape), rnd(6), rnd(3, *shape)
    tau[0] = -(tau[1] + tau[2])
    A, B = green.collocated_constants(-1.7, float("inf"))
    c10, c20 = green.g0_constants(MU0, 0.4)
    before = dict(stencil_kernels.launches, **spectral_kernels.launches)
    out6 = spectral_kernels.gamma_collocated_zt_chain(g, tau, A, B, E, -0.3)
    out3 = spectral_kernels.g0_staggered_chain(g, f, c10, c20)
    torch.cuda.synchronize()
    after = dict(stencil_kernels.launches, **spectral_kernels.launches)
    assert _launched(before, after) == {"gamma_collocated_zt_chain": 1,
                                        "g0_staggered_chain": 1}
    ref6 = spectral_kernels.gamma_collocated_zt_chain_plain(g, tau, A, B, E,
                                                            -0.3)
    ref3 = spectral_kernels.g0_staggered_chain_plain(g, f, c10, c20)
    assert _rel(out6, ref6) <= tol
    assert _rel(out3, ref3) <= tol


@pytest.mark.parametrize("d", [2, 4])
def test_cuda_register_fft_slab_chains_match_twins(cuda, d):
    """The kz-slab K6 and K3 at power-of-two lengths (the slab middles run
    the register passes) on ["cuda:0"] * d against their plain twins on CPU
    slabs and against the whole-field chains, float64."""
    shape = (64, 32, 64)
    rng = np.random.default_rng(19)
    g = Grid(*shape, dx=1.2, dy=0.8, dz=1.0)
    tau = torch.as_tensor(rng.standard_normal((6,) + shape), device=cuda)
    tau[0] = -(tau[1] + tau[2])
    f = torch.as_tensor(rng.standard_normal((3,) + shape), device=cuda)
    E = torch.as_tensor(rng.standard_normal(6), device=cuda)
    mesh, cmesh = (parallel.make_mesh([dev] * d) for dev in ("cuda:0", "cpu"))
    par, cpar = parallel.SlabPar(mesh), parallel.SlabPar(cmesh)
    G = parallel.gather_field
    sh = lambda a, m: parallel.shard_field(a, m)
    A, B = green.collocated_constants(-MU0, float("inf"))
    c10, c20 = green.g0_constants(MU0, 0.4)
    before = dict(stencil_kernels.launches, **spectral_kernels.launches)
    out6 = spectral_kernels.gamma_collocated_zt_chain_slab(
        par, g, sh(tau, mesh), A, B, [E] * d, -0.2)
    out3 = spectral_kernels.g0_staggered_chain_slab(par, g, sh(f, mesh), c10,
                                                    c20)
    torch.cuda.synchronize()
    after = dict(stencil_kernels.launches, **spectral_kernels.launches)
    assert _launched(before, after) == {
        "gamma_collocated_zt_chain_slab": 3 * d,
        "g0_staggered_chain_slab": 3 * d}
    ref6 = spectral_kernels.gamma_collocated_zt_chain_slab_plain(
        cpar, g, sh(tau.cpu(), cmesh), A, B, [E.cpu()] * d, -0.2)
    ref3 = spectral_kernels.g0_staggered_chain_slab_plain(
        cpar, g, sh(f.cpu(), cmesh), c10, c20)
    assert _rel(G(out6), G(ref6)) <= 1e-12
    assert _rel(G(out3), G(ref3)) <= 1e-12
    whole6 = spectral_kernels.gamma_collocated_zt_chain(g, tau, A, B, E, -0.2)
    whole3 = spectral_kernels.g0_staggered_chain(g, f, c10, c20)
    assert _rel(G(out6), whole6) <= 1e-12
    assert _rel(G(out3), whole3) <= 1e-12


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
    E6 = torch.zeros(6, device=cuda)
    with pytest.raises(ValueError, match="components"):
        spectral_kernels.gamma_collocated_chain(g, r[:5].contiguous(), 1.0,
                                                1.0, E6[:5], 0.0)
    with pytest.raises(ValueError, match="E has"):
        spectral_kernels.gamma_collocated_chain(g, r, 1.0, 1.0, E6[:3], 0.0)
    with pytest.raises(ValueError, match="contiguous"):
        spectral_kernels.gamma_collocated_zt_chain(
            g, r.transpose(1, 2), 1.0, 1.0, E6, 0.0)
    plane = r[:, :1].contiguous()
    with pytest.raises(ValueError, match="halo plane"):
        stencil_kernels.stress_div_beta(
            g, r, None, None, mu, mu, 1.0, 0.0,
            halo=((None, None, mu[:1], mu[:1]), (plane, None, mu[:1],
                                                  mu[:1])))
    with pytest.raises(ValueError, match="halo plane"):
        stencil_kernels.eps_from_u_dot(
            g, torch.zeros(6, device=cuda), r[:3].contiguous(),
            halo=(plane[:3], plane))
    r9 = torch.zeros((9, 4, 4, 4), device=cuda)
    with pytest.raises(ValueError, match="components"):
        spectral_kernels.gamma_collocated_hyper_chain(
            g, r, 1.0, 1.0, E6, 0.0)
    with pytest.raises(ValueError, match="E has"):
        spectral_kernels.gamma_collocated_hyper_chain(
            g, r9, 1.0, 1.0, E6, 0.0)


# ------------------------------------------------ the x-slab path (#11)
def _slab_inputs(shape, dev, dtype, seed=7):
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.as_tensor(rng.standard_normal(s), dtype=dtype,
                                   device=dev)
    return dict(r=t(6, *shape), pp=t(6, *shape), u=t(3, *shape),
                f1=t(1, *shape), t3=t(3, *shape),
                mu=1.0 + t(*shape).abs(), lam=0.5 + t(*shape).abs(),
                E=t(6), gam=torch.tensor(0.74, dtype=dtype, device=dev),
                gp=torch.tensor(2.0, dtype=dtype, device=dev))


@pytest.mark.parametrize("shape,d", [((48, 48, 48), 1), ((48, 48, 48), 2),
                                     ((48, 48, 48), 4), ((33, 16, 29), 1)])
def test_cuda_slab_kernels_match_twins(cuda, shape, d):
    """K1 and K2 in halo mode and the slab chains (K3, K4, K5 at C = 6 and
    3, K6) on ["cuda:0"] * d against the plain twins on the same slabs,
    float64; at d = 1 the halo kernels are bitwise the periodic ones, and
    the slab chains match the whole-field chains."""
    x = _slab_inputs(shape, cuda, torch.float64)
    g = Grid(*shape, dx=1.0, dy=0.7, dz=1.3)
    mesh = parallel.make_mesh(["cuda:0"] * d)
    par = parallel.SlabPar(mesh)
    sh = lambda a: parallel.shard_field(a, mesh)
    G = parallel.gather_field
    r, pp, u, mu, lam = (sh(x[k]) for k in ("r", "pp", "u", "mu", "lam"))
    beta = [(x["gam"], x["gp"])] * d
    E = [x["E"]] * d
    mh = (comm.halo_x(mu), comm.halo_x(lam))
    before = dict(stencil_kernels.launches, **spectral_kernels.launches)
    f, p = stencil_kernels.stress_div_beta_slabs(g, r, pp, beta, mu, lam,
                                                 MU0, LAM0, mh)
    fi, _ = stencil_kernels.stress_div_beta_slabs(g, r, None, None, mu, lam,
                                                  MU0, LAM0, mh)
    w, dot = stencil_kernels.eps_from_u_dot_slabs(g, E, u, pp)
    wn, _ = stencil_kernels.eps_from_u_dot_slabs(g, E, u)
    c10, c20 = green.g0_constants(MU0, LAM0)
    A, B = green.collocated_constants(MU0, 0.4)
    Az, Bz = green.collocated_constants(-MU0, float("inf"))
    chains = {
        "K3": (spectral_kernels.g0_staggered_chain_slab(par, g, f, c10, c20),
               spectral_kernels.g0_staggered_chain(g, G(f), c10, c20)),
        "K4": (spectral_kernels.g0_staggered_heat_chain_slab(
            par, g, sh(x["f1"]), 0.61),
            spectral_kernels.g0_staggered_heat_chain(g, x["f1"], 0.61)),
        "K5/6": (spectral_kernels.gamma_collocated_chain_slab(
            par, g, r, A, B, E, 0.37),
            spectral_kernels.gamma_collocated_chain(g, x["r"], A, B, x["E"],
                                                    0.37)),
        "K5/3": (spectral_kernels.gamma_collocated_chain_slab(
            par, g, sh(x["t3"]), A, 0.0, x["E"][:3], 0.37),
            spectral_kernels.gamma_collocated_chain(g, x["t3"], A, 0.0,
                                                    x["E"][:3], 0.37)),
        "K6": (spectral_kernels.gamma_collocated_zt_chain_slab(
            par, g, r, Az, Bz, E, -0.2),
            spectral_kernels.gamma_collocated_zt_chain(g, x["r"], Az, Bz,
                                                       x["E"], -0.2))}
    torch.cuda.synchronize()
    after = dict(stencil_kernels.launches, **spectral_kernels.launches)
    assert _launched(before, after) == {"stress_div_beta_halo": 2 * d,
                     "eps_from_u_dot_halo": 2 * d,
                     "g0_staggered_chain": 1, "g0_staggered_heat_chain": 1,
                     "gamma_collocated_chain": 2,
                     "gamma_collocated_zt_chain": 1,
                     "g0_staggered_chain_slab": 3 * d,
                     "g0_staggered_heat_chain_slab": 3 * d,
                     "gamma_collocated_chain_slab": 6 * d,
                     "gamma_collocated_zt_chain_slab": 3 * d}
    # the halo kernels against their twins on the same slabs
    cpu = lambda a: [t.cpu() for t in a]
    fc, pc_ = stencil_kernels.stress_div_beta_slabs(
        g, cpu(r), cpu(pp), [(x["gam"].cpu(), x["gp"].cpu())] * d, cpu(mu),
        cpu(lam), MU0, LAM0)
    fic, _ = stencil_kernels.stress_div_beta_slabs(
        g, cpu(r), None, None, cpu(mu), cpu(lam), MU0, LAM0)
    wc, dotc = stencil_kernels.eps_from_u_dot_slabs(
        g, [x["E"].cpu()] * d, cpu(u), cpu(pp))
    for out, ref in ((f, fc), (p, pc_), (fi, fic), (w, wc)):
        assert _rel(G(out), G(ref)) <= 1e-12
    assert float(dot[0]) == pytest.approx(float(dotc[0]), rel=1e-12)
    # the slab chains against the whole-field chains
    for name, (out, ref) in chains.items():
        assert _rel(G(out), ref) <= 1e-12, name
    if d == 1:
        f0, p0 = stencil_kernels.stress_div_beta(
            g, x["r"], x["pp"], (x["gam"], x["gp"]), x["mu"], x["lam"], MU0,
            LAM0)
        fi0, _ = stencil_kernels.stress_div_beta(g, x["r"], None, None,
                                                 x["mu"], x["lam"], MU0, LAM0)
        w0, dot0 = stencil_kernels.eps_from_u_dot(g, x["E"], x["u"], x["pp"])
        wn0, _ = stencil_kernels.eps_from_u_dot(g, x["E"], x["u"])
        for out, ref in ((f[0], f0), (p[0], p0), (fi[0], fi0), (w[0], w0),
                         (wn[0], wn0), (dot[0], dot0)):
            assert torch.equal(out, ref)


def test_cuda_slab_on_a_second_card(cuda):
    """A mesh over two cards: every launch runs with its slab's card
    current (the kernels act on the current device), and the exchanges are
    peer copies; the sharded solve matches the one-card solve."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    n = 32
    a = ((np.arange(n) + 0.5) / n - 0.5) ** 2
    phi = ((a[:, None, None] + a[None, :, None] + a[None, None, :])
           < 0.09).astype(np.float64)
    res = []
    for devs in (["cuda:0"], ["cuda:0", "cuda:1"], ["cuda:1", "cuda:0"]):
        mat = ft.convert.material_from_numpy(
            [("fiber", 10.0, 5.0, phi), ("matrix", 1.0, 1.0, 1.0 - phi)])
        s = ft.LSSolver(Grid(n, n, n), mat, ft.SolverOptions(
            tol=1e-8, error_estimator="residual"),
            sharding=parallel.field_sharding(parallel.make_mesh(devs)))
        s.set_strain([1.0, 0, 0, 0, 0, 0])
        assert not s.run()
        assert [e.device for e in s.eps] == [torch.device(d) for d in devs]
        res.append((np.asarray(s.residuals), s.get_field("epsilon")))
    for rr, eps in res[1:]:
        assert len(rr) == len(res[0][0])
        np.testing.assert_allclose(rr, res[0][0], rtol=1e-9)
        assert np.max(np.abs(eps - res[0][1])) <= 1e-12


@pytest.mark.parametrize("mode,scheme", [
    ("elasticity", "staggered"), ("heat", "staggered"),
    ("elasticity", "collocated"), ("heat", "collocated"),
    ("viscosity", "collocated")])
def test_cuda_sharded_solve_matches_cpu(cuda, mode, scheme):
    """A float64 solve on four slabs of one card against the same solve on
    four CPU slabs (the twins): the same history within 1e-9 and fields
    within 1e-12; the card's run launches its slab kernels and no other."""
    n = 24
    a = ((np.arange(n) + 0.5) / n - 0.5) ** 2
    phi = ((a[:, None, None] + a[None, :, None] + a[None, None, :])
           < 0.09).astype(np.float64)
    dim, law, mods, load = {
        "elasticity": (6, "isotropic", ((10.0, 5.0), (1.0, 1.0)),
                       [1.0, 0, 0, 0, 0, 0]),
        "heat": (3, "scalar", ((10.0,), (1.0,)), [1.0, 0, 0]),
        "viscosity": (6, "scalar", ((0.1,), (1.0,)), [0, 0, 0, 0, 1.0, 0])
    }[mode]
    want = {("elasticity", "staggered"): {"stress_div_beta_halo",
                                          "eps_from_u_dot_halo",
                                          "g0_staggered_chain_slab"},
            ("heat", "staggered"): {"g0_staggered_heat_chain_slab"},
            ("viscosity", "collocated"): {"gamma_collocated_zt_chain_slab"}
            }.get((mode, scheme), {"gamma_collocated_chain_slab"})
    res = {}
    for dev in ("cpu", "cuda:0"):
        mat = ft.convert.material_from_numpy(
            [("fiber", *mods[0], phi), ("matrix", *mods[1], 1.0 - phi)],
            dim=dim, law=law, device=dev)
        s = ft.LSSolver(Grid(n, n, n), mat, ft.SolverOptions(
            mode=mode, gamma_scheme=scheme, tol=1e-8,
            error_estimator="residual", check_every=4),
            sharding=parallel.field_sharding(parallel.make_mesh([dev] * 4)))
        s.set_strain(load)
        before = dict(stencil_kernels.launches, **spectral_kernels.launches)
        assert not s.run()
        after = dict(stencil_kernels.launches, **spectral_kernels.launches)
        res[dev] = (np.asarray(s.residuals), s.get_field("epsilon"),
                    set(_launched(before, after)))
    (rc, ec, kc), (rg, eg, kg) = res["cpu"], res["cuda:0"]
    assert kc == set() and kg == want
    assert len(rg) == len(rc)
    np.testing.assert_allclose(rg, rc, rtol=1e-9)
    assert np.max(np.abs(eg - ec)) <= 1e-12


@pytest.mark.parametrize("shape,d", [((48, 48, 48), 1), ((48, 48, 48), 2),
                                     ((48, 48, 48), 4), ((33, 16, 29), 1)])
def test_cuda_hyper_slab_chains_match_twins(cuda, shape, d):
    """The finite-strain slab chains, K5 at C = 9 (lambda_0 = 0 and finite,
    beta != 0, E per slab) and K3 with the full-gradient constants, on
    ["cuda:0"] * d against their plain twins on CPU slabs and against the
    whole-field chains, float64; each slab chain launches 3 d times (z,
    middle, z inverse on every slab)."""
    rng = np.random.default_rng(13)
    g = Grid(*shape, dx=1.2, dy=0.8, dz=1.0)
    tau = torch.as_tensor(rng.standard_normal((9,) + shape), device=cuda)
    f = torch.as_tensor(rng.standard_normal((3,) + shape), device=cuda)
    E = torch.as_tensor(rng.standard_normal(9), device=cuda)
    mesh = parallel.make_mesh(["cuda:0"] * d)
    cmesh = parallel.make_mesh(["cpu"] * d)
    par, cpar = parallel.SlabPar(mesh), parallel.SlabPar(cmesh)
    G = parallel.gather_field
    for lam0, beta in ((0.0, 0.0), (0.3, 0.37)):
        A, B = green.hyper_constants(1.7, lam0)
        before = dict(stencil_kernels.launches, **spectral_kernels.launches)
        out9 = spectral_kernels.gamma_collocated_hyper_chain_slab(
            par, g, parallel.shard_field(tau, mesh), A, B, [E] * d, beta)
        out3 = green.g0_staggered_hyper_fused(
            g, 1.7, lam0, parallel.shard_field(f, mesh), par=par)
        torch.cuda.synchronize()
        after = dict(stencil_kernels.launches, **spectral_kernels.launches)
        assert _launched(before, after) == {
            "gamma_collocated_chain_slab": 3 * d,
            "g0_staggered_chain_slab": 3 * d}
        ref9 = spectral_kernels.gamma_collocated_hyper_chain_slab_plain(
            cpar, g, parallel.shard_field(tau.cpu(), cmesh), A, B,
            [E.cpu()] * d, beta)
        ref3 = spectral_kernels.g0_staggered_chain_slab_plain(
            cpar, g, parallel.shard_field(f.cpu(), cmesh), -A, B)
        assert _rel(G(out9), G(ref9)) <= 1e-12
        assert _rel(G(out3), G(ref3)) <= 1e-12
        whole9 = spectral_kernels.gamma_collocated_hyper_chain(g, tau, A, B,
                                                               E, beta)
        whole3 = green.g0_staggered_hyper_fused(g, 1.7, lam0, f)
        assert _rel(G(out9), whole9) <= 1e-12
        assert _rel(G(out3), whole3) <= 1e-12


@pytest.mark.parametrize("scheme,tangent,chain", [
    ("staggered", "exact", "g0_staggered_chain_slab"),
    ("collocated", "exact", "gamma_collocated_chain_slab"),
    ("staggered", "frozen_iso", "g0_staggered_chain_slab")])
def test_cuda_sharded_hyper_solve_matches_cpu(cuda, scheme, tangent, chain):
    """A float64 Newton-Krylov solve (two-phase SVK sphere, 2 % stretch) on
    four slabs of one card against the same solve on four CPU slabs: the
    same outer and inner iterations, histories within 1e-9 (1e-14 absolute
    on the epsilon entries), mean PK1 within 1e-10; the card's run
    launches its slab chain and no other kernel."""
    n = 24
    a = ((np.arange(n) + 0.5) / n - 0.5) ** 2
    phi = ((a[:, None, None] + a[None, :, None] + a[None, None, :])
           < 0.09).astype(np.float64)
    res = {}
    for dev in ("cpu", "cuda:0"):
        mat = ft.convert.material_from_numpy(
            [("fiber", 10.0, 5.0, phi), ("matrix", 1.0, 1.0, 1.0 - phi)],
            dim=9, law="svk", device=dev)
        s = ft.LSSolver(Grid(n, n, n), mat, ft.SolverOptions(
            mode="hyperelasticity", gamma_scheme=scheme, tol=1e-6,
            newton_tangent=tangent, error_estimator="residual",
            outer_error_estimator="epsilon", check_every=4),
            sharding=parallel.field_sharding(parallel.make_mesh([dev] * 4)))
        s.set_strain([1.02, 1, 1, 0, 0, 0, 0, 0, 0])
        before = dict(stencil_kernels.launches, **spectral_kernels.launches)
        assert not s.run()
        after = dict(stencil_kernels.launches, **spectral_kernels.launches)
        assert len(s.eps) == 4
        res[dev] = (np.asarray(s.residuals), s.calc_mean_stress(),
                    list(s.newton_iterations), set(_launched(before, after)))
    (rc, Sc, nc, kc), (rg, Sg, ng, kg) = res["cpu"], res["cuda:0"]
    assert kc == set() and kg == {chain}
    assert ng == nc and len(rg) == len(rc)
    np.testing.assert_allclose(rg, rc, rtol=1e-9, atol=1e-14)
    np.testing.assert_allclose(Sg, Sc, rtol=0,
                               atol=1e-10 * np.max(np.abs(Sc)))


# the load-case paths: mode -> (dim, law, (fibre, matrix) moduli); each path
# launches the kernels of its trivial-BC solve and no other
LOAD_CASE_MATERIALS = {
    "elasticity": (6, "isotropic", ((10.0, 5.0), (1.0, 1.0))),
    "heat": (3, "scalar", ((10.0,), (1.0,))),
    "viscosity": (6, "scalar", ((0.1,), (1.0,))),
}
LOAD_CASE_KERNELS = {
    ("elasticity", "staggered"): {"stress_div_beta", "eps_from_u_dot",
                                  "g0_staggered_chain"},
    ("heat", "staggered"): {"g0_staggered_heat_chain"},
    ("viscosity", "staggered"): {"stress_div_beta", "eps_from_u_dot",
                                 "g0_staggered_chain"},
    ("elasticity", "collocated"): {"gamma_collocated_chain"},
    ("heat", "collocated"): {"gamma_collocated_chain"},
    ("viscosity", "collocated"): {"gamma_collocated_zt_chain"},
}


def _load_case_solver(dev, mode, scheme, n=24, **opt):
    a = ((np.arange(n) + 0.5) / n - 0.5) ** 2
    phi = ((a[:, None, None] + a[None, :, None] + a[None, None, :])
           < 0.09).astype(np.float64)
    dim, law, mods = LOAD_CASE_MATERIALS[mode]
    mat = ft.convert.material_from_numpy(
        [("fiber", *mods[0], phi), ("matrix", *mods[1], 1.0 - phi)],
        dim=dim, law=law, device=dev)
    return ft.LSSolver(Grid(n, n, n), mat, ft.SolverOptions(
        mode=mode, gamma_scheme=scheme, tol=1e-8, error_estimator="residual",
        check_every=4, **opt), device=dev)


@pytest.mark.parametrize("mode,scheme", sorted(LOAD_CASE_KERNELS))
def test_cuda_run_batched_matches_cpu(cuda, mode, scheme):
    """run_batched in float64 on the card against the CPU: the same
    iterations, histories within 1e-9, mean stresses within 1e-10; the
    card's run launches its path's kernels and no other."""
    Es = np.eye(LOAD_CASE_MATERIALS[mode][0])
    if mode == "viscosity":
        Es = Es[3:]                     # the traceless shear cases
    res = {}
    for dev in ("cpu", "cuda"):
        s = _load_case_solver(dev, mode, scheme)
        before = dict(stencil_kernels.launches, **spectral_kernels.launches)
        assert not s.run_batched(Es)
        after = dict(stencil_kernels.launches, **spectral_kernels.launches)
        res[dev] = (np.asarray(s.residuals), s.calc_mean_stress_batched(),
                    set(_launched(before, after)))
    (rc, Sc, kc), (rg, Sg, kg) = res["cpu"], res["cuda"]
    assert kc == set() and kg == LOAD_CASE_KERNELS[(mode, scheme)]
    assert len(rg) == len(rc)
    np.testing.assert_allclose(rg, rc, rtol=1e-9)
    np.testing.assert_allclose(Sg, Sc, rtol=0,
                               atol=1e-10 * np.max(np.abs(Sc)))


@pytest.mark.parametrize("scheme", ["staggered", "collocated"])
def test_cuda_mixed_bc_solve_matches_cpu(cuda, scheme):
    """Uniaxial stress (P = e_xx e_xx, S = 0, E = 0.01 e_xx) in float64 on
    the card against the CPU: the same iterations, histories within 1e-9,
    mean stress within 1e-10, the boundary condition met."""
    P = np.zeros((6, 6))
    P[0, 0] = 1.0
    res = {}
    for dev in ("cpu", "cuda"):
        s = _load_case_solver(dev, "elasticity", scheme)
        s.set_bc_projector(P)
        s.set_strain([0.01, 0, 0, 0, 0, 0])
        s.set_stress(np.zeros(6))
        assert not s.run()
        assert s.bc_error() <= s.opt.bc_tol
        res[dev] = (np.asarray(s.residuals), s.calc_mean_stress())
    (rc, Sc), (rg, Sg) = res["cpu"], res["cuda"]
    assert len(rg) == len(rc)
    np.testing.assert_allclose(rg, rc, rtol=1e-9)
    np.testing.assert_allclose(Sg, Sc, rtol=0,
                               atol=1e-10 * np.max(np.abs(Sc)))


def test_cuda_mixed_bc_staggered_step_launches_k1_k3_k2(cuda):
    """A mixed-BC staggered elasticity solve runs K1, the K3 chain and K2
    (the mean correction is K2's E), once each at CG init and per step."""
    s = _load_case_solver("cuda", "elasticity", "staggered", n=16)
    P = np.zeros((6, 6))
    P[0, 0] = 1.0
    s.set_bc_projector(P)
    s.set_strain([0.01, 0, 0, 0, 0, 0])
    before = dict(stencil_kernels.launches, **spectral_kernels.launches)
    assert not s.run()
    moved = _launched(before, dict(stencil_kernels.launches,
                                   **spectral_kernels.launches))
    steps = -(-len(s.residuals) // 4) * 4
    assert moved == {"stress_div_beta": steps + 1,
                     "eps_from_u_dot": steps + 1,
                     "g0_staggered_chain": steps + 1}


# general linear materials: a tiso fibre (the tiso demo's, about e_x or a
# per-voxel orientation field), a general 6x6 fibre, the bench's iso phases
# under Reuss, an anisotropic conductor; each in the bench's sphere
TISO = dict(E=3860.0, nu=0.2, E_a=5390.0, G_a=390.0, nu_a=0.031)
GENERAL_CASES = {
    # case -> (mode, scheme, rule, kernels launched)
    "tiso": ("elasticity", "staggered", "voigt", {"g0_staggered_chain"}),
    "tiso-field": ("elasticity", "staggered", "voigt",
                   {"g0_staggered_chain"}),
    "general": ("elasticity", "collocated", "voigt",
                {"gamma_collocated_chain"}),
    "reuss": ("elasticity", "staggered", "reuss",
              {"stress_div_beta", "eps_from_u_dot", "g0_staggered_chain"}),
    "maximum": ("elasticity", "staggered", "maximum",
                {"g0_staggered_chain"}),
    "aniso": ("heat", "staggered", "voigt", {"g0_staggered_heat_chain"}),
    "aniso-collocated": ("heat", "collocated", "voigt",
                         {"gamma_collocated_chain"}),
}


def _general_solver(dev, case, n=24):
    a = ((np.arange(n) + 0.5) / n - 0.5) ** 2
    phi = ((a[:, None, None] + a[None, :, None] + a[None, None, :])
           < 0.09).astype(np.float64)
    mode, scheme, rule, _ = GENERAL_CASES[case]
    rng = np.random.default_rng(0)
    if case.startswith("aniso"):
        c = np.cos(np.pi / 6)
        R = np.array([[c, -0.5, 0], [0.5, c, 0], [0, 0, 1.0]])
        fibre, matrix = ("aniso", R @ np.diag([10.0, 5.0, 2.0]) @ R.T), \
            ("scalar", 1.0)
    elif case == "reuss":
        fibre, matrix = ("isotropic", 10.0, 5.0), ("isotropic", 1.0, 1.0)
    else:
        A = rng.standard_normal((6, 6))
        o = rng.standard_normal((3, n, n, n))
        fibre = {"general": ("general", 100.0 * (A @ A.T + 6 * np.eye(6))),
                 "tiso-field": ("tiso", TISO,
                                o / np.linalg.norm(o, axis=0))}.get(
            case, ("tiso", TISO, [1.0, 0.0, 0.0]))
        matrix = ("isotropic", 350.0, 525.0)
    mat = ft.convert.material_from_numpy(
        [("fiber", fibre, phi), ("matrix", matrix, 1.0 - phi)],
        dim=6 if mode == "elasticity" else 3, device=dev, rule=rule)
    s = ft.LSSolver(Grid(n, n, n), mat, ft.SolverOptions(
        mode=mode, gamma_scheme=scheme, tol=1e-8, error_estimator="residual",
        check_every=4), device=dev)
    s.set_strain([1.0, 0, 0, 0, 0, 0][:s.dim])
    return s


@pytest.mark.parametrize("case", sorted(GENERAL_CASES))
def test_cuda_general_material_solve_matches_cpu(cuda, case):
    """A general linear material in float64 on the card against the CPU:
    the same iterations, histories within 1e-9, mean stress within 1e-10;
    the generic staggered route launches K3 and neither K1 nor K2, Reuss
    K1, K2 and K3, the heat paths K4 or K5 only."""
    res = {}
    for dev in ("cpu", "cuda"):
        s = _general_solver(dev, case)
        before = dict(stencil_kernels.launches, **spectral_kernels.launches)
        assert not s.run()
        after = dict(stencil_kernels.launches, **spectral_kernels.launches)
        res[dev] = (np.asarray(s.residuals), s.calc_mean_stress(),
                    set(_launched(before, after)))
    (rc, Sc, kc), (rg, Sg, kg) = res["cpu"], res["cuda"]
    assert kc == set() and kg == GENERAL_CASES[case][3]
    assert len(rg) == len(rc)
    np.testing.assert_allclose(rg, rc, rtol=1e-9)
    np.testing.assert_allclose(Sg, Sc, rtol=0,
                               atol=1e-10 * np.max(np.abs(Sc)))


# interface laminates, the doubly-fine grid and the generic staggered Delta
# path: the bench's phases on a sphere with smooth (supersampled) phi
SLICE_I_CASES = {
    # case -> (mode, scheme, rule, doubly-fine, kernels launched)
    "elasticity-full-staggered": ("elasticity", "full_staggered", "voigt",
                                  True, {"g0_staggered_chain"}),
    "elasticity-laminate": ("elasticity", "staggered", "laminate", False,
                            {"g0_staggered_chain"}),
    "elasticity-laminate-collocated": ("elasticity", "collocated",
                                       "laminate", False,
                                       {"gamma_collocated_chain"}),
    "viscosity-generic": ("viscosity", "staggered", "maximum", False,
                          {"g0_staggered_chain"}),
    "viscosity-lambda": ("viscosity", "staggered", "voigt", False,
                         {"g0_staggered_chain"}),
}


def _smooth_sphere(n, r=0.3, ss=4):
    """Partial-volume phi of a centred sphere (ss^3 points a voxel) and its
    outward normal field, as numpy."""
    t = (np.arange(n * ss) + 0.5) / (n * ss) - 0.5
    inside = (t[:, None, None] ** 2 + t[None, :, None] ** 2
              + t[None, None, :] ** 2) < r * r
    phi = inside.reshape(n, ss, n, ss, n, ss).mean(axis=(1, 3, 5))
    c = (np.arange(n) + 0.5) / n - 0.5
    X = np.stack(np.meshgrid(c, c, c, indexing="ij"))
    return phi, X / np.linalg.norm(X, axis=0)


def _slice_i_solver(dev, case, n=24):
    mode, scheme, rule, fine, _ = SLICE_I_CASES[case]
    phi, normals = _smooth_sphere(2 * n if fine else n)
    if mode == "elasticity":
        phases = [("fiber", ("isotropic", 10.0, 5.0), phi),
                  ("matrix", ("isotropic", 1.0, 1.0), 1.0 - phi)]
        load = [1.0, 0, 0, 0, 0, 0]
    elif case == "viscosity-lambda":
        phases = [("fiber", ("isotropic", 0.05, 0.01), phi),
                  ("matrix", ("isotropic", 0.5, 0.02), 1.0 - phi)]
        load = [0, 0, 0, 0, 1.0, 0]
    else:
        phases = [("fiber", ("scalar", 0.1), phi),
                  ("matrix", ("scalar", 1.0), 1.0 - phi)]
        load = [0, 0, 0, 0, 1.0, 0]
    mat = ft.convert.material_from_numpy(
        phases, device=dev, rule=rule,
        normals=normals if rule == "laminate" else None)
    if fine:
        mat = ft.DfgMaterial(mat)
    s = ft.LSSolver(Grid(n, n, n), mat, ft.SolverOptions(
        mode=mode, gamma_scheme=scheme, tol=1e-8, error_estimator="residual",
        check_every=4), device=dev)
    s.set_strain(load)
    return s


@pytest.mark.parametrize("case", sorted(SLICE_I_CASES))
def test_cuda_interface_and_dfg_solve_matches_cpu(cuda, case):
    """The doubly-fine grid, the laminate on both grids and staggered
    viscosity off the fused route, in float64 on the card against the CPU:
    the same iterations, histories within 1e-9, mean stress within 1e-10;
    each launches its chain and neither K1 nor K2."""
    res = {}
    for dev in ("cpu", "cuda"):
        s = _slice_i_solver(dev, case)
        before = dict(stencil_kernels.launches, **spectral_kernels.launches)
        assert not s.run()
        after = dict(stencil_kernels.launches, **spectral_kernels.launches)
        res[dev] = (np.asarray(s.residuals), s.calc_mean_stress(),
                    set(_launched(before, after)))
    (rc, Sc, kc), (rg, Sg, kg) = res["cpu"], res["cuda"]
    assert kc == set() and kg == SLICE_I_CASES[case][4]
    assert len(rg) == len(rc)
    np.testing.assert_allclose(rg, rc, rtol=1e-9)
    np.testing.assert_allclose(Sg, Sc, rtol=0,
                               atol=1e-10 * np.max(np.abs(Sc)))


# the XML front end: demo projects through ft.FG at test sizes, float64;
# name -> (project, settings, the kernels its solve launches)
FG_DEMOS = {
    "hashin": ("elasticity/hashin", {"variables.res..value": 24},
               {"stress_div_beta", "eps_from_u_dot", "g0_staggered_chain"}),
    "transverse_isotropy": ("elasticity/transverse_isotropy",
                            {"variables.res..value": 16},
                            {"g0_staggered_chain"}),
    "heat": ("heat/heat", {"variables.res..value": 32, "n": 10},
             {"g0_staggered_heat_chain"}),
    "nunan_keller": ("viscosity/nunan_keller",
                     {"solver..n": 16, "solver.tol": 1e-4},
                     {"g0_staggered_chain"}),
}


@pytest.mark.parametrize("name", sorted(FG_DEMOS))
def test_cuda_fg_demo_matches_cpu(cuda, name):
    """A demo project through FG on the card against the CPU in float64:
    phi and the geometry fields within 1e-12, the same iterations, the
    mean stress (or the effective property) within 1e-10; the card's run
    launches its path's kernels and no other."""
    import os
    path, settings, kernels = FG_DEMOS[name]
    xml = os.path.join(os.path.dirname(__file__), "..", "demo", path,
                       "project.xml")
    res = {}
    for dev in ("cpu", "cuda"):
        f = ft.FG(xml, device=dev)
        for k, v in settings.items():
            f.set(k, v)
        before = dict(stencil_kernels.launches, **spectral_kernels.launches)
        assert f.run() == 0
        after = dict(stencil_kernels.launches, **spectral_kernels.launches)
        C = f.get_effective_property()
        res[dev] = (f.get_field("phi"), len(f.get_residuals()),
                    np.asarray(f.get_mean_stress() if C is None else C),
                    set(_launched(before, after)),
                    None if f._gfields_cache is None
                    else f.get_field("normals"))
    (pc, ic, Sc, kc, nc), (pg, ig, Sg, kg, ng) = res["cpu"], res["cuda"]
    assert kc == set() and kg == kernels
    np.testing.assert_allclose(pg, pc, rtol=0, atol=1e-12)
    if nc is not None:
        np.testing.assert_allclose(ng, nc, rtol=0, atol=1e-12)
    assert ig == ic
    np.testing.assert_allclose(Sg, Sc, rtol=0,
                               atol=1e-10 * np.max(np.abs(Sc)))


def test_cuda_voxelization_matches_cpu(cuda):
    """phi_field (supersample 2, in x-slabs and fibre groups too) and
    geometry_fields of random capsules, cylinders and a half space on an
    odd grid: the card against the CPU within 1e-12 in float64; float32
    within 8 float32 epsilons over the supersampled voxel edge."""
    from fibergen_tpu_torch.geometry import discretize, primitives
    r = np.random.default_rng(3)
    fibres = []
    for i in range(9):
        a = r.standard_normal(3)
        cls = primitives.Cylinder if i % 3 == 0 else primitives.Capsule
        f = cls(center=r.uniform(0, 1, 3), axis=a / np.linalg.norm(a),
                length=float(r.uniform(0, 0.5)),
                radius=float(r.uniform(0.05, 0.2)))
        f.material, f.fiber_id = 1, i + 1
        fibres.append(f)
    h = primitives.HalfSpace(point=np.array([0.3, 0.5, 0.5]),
                             normal=np.array([-1.0, 0.2, 0.1]))
    h.material, h.fiber_id = 1, 10
    fibres.append(h)
    g = Grid(33, 17, 29, 1.0, 1.2, 0.9)
    ref = discretize.phi_field(g, fibres, 2, torch.float64, "cpu")
    old = discretize.PHI_SLAB_VOXELS
    for budget in (old, 5000):
        discretize.PHI_SLAB_VOXELS = budget
        try:
            got = discretize.phi_field(g, fibres, 2, torch.float64, "cuda")
        finally:
            discretize.PHI_SLAB_VOXELS = old
        assert float((got.cpu() - ref).abs().max()) <= 1e-12
    p32 = discretize.phi_field(g, fibres, 2, torch.float32, "cuda")
    lim = 8 * float(np.finfo(np.float32).eps) * 2 * max(g.nx, g.ny, g.nz)
    assert float((p32.double().cpu() - ref).abs().max()) <= lim
    gc = discretize.geometry_fields(g, fibres, torch.float64, "cpu")
    gg = discretize.geometry_fields(g, fibres, torch.float64, "cuda")
    for k in gc:
        np.testing.assert_allclose(gg[k].cpu().numpy(), gc[k].numpy(),
                                   rtol=0, atol=1e-12, err_msg=k)
