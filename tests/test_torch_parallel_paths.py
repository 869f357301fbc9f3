"""The linear paths the x-slab solve took on last, against the JAX
package's sharded solver and against the port's unsharded one, on the CPU.

The port's solve on four CPU slabs (``parallel.make_mesh(["cpu"] * 4)``,
the plain twins) against the JAX package's sharded ``LSSolver`` on four
forced host devices (``use_pallas="off"``), float64, at the limits of
test_torch_parallel.test_sharded_solve_matches_jax: the same iterations,
residual histories within 1e-9, the field within 1e-9, the mean stress
within 1e-10 of its max.  The paths: staggered viscosity on the fused
route (K1 tau-sum and K2 Delta mode in halo mode) and on the generic
Delta path, mixed boundary conditions (staggered and collocated
elasticity, staggered heat, staggered viscosity), ``run_batched``,
Willot's Gamma in elasticity and viscosity, and ``freq_hack``; on
(16, 8, 9) (kz = 5 does not split over four slabs) and (16, 8, 7) (kz = 4
does).  The same solves against the port's unsharded one at D = 1, 2, 4,
and the new slab operators against their whole-field forms.  The
materials off the Voigt rule are in test_torch_parallel_materials.py.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

import _torch_slab_cases as cases
from fibergen_tpu.utils.logging import LOG as JLOG
import fibergen_tpu_torch as ft
from fibergen_tpu_torch import parallel
from fibergen_tpu_torch.ops import gamma as gammamod
from fibergen_tpu_torch.ops import green
from fibergen_tpu_torch.solvers import bc as bcmod
from fibergen_tpu_torch.utils.logging import LOG


@pytest.fixture(autouse=True)
def _quiet():
    old = (JLOG.enabled, LOG.enabled)
    JLOG.enabled = LOG.enabled = False
    yield
    JLOG.enabled, LOG.enabled = old


# id -> (material, mode, shape, options, bc)
PATHS = {
    "viscosity-fused": ("visc", "viscosity", (16, 8, 9), {}, None),
    "viscosity-lambda": ("visc-lambda", "viscosity", (16, 8, 7), {}, None),
    "elasticity-mixed": ("iso", "elasticity", (16, 8, 9), {}, "xx"),
    "elasticity-collocated-mixed": ("iso", "elasticity", (16, 8, 7),
                                    dict(gamma_scheme="collocated"), "xx"),
    "heat-mixed": ("heat", "heat", (16, 8, 9), {}, "heat-x"),
    "viscosity-mixed": ("visc", "viscosity", (16, 8, 9), {}, "xz"),
    "elasticity-willot": ("iso", "elasticity", (16, 8, 9),
                          dict(gamma_scheme="willot"), None),
    "viscosity-willot": ("visc", "viscosity", (16, 8, 7),
                         dict(gamma_scheme="willot"), None),
    "elasticity-freq-hack": ("iso", "elasticity", (16, 8, 8),
                             dict(gamma_scheme="collocated", freq_hack=True),
                             None),
}
OPT = dict(error_estimator="residual", tol=1e-8)


@pytest.mark.parametrize("path", PATHS)
def test_sharded_path_matches_jax(path):
    name, mode, shape, opt, bc = PATHS[path]
    js = cases.jax_solver(name, shape, mode, bc, **OPT, **opt)
    ps = cases.port_solver(name, shape, mode, 4, bc, **OPT, **opt)
    assert ps.par is not None and ps.par.n_devices == 4
    if path == "viscosity-fused":
        assert ps._k1_route
    assert not js.run() and not ps.run()
    cases.same_solve(js, ps)
    if bc is not None:
        assert ps.bc_error() <= ps.opt.bc_tol
        assert abs(ps.bc_error() - js.bc_error()) <= 1e-10


@pytest.mark.parametrize("d", [1, 2, 4])
@pytest.mark.parametrize("path", PATHS)
def test_sharded_path_matches_unsharded(path, d):
    """D = 1 is one slab that wraps its own halo."""
    name, mode, shape, opt, bc = PATHS[path]
    s0 = cases.port_solver(name, shape, mode, None, bc, **OPT, **opt)
    s1 = cases.port_solver(name, shape, mode, d, bc, **OPT, **opt)
    assert not s0.run() and not s1.run()
    cases.same_as_unsharded(s0, s1)


def test_run_batched_on_slabs_matches_jax():
    """The six unit strains in one run_batched on four slabs against the
    JAX package's batched solve on its mesh: the same histories, and the
    fields and (6, 6) means against its batched state after as many steps
    (its host loop runs one chunk past convergence)."""
    Es = np.eye(6)
    js = cases.jax_solver("iso", (16, 8, 9), "elasticity", **OPT)
    ps = cases.port_solver("iso", (16, 8, 9), "elasticity", 4, **OPT)
    assert not js.run_batched(Es) and not ps.run_batched(Es)
    rj, rp = np.asarray(js.residuals), np.asarray(ps.residuals)
    assert 1 < len(rp) <= len(rj)
    np.testing.assert_allclose(rp, rj[:len(rp)], rtol=1e-9)
    mf = js.mat.fields()
    eps = js._cg_b_init_chunk_n(len(rp))(
        mf, jnp.asarray(Es, js.dtype), mu0=js.mu_0, lam0=js.lambda_0,
        pallas_mid=True)[0]
    S_ref = np.asarray(js._k_b_means(mf, eps)[1])
    assert isinstance(ps.eps_batch, list) and len(ps.eps_batch) == 4
    eb = np.stack([parallel.gather_field([x[b] for x in ps.eps_batch])
                   .numpy() for b in range(6)])
    assert np.max(np.abs(eb - np.asarray(eps))) <= 1e-9
    np.testing.assert_allclose(ps.calc_mean_stress_batched(), S_ref, rtol=0,
                               atol=1e-10 * np.max(np.abs(S_ref)))


@pytest.mark.parametrize("d", [1, 2, 4])
@pytest.mark.parametrize("mode", ["elasticity", "viscosity"])
def test_run_batched_on_slabs_matches_unsharded(mode, d):
    """run_batched on D slabs against the unsharded batch: the same
    histories, the (B, dim) means within 1e-12, eps the last case."""
    name = "iso" if mode == "elasticity" else "visc"
    Es = np.eye(6) if mode == "elasticity" else np.array(
        [[0, 0, 0, 1.0, 0, 0], [0, 0, 0, 0, 1.0, 0.5]])
    s0 = cases.port_solver(name, (16, 8, 9), mode, None, **OPT)
    s1 = cases.port_solver(name, (16, 8, 9), mode, d, **OPT)
    assert not s0.run_batched(Es) and not s1.run_batched(Es)
    np.testing.assert_allclose(s1.residuals, s0.residuals, rtol=1e-9)
    S0 = s0.calc_mean_stress_batched()
    np.testing.assert_allclose(s1.calc_mean_stress_batched(), S0, rtol=0,
                               atol=1e-12 * np.max(np.abs(S0)))
    assert np.max(np.abs(s1.get_field("epsilon")
                         - s0.eps_batch[-1].numpy())) <= 1e-12


# ------------------------------------------------------------ op level
def _slabs(x, d=4):
    return parallel.shard_field(x, parallel.make_mesh(["cpu"] * d))


def _par(d=4):
    return parallel.SlabPar(parallel.make_mesh(["cpu"] * d))


def _rnd(*shape, seed=5):
    return torch.as_tensor(np.random.default_rng(seed).standard_normal(shape))


G = parallel.gather_field


@pytest.mark.parametrize("step", [False, True])
def test_slab_fused_visc_matches_whole(step):
    """gamma.fused_visc on four slabs (K1 tau-sum and K2 Delta twins in
    halo mode, the tau sum and the dot added in slab order) against the
    whole-field operator, init and step mode: w and p within 1e-13 of
    their max, the dot within 1e-13."""
    shape = (16, 8, 9)
    g = ft.Grid(*shape, dx=1.1, dy=0.9)
    r, pp = _rnd(6, *shape), _rnd(6, *shape, seed=6)
    mu = 0.5 + torch.as_tensor(np.random.default_rng(7).random(shape))
    lam = torch.zeros(shape, dtype=torch.float64)
    E = torch.as_tensor([0.1, -0.2, 0.1, 0.3, 0.0, 0.2],
                        dtype=torch.float64)
    beta = torch.tensor(0.7, dtype=torch.float64) if step else None
    w, p, dot = gammamod.fused_visc(g, r, pp if step else None, beta, E, mu,
                                    lam, 0.6, 0.0)
    par = _par()
    ws, ps_, dots = gammamod.fused_visc(
        g, _slabs(r), _slabs(pp) if step else None,
        [beta] * 4 if step else None, [E] * 4, _slabs(mu), _slabs(lam), 0.6,
        0.0, par=par)
    assert torch.allclose(G(ws), w, rtol=0, atol=1e-13 * float(w.abs().max()))
    if step:
        assert torch.allclose(G(ps_), p, rtol=0, atol=1e-13)
        assert abs(float(dots[0]) - float(dot)) <= 1e-13 * abs(float(dot))
        assert all(float(x) == float(dots[0]) for x in dots)
    else:
        assert ps_ is None and p is None


@pytest.mark.parametrize("with_bc", [False, True])
def test_slab_delta_staggered_matches_whole(with_bc):
    """The generic staggered Delta operator on four slabs (the halo
    stencils around the kz-slab K3 twin, the mean of tau over the slabs)
    against the whole-field one, with and without a mixed-BC
    correction."""
    shape = (16, 8, 7)
    g = ft.Grid(*shape)
    tau = _rnd(6, *shape)
    E = torch.as_tensor([0.0, 0.1, -0.1, 0.0, 0.3, 0.0],
                        dtype=torch.float64)
    bc = None
    if with_bc:
        Pm, _ = cases.BCS["xz"]
        bc = bcmod.make_bc_projector(Pm, 0.8, 0.0)
    whole = gammamod.delta_staggered(g, E, 0.8, tau, bc=bc)
    sl = gammamod.delta_staggered(g, [E] * 4, 0.8, _slabs(tau), bc=bc,
                                  par=_par())
    assert torch.allclose(G(sl), whole, rtol=0,
                          atol=1e-13 * float(whole.abs().max()))


@pytest.mark.parametrize("shape", [(16, 8, 9), (8, 4, 4)])
@pytest.mark.parametrize("op", ["willot", "delta-willot", "freq-hack"])
def test_slab_transformed_applies_match_whole(op, shape):
    """Willot's Gamma (its table built on each kz-slab from the slab's own
    wavenumbers), the viscosity Delta operator with it, and the
    freq_hack Gamma (the Nyquist planes on the slab holding them) on four
    slabs through the plain slab transforms, against the whole-field
    applies (kz = 3 over four slabs: one slab holds no column)."""
    g = ft.Grid(*shape, dx=1.2, dz=0.9)
    tau = _rnd(6, *shape)
    E = torch.as_tensor([0.2, 0.0, -0.1, 0.05, 0.0, 0.1],
                        dtype=torch.float64)
    par = _par()
    if op == "willot":
        whole = gammamod.gamma_willot(g, E, 0.7, 0.4, tau, -1.0, 0.3)
        sl = gammamod.gamma_willot(g, [E] * 4, 0.7, 0.4, _slabs(tau), -1.0,
                                   0.3, par=par)
    elif op == "delta-willot":
        whole = gammamod.delta_willot(g, E, 0.7, tau)
        sl = gammamod.delta_willot(g, [E] * 4, 0.7, _slabs(tau), par=par)
    else:
        whole = green.gamma_collocated_fused(g, E, 0.7, 0.4, tau, -1.0, 0.3,
                                             freq_hack=True)
        sl = green.gamma_collocated_fused(g, [E] * 4, 0.7, 0.4, _slabs(tau),
                                          -1.0, 0.3, freq_hack=True, par=par)
    assert torch.allclose(G(sl), whole, rtol=0,
                          atol=1e-13 * float(whole.abs().max()))


# ------------------------------------------------------------ refusals
def test_still_refused_on_slabs_name_the_roadmap():
    """Nothing of the JAX package stays refused on a mesh: the multigrid G0
    takes the slab path and sharding_fallback="warn" the whole solve on
    the mesh's first device; under "error" a grid the slabs cannot split
    raises with the JAX package's reason."""
    phi = np.full((16, 8, 8), 0.5)
    mat = ft.convert.material_from_numpy(
        [("a", 1.0, 1.0, phi), ("b", 5.0, 2.0, 1.0 - phi)], device="cpu")
    sh = cases.port_sharding(4)
    s = ft.LSSolver(ft.Grid(16, 8, 8), mat, ft.SolverOptions(
        g0_solver="multigrid"), sharding=sh)
    assert s.par is not None and s.par.n_devices == 4
    odd = ft.convert.material_from_numpy(
        [("a", 1.0, 1.0, np.full((18, 8, 8), 0.5))], device="cpu")
    s = ft.LSSolver(ft.Grid(18, 8, 8), odd, ft.SolverOptions(
        sharding_fallback="warn"), sharding=sh)
    assert s.par is None and s.device.type == "cpu"
    with pytest.raises(RuntimeError, match="nx=18 not divisible"):
        ft.LSSolver(ft.Grid(18, 8, 8), odd, ft.SolverOptions(), sharding=sh)
    # unsharded, multigrid constructs
    ft.LSSolver(ft.Grid(16, 8, 8), mat, ft.SolverOptions(
        g0_solver="multigrid"), device="cpu")
