"""The port's multigrid G0 on the x-slabs of a CPU mesh (D = 1, 2, 4)
against its unsharded multigrid, in float64 on the CPU.

``poisson_multigrid`` and ``g0_multigrid_staggered`` take slabs: with
``"direct"`` (V-cycles) they give the unsharded result within 1e-13 of its
largest value (only the means are added otherwise: slab by slab), with
``"pcg"`` within 1e-12, with ``"fft"`` (gathered) exactly.  The grids split
their levels differently: every level but the coarsest, the first level
gathered before the coarsest (nx / D odd below), or none.  A solve with
``g0_solver="multigrid"`` on slabs walks the unsharded one, and the FFT G0
on slabs ends within the multigrid's tolerance of it.  The JAX package's
multigrid compiles for minutes on even grids, so it takes part through
the unsharded port's parity (tests/test_torch_multigrid.py).
"""
import numpy as np
import pytest
import torch

import fibergen_tpu_torch as ft
from fibergen_tpu_torch import parallel
from fibergen_tpu_torch.ops import spectral_kernels
from fibergen_tpu_torch.solvers import multigrid as mg
from fibergen_tpu_torch.utils.logging import LOG

torch.set_num_threads(2)

# (shape, cell): 32 x 16 x 16 splits levels 32 and 16 on D = 2 and 4 and
# gathers 8; 24 x 16 x 16 on D = 4 gathers from 12 (12 / 4 odd); 12 x 8 x
# 8 on D = 4 splits nothing (12 / 4 odd)
GRIDS = [((32, 16, 16), (1.0, 1.0, 1.0)), ((24, 16, 16), (1.3, 0.9, 1.1)),
         ((12, 8, 8), (1.0, 1.2, 0.8))]
TOL = {"direct": 1e-13, "pcg": 1e-12, "fft": 0.0}


@pytest.fixture(autouse=True)
def _quiet():
    old = LOG.enabled
    LOG.enabled = False
    yield
    LOG.enabled = old


def _mesh(d):
    return parallel.make_mesh(["cpu"] * d)


def _rand(shape, seed=3):
    return torch.as_tensor(np.random.default_rng(seed).standard_normal(shape))


def test_levels_split_while_the_slabs_halve():
    """The split levels of each grid and mesh: a level stays split while
    nx_l % D == 0 and nx_l / D is even; the coarsest never."""
    def n_split(shape, d):
        return mg._SlabHierarchy(ft.Grid(*shape), mg.MGOptions(),
                                 [torch.device("cpu")] * d).n_split
    assert [n_split((32, 16, 16), d) for d in (1, 2, 4)] == [2, 2, 2]
    assert [n_split((24, 16, 16), d) for d in (1, 2, 4)] == [2, 2, 1]
    assert [n_split((12, 8, 8), d) for d in (1, 2, 4)] == [1, 1, 0]
    assert n_split((32, 32, 32), 4) == 3       # 32 -> 16 -> 8 -> 4 gathered


@pytest.mark.parametrize("scheme", ["direct", "pcg", "fft"])
@pytest.mark.parametrize("d", [1, 2, 4])
@pytest.mark.parametrize("shape,cell", GRIDS)
def test_poisson_on_slabs_matches_unsharded(shape, cell, d, scheme):
    grid = ft.Grid(*shape, *cell)
    b = _rand(shape)
    opt = mg.MGOptions(scheme=scheme)
    ref = mg.poisson_multigrid(grid, b, opt)
    out = mg.poisson_multigrid(grid, parallel.shard_field(b, _mesh(d)), opt)
    assert isinstance(out, list) and len(out) == d
    got = parallel.gather_field(out)
    assert float((got - ref).abs().max()) <= TOL[scheme] * float(
        ref.abs().max())


@pytest.mark.parametrize("scheme", ["direct", "pcg"])
@pytest.mark.parametrize("d", [1, 2, 4])
def test_g0_multigrid_on_slabs_matches_unsharded(d, scheme):
    """The staggered G0 by Poisson solves on slabs: the divergence and the
    pressure gradient along x take the neighbours' halo planes."""
    shape, cell = GRIDS[1]
    grid = ft.Grid(*shape, *cell)
    f = _rand((3,) + shape, seed=4)
    opt = mg.MGOptions(scheme=scheme)
    ref = mg.g0_multigrid_staggered(grid, 1.3, 0.4, f, -1.0, opt)
    out = mg.g0_multigrid_staggered(
        grid, 1.3, 0.4, parallel.shard_field(f, _mesh(d)), -1.0, opt)
    got = parallel.gather_field(out)
    assert got.shape == ref.shape
    assert float((got - ref).abs().max()) <= TOL[scheme] * float(
        ref.abs().max())


def _solver(d, g0_solver="multigrid", shape=(16, 8, 8)):
    phi = np.random.default_rng(1).random(shape)
    mat = ft.convert.material_from_numpy(
        [("a", 1.0, 1.0, phi), ("b", 2.0, 5.0, 1.0 - phi)], device="cpu")
    sharding = None if d is None else parallel.field_sharding(_mesh(d))
    s = ft.LSSolver(ft.Grid(*shape), mat, ft.SolverOptions(
        g0_solver=g0_solver, tol=1e-8, error_estimator="residual"),
        device="cpu", sharding=sharding)
    s.set_strain([1.0, 0, 0, 0, 0.4, 0])
    return s


@pytest.mark.parametrize("d", [1, 2, 4])
def test_multigrid_solve_on_slabs_matches_unsharded(d):
    """g0_solver="multigrid" on d slabs: the unsharded multigrid solve's
    iterations, histories within 1e-10, mean stress within 1e-12 of its
    max, no chain applied; the FFT G0 on slabs (K3's twin) within the
    solve's tolerance of it."""
    ref = _solver(None)
    s = _solver(d)
    assert s.par is not None and s.par.n_devices == d and not s._k1_route
    calls = dict(spectral_kernels.calls)
    assert not ref.run() and not s.run()
    assert spectral_kernels.calls == calls
    assert len(s.residuals) == len(ref.residuals)
    np.testing.assert_allclose(s.residuals, ref.residuals, rtol=1e-10)
    S_ref = ref.calc_mean_stress()
    np.testing.assert_allclose(s.calc_mean_stress(), S_ref, rtol=0,
                               atol=1e-12 * np.abs(S_ref).max())
    fft = _solver(d, "fft")
    assert not fft.run()
    np.testing.assert_allclose(fft.calc_mean_stress(), S_ref, rtol=0,
                               atol=1e-8 * np.abs(S_ref).max())
