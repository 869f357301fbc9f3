"""The demo projects that test_torch_frontend.py leaves out, through the
JAX package's FG and the port's FG(device="cpu") in float64
(tests/_torch_demos.py): transverse_isotropy at 16 (30 generated fibres,
the laminate rule, the tiso law on the orientation field),
viscosity_analytical at 16, Nunan-Keller at n = 16 (full_staggered),
mixed_bc at 8 (Newton under mixed BCs), 2d at 32 (on which the JAX package
runs its 2-D pipeline and the port the 3-D operators) and sfrp_hexagonal
at 16.  Each takes the same iterations, holds its residual history within
1e-8 relative or 1e-14 absolute (Newton under mixed BCs within 1e-6, as
tests/test_torch_hyper_bc.py holds it), its phase and geometry fields
within 1e-12 and its means within 1e-10 relative; then the test_demos.py
oracles on the port, and
the batched Nunan-Keller cases against the sequential ones within the
solve's tolerance.
"""
import numpy as np
import pytest

import torch

import fibergen_tpu_torch as ft
from fibergen_tpu.utils.logging import LOG as JLOG
from fibergen_tpu_torch.utils.logging import LOG

import _torch_demos as demos

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _quiet():
    old = (JLOG.enabled, LOG.enabled)
    JLOG.enabled = LOG.enabled = False
    yield
    JLOG.enabled, LOG.enabled = old


@pytest.mark.parametrize("name", ["transverse_isotropy",
                                  "viscosity_analytical", "nunan_keller",
                                  "mixed_bc", "2d", "sfrp_hexagonal"])
def test_demo_matches_jax(name):
    a, b = demos.check_pair(name, hist_tol=1e-6 if name == "mixed_bc"
                            else 1e-8)
    assert bool(getattr(a.solver, "_dim2_logged", False)) == (
        name in demos.DIM2)


def test_demo_transverse_isotropy_oracle():
    _, f = demos.pair("transverse_isotropy")
    sig = np.array(f.get_mean_stress())
    assert np.all(np.isfinite(sig)) and sig[0] > 0
    assert sig[0] > sig[1] and sig[0] > sig[2]
    assert len(f.gen.fibers) == 30
    orient = f.solver.mat.phases[1].law.orientation
    assert orient is f._gfields_cache[1]["orientation"]
    assert f.solver.mat.normals is f._gfields_cache[1]["normals"]


def test_demo_viscosity_analytical_oracle():
    _, f = demos.pair("viscosity_analytical")
    sig = np.array(f.get_mean_stress())
    assert 0.0 < sig[0] < 0.5 and abs(sig[0] + sig[1]) < 1e-3
    # the project's mu is halved into the law's fluidity
    assert f.solver.mat.phases[1].law.mu == 0.5 * 0.001


def test_demo_nunan_keller_oracle_and_batch():
    _, f = demos.pair("nunan_keller")
    alpha, beta = f._nunan_keller
    assert abs(alpha - 1.0666) / 1.0666 < 0.1
    assert abs(beta - 0.49665) / 0.49665 < 0.1
    assert isinstance(f.solver.mat, ft.DfgMaterial)
    assert f.solver.mat.phases[0].phi.shape == (32, 32, 32)
    g = demos.load(ft.FG, "nunan_keller", sequential=False, device="cpu")
    assert g.run() == 0
    assert g.solver.eps_batch.shape[0] == 5
    assert demos.rel(g._nunan_keller, f._nunan_keller) <= g.solver.opt.tol
    assert demos.rel(g.get_effective_property(),
                     f.get_effective_property()) <= g.solver.opt.tol


def test_demo_mixed_bc_oracle():
    _, f = demos.pair("mixed_bc")
    F = np.array(f.get_mean_strain())
    P = np.array(f.get_mean_stress())
    assert abs(F[1] - 1.1) < 1e-6        # prescribed F22 = 1.1
    assert abs(P[0] - 1.0) < 1e-3        # prescribed P11 = 1.0


def test_demo_2d_and_sfrp_oracles():
    _, f = demos.pair("2d")
    sig = np.array(f.get_mean_stress())
    assert np.all(np.isfinite(sig)) and sig[0] > 0
    assert np.array(f.get_A2())[2, 2] < 1e-9      # planar orientations
    assert f.solver.grid.shape == (32, 32, 1)
    _, f = demos.pair("sfrp_hexagonal")
    sig = np.array(f.get_mean_stress())
    assert np.all(np.isfinite(sig)) and sig[0] > 0
    assert f.get_volume_fraction("fiber") > 0.4
    assert f.solver.grid.shape == (28, 16, 1)
