"""Every material and mixing rule on the x-slabs, against the JAX
package's sharded solver and against the port's unsharded one, on the CPU.

The materials off the Voigt rule, and the laws that read a field, run on
per-slab views of the material (materials/sharded.py); the doubly-fine
grid prolongs and restricts on fine x-slabs with one halo plane.  Each
case: the port's solve on four CPU slabs against the JAX package's
sharded ``LSSolver`` on four forced host devices (``use_pallas="off"``),
float64, at the limits of test_torch_parallel.test_sharded_solve_matches_
jax (the same iterations, histories within 1e-9, the field within 1e-9,
the mean stress within 1e-10); then against the port's unsharded solve at
D = 1, 2, 4.  The rules that treat interface voxels apart run on the
partial volume of the sphere (with its radial normals for the interface
rules).  The hyperelastic rules and mixed BCs under Newton are in
test_torch_parallel_newton.py.
"""
import numpy as np
import pytest

import torch

import _torch_slab_cases as cases
from fibergen_tpu.utils.logging import LOG as JLOG
from fibergen_tpu_torch import parallel
from fibergen_tpu_torch.materials import dfg, mixing
from fibergen_tpu_torch.materials.sharded import SlabMaterial, for_slabs
from fibergen_tpu_torch.utils.logging import LOG


@pytest.fixture(autouse=True)
def _quiet():
    old = (JLOG.enabled, LOG.enabled)
    JLOG.enabled = LOG.enabled = False
    yield
    JLOG.enabled, LOG.enabled = old


# id -> (material, mode, shape, options, bc)
_CG = dict(error_estimator="residual", tol=1e-8)
MATERIALS = {
    "tiso": ("tiso", "elasticity", (16, 8, 9), _CG, None),
    "tiso-field": ("tiso-field", "elasticity", (16, 8, 7), _CG, None),
    "general-collocated": ("general", "elasticity", (16, 8, 9),
                           dict(_CG, gamma_scheme="collocated"), None),
    "aniso-heat": ("aniso", "heat", (16, 8, 9), _CG, None),
    "reuss": ("reuss", "elasticity", (16, 8, 9), _CG, None),
    "maximum": ("maximum", "elasticity", (16, 8, 7), _CG, None),
    "random": ("random", "elasticity", (16, 8, 9), _CG, None),
    "fiftyfifty": ("fiftyfifty", "elasticity", (16, 8, 9), _CG, None),
    "split": ("split", "elasticity", (16, 8, 9), _CG, None),
    "iso-rule": ("iso-rule", "elasticity", (16, 8, 7), _CG, None),
    "laminate": ("laminate", "elasticity", (16, 8, 9), _CG, None),
    "infinity-laminate": ("infinity_laminate", "elasticity", (16, 8, 7),
                          _CG, None),
    "fluidity": ("fluidity", "viscosity", (16, 8, 9), _CG, None),
    "viscosity-maximum": ("visc-maximum", "viscosity", (16, 8, 9), _CG,
                          None),
    "full-staggered": ("iso", "elasticity", (8, 8, 7),
                       dict(_CG, gamma_scheme="full_staggered"), None),
    "half-staggered-viscosity": ("visc", "viscosity", (8, 4, 5),
                                 dict(_CG, gamma_scheme="half_staggered"),
                                 None),
}


def _fine(opt):
    return opt.get("gamma_scheme") in ("half_staggered", "full_staggered")


@pytest.mark.parametrize("case", MATERIALS)
def test_sharded_material_matches_jax(case):
    name, mode, shape, opt, bc = MATERIALS[case]
    js = cases.jax_solver(name, shape, mode, bc, _fine(opt), **opt)
    ps = cases.port_solver(name, shape, mode, 4, bc, _fine(opt), **opt)
    assert ps.par is not None
    assert not js.run() and not ps.run()
    cases.same_solve(js, ps)
    if bc is not None:
        assert ps.bc_error() <= ps.opt.bc_tol


@pytest.mark.parametrize("d", [1, 2, 4])
@pytest.mark.parametrize("case", MATERIALS)
def test_sharded_material_matches_unsharded(case, d):
    name, mode, shape, opt, bc = MATERIALS[case]
    s0 = cases.port_solver(name, shape, mode, None, bc, _fine(opt), **opt)
    s1 = cases.port_solver(name, shape, mode, d, bc, _fine(opt), **opt)
    assert not s0.run() and not s1.run()
    cases.same_as_unsharded(s0, s1)


# ------------------------------------------------------- the pieces
def test_slab_material_layouts():
    """The Voigt rule over field-free laws takes slabs itself; any other
    rule and a law with an orientation field go through slab views; a
    doubly-fine material keeps its kind around its inner material so laid
    out."""
    shape = (8, 4, 5)
    for name, kind in (("iso", mixing.VoigtMixed), ("tiso-field",
                                                    SlabMaterial),
                       ("maximum", SlabMaterial), ("laminate", SlabMaterial)):
        _, pmat = cases.materials(name, shape)
        assert isinstance(for_slabs(pmat), kind), name
    _, pmat = cases.materials("maximum", shape, fine=True)
    m = for_slabs(pmat)
    assert isinstance(m, dfg.DfgMaterial) and isinstance(m.inner,
                                                         SlabMaterial)
    assert m.phases is pmat.phases


@pytest.mark.parametrize("name", ["random", "tiso-field", "laminate",
                                  "split", "iso-rule", "fluidity"])
def test_slab_views_respond_as_the_whole_material(name):
    """pk1, the tangent and the energy of the slab views, gathered, equal
    the whole material's (the Random rule's voxel hash keeps its global
    index; the views share no cache with the material)."""
    shape = (8, 4, 5)
    _, pmat = cases.materials(name, shape)
    dim = pmat.dim
    rng = np.random.default_rng(3)
    F = torch.as_tensor(rng.standard_normal((dim,) + shape))
    W = torch.as_tensor(rng.standard_normal((dim,) + shape))
    sm = SlabMaterial(pmat)
    mesh = parallel.make_mesh(["cpu"] * 4)
    Fs, Ws = parallel.shard_field(F, mesh), parallel.shard_field(W, mesh)
    G = parallel.gather_field
    for got, ref in ((G(sm.pk1(Fs)), pmat.pk1(F)),
                     (G(sm.dpk1(Fs, Ws)), pmat.dpk1(F, W)),
                     (G(sm.w(Fs)), pmat.w(F)),
                     (G(sm.stress_diff(Fs, 0.7, 0.2)),
                      pmat.stress_diff(F, 0.7, 0.2))):
        assert torch.allclose(got, ref, rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(sm.mean_pk1(Fs)[0].numpy(),
                               pmat.mean_pk1(F).numpy(), rtol=1e-13,
                               atol=1e-15)
    assert sm.views(Fs) is sm.views(Fs)


def test_slab_views_follow_the_material_state():
    """New phase or orientation fields rebuild the views; the same ones
    keep them."""
    _, pmat = cases.materials("tiso-field", (8, 4, 5))
    sm = SlabMaterial(pmat)
    Fs = parallel.shard_field(torch.zeros((6, 8, 4, 5), dtype=torch.float64),
                              parallel.make_mesh(["cpu"] * 2))
    v = sm.views(Fs)
    assert sm.views(Fs) is v
    law = pmat.phases[0].law
    law.orientation = law.orientation.clone()
    v2 = sm.views(Fs)
    assert v2 is not v
    pmat.phases[1].phi = pmat.phases[1].phi.clone()
    assert sm.views(Fs) is not v2
