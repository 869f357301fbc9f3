"""The mesh demo projects through the JAX package's FG and the port's
FG(device="cpu") in float64: geometry/normals (one tetrahedron and its
write_vtk), geometry/stl at n = 16 (its n = 32 halved: 2112 triangles on
the 32^3 supersampled grid; a heat load case), geometry/tetmesh at its
48 x 48 x 4 (576 tetrahedra of a Dolfin mesh, the laminate rule on their
normals, an elastic load case) and geometry/primitives at 16 with its
write_vtk.  Each takes the same iterations, holds its residual history
within 1e-8 relative or 1e-14 absolute, its phase fields within 1e-12,
its means within 1e-10 relative and its distance evaluations equal; the
geometry fields and the VTK files within 1e-12 (the JAX package's
geometry fields in float64, as in tests/test_torch_io.py); then
tests/test_demos.py's oracles on the port.
"""
import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fibergen_tpu as fg
import fibergen_tpu_torch as ft
from fibergen_tpu.utils.logging import LOG as JLOG
from fibergen_tpu_torch.io import vtk
from fibergen_tpu_torch.utils.logging import LOG

import _torch_demos as demos
from test_torch_mesh import _check_fields

torch.set_num_threads(2)

# name -> (project, settings)
CASES = {"normals": ("geometry/normals", {}),
         "stl": ("geometry/stl", {"solver..n": 16}),
         "tetmesh": ("geometry/tetmesh", {}),
         "primitives": ("geometry/primitives", {"solver..n": 16})}
_PAIRS = {}


@pytest.fixture(autouse=True)
def _quiet():
    old = (JLOG.enabled, LOG.enabled)
    JLOG.enabled = LOG.enabled = False
    yield
    JLOG.enabled, LOG.enabled = old


def pair(name, tmp_path_factory):
    """(JAX FG, port FG, their directories) after run(), in directories of
    their own (the demos write their VTK files where they run)."""
    if name not in _PAIRS:
        path, kv = CASES[name]
        out = []
        for F, kw in ((fg.FG, {}), (ft.FG, {"device": "cpu"})):
            d = tmp_path_factory.mktemp(f"{name}_{F.__module__}")
            f = F(os.path.join(demos.DEMO_DIR, path, "project.xml"), **kw)
            for k, v in kv.items():
                f.set(k, v)
            if F is fg.FG:
                f._geometry_fields = functools.partial(f._geometry_fields,
                                                       dtype=jnp.float64)
            cwd = os.getcwd()
            os.chdir(d)
            try:
                assert f.run() == 0, name
            finally:
                os.chdir(cwd)
            f.init_phase()
            out.append((f, d))
        _PAIRS[name] = out
    return _PAIRS[name]


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_demo_matches_jax(name, tmp_path_factory):
    (a, da), (b, db) = pair(name, tmp_path_factory)
    ra, rb = a.get_residuals(), b.get_residuals()
    assert len(ra) == len(rb), (len(ra), len(rb))
    if ra:
        np.testing.assert_allclose(rb, ra, rtol=1e-8, atol=1e-14)
        assert demos.rel(b.get_mean_stress(), a.get_mean_stress()) <= 1e-10
        assert demos.rel(b.get_mean_strain(), a.get_mean_strain()) <= 1e-10
    np.testing.assert_allclose(b.get_field("phi"),
                               np.asarray(a.get_field("phi")), rtol=0,
                               atol=1e-12)
    assert b.get_distance_evals() == a.get_distance_evals() > 0
    assert [type(f).__name__ for f in b.gen.all_fibers()] == \
        [type(f).__name__ for f in a.gen.all_fibers()]
    if name == "primitives":
        demos.check_geometry(a, b)
    elif name != "stl":
        gb = b._geometry_fields(b.solver.grid)
        ga = a._geometry_fields(a.solver.grid)
        _check_fields(gb, ga, b.gen.all_fibers(), b.solver.grid)
    for fn in {"normals": ["normals.vtk"],
               "primitives": ["primitives.vtk"]}.get(name, []):
        ha, rec_a = vtk.read_vtk(str(da / fn))
        hb, rec_b = vtk.read_vtk(str(db / fn))
        assert ha == hb
        assert [n for _, n, _ in rec_a] == [n for _, n, _ in rec_b]
        for (_, n, x), (_, _, y) in zip(rec_b, rec_a):
            np.testing.assert_allclose(x, y, rtol=0, atol=1e-12, err_msg=n)


def test_demo_normals_oracle(tmp_path_factory):
    """tests/test_demos.py: unit normals near the interface, and the file
    holds them."""
    (_, _), (f, d) = pair("normals", tmp_path_factory)
    n = f.get_field("normals")
    mask = np.abs(f.get_field("distance")).squeeze() < 0.1
    assert abs(float(np.sqrt((n * n).sum(0))[mask].mean()) - 1.0) < 1e-3
    names = [nm for _, nm, _ in vtk.read_vtk(str(d / "normals.vtk"))[1]]
    assert names[:2] == ["distance", "normals"]


def test_demo_stl_oracle(tmp_path_factory):
    (_, _), (f, _) = pair("stl", tmp_path_factory)
    assert f.get_mean_stress()[0] > 1.0       # the conductive blob
    assert abs(f.get_volume_fraction("blob") - 0.115) < 0.03


def test_demo_tetmesh_oracle(tmp_path_factory):
    (_, _), (f, _) = pair("tetmesh", tmp_path_factory)
    sig = np.array(f.get_mean_stress())
    assert np.all(np.isfinite(sig)) and sig[0] > 0 and sig[5] > 0
    assert 0.1 < f.get_volume_fraction("core") < 0.6
    assert f.solver.mat.normals is f._gfields_cache[1]["normals"]


def test_demo_primitives_writes_its_vtk(tmp_path_factory):
    (_, _), (f, d) = pair("primitives", tmp_path_factory)
    names = [nm for _, nm, _ in vtk.read_vtk(str(d / "primitives.vtk"))[1]]
    assert names == ["distance", "normals", "normals_0", "normals_1",
                     "normals_2", "orientation", "orientation_0",
                     "orientation_1", "orientation_2", "fiber_id",
                     "material_id"]
