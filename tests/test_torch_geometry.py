"""The port's geometry layer against the JAX package's, on the CPU in
float64: the XML project reader and its expression engine on one project
text (the same values); each distribution's draws from one seed (bitwise);
the RSA generator's fibre lists under capsule and cylinder, periodic (the
27-neighbour and the wall mode), planar, dmin, intersecting and a volume
target (bitwise: centres, axes, lengths, radii, ids, materials, clone
translations and the A2/A4 moments); the native library against its numpy
twin and the port's against the JAX package's build; ``phi_field``,
``voxelize`` and ``geometry_fields`` on odd grids at supersample 1 and 2,
also in x-slabs and fibre groups forced by a lowered budget, within 1e-12.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

import fibergen_tpu as fg
import fibergen_tpu_torch as ft
from fibergen_tpu import native as jnative
from fibergen_tpu.config import xmlproject as jxml
from fibergen_tpu.geometry import discretize as jdisc
from fibergen_tpu.geometry import distributions as jdist
from fibergen_tpu.geometry import generator as jgen
from fibergen_tpu.geometry import primitives as jprim
from fibergen_tpu.utils.logging import LOG as JLOG
from fibergen_tpu_torch import native
from fibergen_tpu_torch.config import xmlproject
from fibergen_tpu_torch.geometry import discretize, distributions, generator
from fibergen_tpu_torch.geometry import primitives
from fibergen_tpu_torch.utils.logging import LOG

torch.set_num_threads(2)

# phi and the geometry fields against the JAX package
TOL = 1e-12

PROJECT = """<settings>
  <variables><res type="int" value="12" /><s type="float" value="2.5" />
    <name type="str" value="abc" /></variables>
  <python>k = res * 3 + 1</python>
  <length>0.1*s</length>
  <solver n="res" nx="k">
    <tol>1e-6</tol>
    <materials><matrix mu="1" lambda="s**2" /><fibre mu="cos(0)" /></materials>
  </solver>
  <actions><place_fiber R="0.2" cx="0.5" /><place_fiber R="0.1" /></actions>
</settings>"""


@pytest.fixture(autouse=True)
def _quiet():
    old = (JLOG.enabled, LOG.enabled)
    JLOG.enabled = LOG.enabled = False
    yield
    JLOG.enabled, LOG.enabled = old


def _engine_after_python(mod):
    eng = mod.ExpressionEngine()
    proj = mod.XMLProject()
    proj.set_xml(PROJECT)
    s = mod.SettingsReader(eng, proj.root)
    for v in s.child("variables").children():
        typ = v.get("type")
        eng.add_local(v.tag, v.get("value") if typ == "str" else
                      {"int": int, "float": float}[typ](eng.eval(v.get("value"))))
    eng.exec_code(proj.root.find("python").text)
    return proj, eng, s


def test_xml_reader_and_expressions_match_jax():
    got = []
    for mod in (jxml, xmlproject):
        proj, eng, s = _engine_after_python(mod)
        sol = s.child("solver")
        m = sol.child("materials").children()
        acts = s.child("actions").children()
        proj.set("solver.tol", 1e-8)
        proj.set("solver..mult", 2)
        proj.set("actions.place_fiber[1]..R", 0.3)
        proj.erase("actions.place_fiber[0]")
        got.append((
            s.value("length"), sol.attr("n", 0, int), sol.attr("nx", 0, int),
            sol.value("tol"), [c.tag for c in m],
            mod.SettingsReader(eng, m[0]).attr("lambda", None, float),
            mod.SettingsReader(eng, m[1]).attr("mu", None, float),
            [a.get("R") for a in acts], eng.get("k > 30", bool),
            eng.locals["name"], proj.get("solver.tol"),
            proj.get("solver..mult"), proj.has("solver..nx"),
            proj.get("actions.place_fiber..R"), proj.get_xml()))
    assert got[0] == got[1]
    assert got[1][:4] == (0.25, 12, 37, 1e-8)


def test_expression_engine_disabled_refuses_expressions():
    for mod in (jxml, xmlproject):
        eng = mod.ExpressionEngine()
        eng.enabled = False
        assert eng.get("3", int) == 3
        with pytest.raises(ValueError, match="disabled"):
            eng.get("1+2", int)


def _dists(mod):
    return [mod.Dirac(np.array([0.2, 0.0, 1.0])),
            mod.UniformSphere(),
            mod.UniformInterval(0.1, 0.4),
            mod.NormalScalar(0.3, 0.05),
            mod.NormalSphere(np.array([1.0, 2.0, 0.5]), 0.2),
            mod.ListDistribution(np.eye(3)),
            mod.ACG(A=np.diag([0.6, 0.3, 0.1])),
            mod.ACG(A=np.array([[0.5, 0.1, 0.0], [0.1, 0.5, 0.0],
                                [0.0, 0.0, 0.0]])),
            mod.Composite([mod.Dirac(np.array([1.0, 0, 0]), weight=2.0),
                           mod.UniformSphere(weight=1.0),
                           mod.ACG(A=np.diag([0.2, 0.2, 0.6]))])]


@pytest.mark.parametrize("k", range(9))
def test_distribution_draws_match_jax_bitwise(k):
    dj, dp = _dists(jdist)[k], _dists(distributions)[k]
    rj, rp = np.random.default_rng(k), np.random.default_rng(k)
    a = np.stack([dj.draw(rj, i) for i in range(200)])
    b = np.stack([dp.draw(rp, i) for i in range(200)])
    np.testing.assert_array_equal(a, b)


def test_acg_moment_inversion_matches_jax():
    for a in ([0.7, 0.2, 0.1], [0.5, 0.5, 0.0], [1 / 3] * 3, [0.9, 0.1, 0]):
        np.testing.assert_array_equal(distributions.acg_b_from_moments(a),
                                      jdist.acg_b_from_moments(a))
    b = np.array([4.0, 1.0, 0.25])
    np.testing.assert_array_equal(distributions.acg_moments_from_b(b),
                                  jdist.acg_moments_from_b(b))


# name -> (settings, run kwargs, orientation/length/radius distributions)
GEN_CASES = {
    "capsule": (dict(length=0.3, radius=0.04, target_count=15, dmin=0.01,
                     seed=3), {}, "acg"),
    "cylinder": (dict(fiber_type="cylinder", length=0.25, radius=0.03,
                      target_count=15, seed=5), {}, "uniform"),
    "volume": (dict(length=0.2, radius=0.05, target_volume=0.12, seed=1),
               {}, "lengths"),
    "wall-mode": (dict(length=0.3, radius=0.03, target_count=12, seed=9,
                       periodic_fast=True), {}, "acg"),
    "planar": (dict(length=0.3, radius=0.025, target_count=10, seed=0,
                    dmin=0.01, planar_z=True, periodic_z=False,
                    dims=(1.0, 1.0, 1 / 32)), {}, "planar"),
    "intersecting": (dict(length=0.4, radius=0.05, target_count=25, seed=2,
                          intersecting=True), {}, "uniform"),
    "aperiodic": (dict(length=0.3, radius=0.05, target_count=10, seed=4,
                       periodic_x=False, periodic_y=False, periodic_z=False),
                  {}, "acg"),
    "run-args": (dict(length=0.3, radius=0.04, seed=6, max_iter=300),
                 dict(N=8, dmin=0.02), "acg"),
}


def _generate(gmod, dmod, case):
    kw, run_kw, dist = GEN_CASES[case]
    g = gmod.FiberGenerator(gmod.GeneratorSettings(**kw))
    g.select_material(1, "fibre")
    if dist == "acg":
        g.orientation_distribution = dmod.ACG(A=np.diag([0.6, 0.3, 0.1]))
    elif dist == "planar":
        g.orientation_distribution = dmod.ACG(A=np.diag([0.7, 0.3, 0.0]))
    elif dist == "lengths":
        g.length_distribution = dmod.UniformInterval(0.05, 0.3)
        g.radius_distribution = dmod.NormalScalar(0.05, 0.005)
    g.run(**run_kw)
    return g


@pytest.mark.parametrize("case", list(GEN_CASES))
def test_generator_fibre_lists_match_jax_bitwise(case):
    gj = _generate(jgen, jdist, case)
    gp = _generate(generator, distributions, case)
    fj, fp = gj.all_fibers(), gp.all_fibers()
    assert len(gj.fibers) == len(gp.fibers) > 0
    assert len(fj) == len(fp)
    for a, b in zip(fj, fp):
        assert type(a).__name__ == type(b).__name__
        for attr in ("center", "axis", "length", "radius", "fiber_id",
                     "material", "translation"):
            va, vb = getattr(a, attr), getattr(b, attr)
            if va is None:
                assert vb is None
            else:
                np.testing.assert_array_equal(va, vb)
    np.testing.assert_array_equal(gj.get_A2(), gp.get_A2())
    np.testing.assert_array_equal(gj.get_A4(), gp.get_A4())
    assert gj.volume_fraction(1) == gp.volume_fraction(1)


def test_native_library_matches_its_numpy_twin_and_the_jax_build():
    assert native.get_lib() is not None, "g++ builds the native library"
    assert str(native.library_path()).startswith(
        str(native.BUILD)), "the port builds into its own _build/"
    rng = np.random.default_rng(0)
    p1, q1 = rng.standard_normal(3), rng.standard_normal(3)
    P2, Q2 = rng.standard_normal((64, 3)), rng.standard_normal((64, 3))
    Q2[:4] = P2[:4]                         # degenerate segments
    d = native.segseg_distance_batch(p1, q1, P2, Q2)
    np.testing.assert_allclose(
        d, primitives.segment_segment_distance(p1, q1, P2, Q2), rtol=0,
        atol=1e-12)
    if jnative.get_lib() is not None:
        np.testing.assert_array_equal(
            d, jnative.segseg_distance_batch(p1, q1, P2, Q2))


def test_plane_cut_fraction_against_the_native_oracle():
    """float64 within 1e-9 of the long-double oracle, as the JAX package's
    own test holds its version; float32 within 2e-6 of float64."""
    rng = np.random.default_rng(2)
    h = (0.9, 1.1, 1.3)
    normals = [rng.standard_normal(3) for _ in range(20)]
    normals += [np.array([1.0, 0, 0]), np.array([0, 1.0, 0]),
                np.array([0, 0, 1.0]), np.array([1.0, 1e-9, 0])]
    ds = [-1.5, -0.4, -0.05, 0.0, 0.05, 0.4, 1.5]
    for n in normals:
        n = n / np.linalg.norm(n)
        for dt, tol in ((torch.float64, 1e-9), (torch.float32, 2e-6)):
            t = lambda v: torch.tensor(v, dtype=dt)
            got = discretize.plane_cut_fraction(
                t(ds), t(n[0]), t(n[1]), t(n[2]), h).double().numpy()
            want = [native.halfspace_box_cut_fraction(n, d, h) for d in ds]
            np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def _fibres(prim, material=1):
    """Capsules, cylinders, a sphere, a clone with its translation and a
    half space."""
    r = np.random.default_rng(11)
    out = []
    for i in range(7):
        a = r.standard_normal(3)
        a /= np.linalg.norm(a)
        cls = prim.Cylinder if i % 3 == 0 else prim.Capsule
        f = cls(center=r.uniform(0, 1, 3), axis=a,
                length=float(r.uniform(0, 0.5)),
                radius=float(r.uniform(0.05, 0.2)))
        f.material, f.fiber_id = material + (i == 6), i + 1
        if i == 5:
            f.translation = np.array([1.0, 0.0, 0.0])
        out.append(f)
    s = prim.sphere([0.2, 0.7, 0.4], 0.15)
    s.material, s.fiber_id = material, 8
    h = prim.HalfSpace(point=np.array([0.3, 0.5, 0.5]),
                       normal=np.array([-1.0, 0.2, 0.1]))
    h.material, h.fiber_id = material, 9
    return out + [s, h]


SHAPE = (17, 13, 11)
CELL = (1.0, 1.2, 0.9, (0.1, 0.0, -0.05))


@pytest.mark.parametrize("budget", [None, 700])
@pytest.mark.parametrize("ss", [1, 2])
def test_phi_field_matches_jax(ss, budget, monkeypatch):
    """``budget`` lowers the port's PHI_SLAB_VOXELS: one x row a slab and
    one fibre a group."""
    if budget:
        monkeypatch.setattr(discretize, "PHI_SLAB_VOXELS", budget)
    jg, pg = fg.Grid(*SHAPE, *CELL), ft.Grid(*SHAPE, *CELL)
    want = np.asarray(jdisc.phi_field(jg, _fibres(jprim), ss, jnp.float64))
    n0 = discretize.DIST_EVALS
    got = discretize.phi_field(pg, _fibres(primitives), ss, torch.float64)
    assert got.dtype == torch.float64 and got.shape == SHAPE
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    assert discretize.DIST_EVALS - n0 == 9 * int(np.prod(SHAPE)) * ss ** 3
    assert 0.2 < want.mean() < 0.95


def test_phi_field_float32_holds_to_float64():
    pg = ft.Grid(*SHAPE, *CELL)
    a = discretize.phi_field(pg, _fibres(primitives), 2, torch.float64)
    b = discretize.phi_field(pg, _fibres(primitives), 2, torch.float32)
    assert b.dtype == torch.float32
    assert float((a - b.double()).abs().max()) < 2e-6


@pytest.mark.parametrize("ss", [1, 2])
def test_voxelize_matches_jax(ss, monkeypatch):
    monkeypatch.setattr(discretize, "PHI_SLAB_VOXELS", 3000)
    jg, pg = fg.Grid(*SHAPE, *CELL), ft.Grid(*SHAPE, *CELL)
    want = jdisc.voxelize(jg, _fibres(jprim), 3, matrix_material=0,
                          supersample=ss, dtype=jnp.float64)
    got = discretize.voxelize(pg, _fibres(primitives), 3, matrix_material=0,
                              supersample=ss, dtype=torch.float64)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=TOL)
    np.testing.assert_allclose(sum(g for g in got).numpy(), 1.0, atol=1e-14)


@pytest.mark.parametrize("budget", [None, 700])
def test_geometry_fields_match_jax(budget, monkeypatch):
    if budget:
        monkeypatch.setattr(discretize, "PHI_SLAB_VOXELS", budget)
    jg, pg = fg.Grid(*SHAPE, *CELL), ft.Grid(*SHAPE, *CELL)
    want = jdisc.geometry_fields(jg, _fibres(jprim), dtype=jnp.float64)
    got = discretize.geometry_fields(pg, _fibres(primitives),
                                     dtype=torch.float64)
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w)
        g = got[k].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if w.dtype.kind == "i":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=TOL, err_msg=k)
    assert set(np.unique(got["fiber_id"].numpy())) >= {1, 5, 8}


def test_mesh_primitives_are_refused():
    class Triangle(primitives.Fiber):
        pass

    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        discretize.phi_field(ft.Grid(4, 4, 4), [Triangle()])
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        discretize.geometry_fields(ft.Grid(4, 4, 4), [Triangle()])
