"""The port's file I/O and field recovery against the JAX package, on the
CPU in float64.

* Raw rasters (every dtype, both orders, gzip or not, scale, threshold,
  header bytes): written then read back bitwise, the same bytes as the JAX
  package's writer, and read alike by both readers; the VTK and PNG
  writers: the same bytes; the VTK reader: each record back.
* The writer actions through both FGs (write_vtk, write_vtk2,
  write_vtk_phase, write_lss_vtk, write_raw_data, write_png, write_pvpy,
  write_voxel_data, write_fiber_data, write_fo_data, run_load_case's
  outfile, calc_effective_properties' outdir, <write_loadsteps>): the
  VTK headers equal, the field names in the same order, the arrays within
  1e-12 (restype double); the text files equal.  The JAX package computes
  the geometry fields it writes in float32 whatever the datatype; here it
  is given float64 (its _geometry_fields' dtype), so that the arrays
  compare at 1e-12.
* read_raw_data with and without material_<k> on a synthetic 16^3 volume:
  phi bitwise, the solve iteration for iteration.
* get_field("u") and ("p") in elasticity, heat, porous flow and viscosity
  within 1e-12 of the JAX package's recovery (in viscosity its solution
  VTK's velocity and pressure: its get_field there runs the displacement
  recovery on the stress field; ROADMAP.md, Queue 3); the identity
  eps_staggered(<eps>, u) = eps within 1e-10 in elasticity and
  hyperelasticity (the JAX package's dim-9 recovery misses it, Queue 3);
  the Poisson solve within 1e-12 of the JAX package's.
* Checkpoints across the packages both ways, and get_fft_time.
"""
import functools
import gzip
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fibergen_tpu as fg
import fibergen_tpu_torch as ft
from fibergen_tpu.io import png as jpng
from fibergen_tpu.io import rawio as jraw
from fibergen_tpu.io import vtk as jvtk
from fibergen_tpu.ops import green as jgreen
from fibergen_tpu.utils.logging import LOG as JLOG
from fibergen_tpu_torch.io import png, rawio, vtk
from fibergen_tpu_torch.ops import green, staggered
from fibergen_tpu_torch.utils.logging import LOG

import _torch_demos as demos

torch.set_num_threads(2)
TOL = 1e-12


@pytest.fixture(autouse=True)
def _quiet():
    old = (JLOG.enabled, LOG.enabled)
    JLOG.enabled = LOG.enabled = False
    yield
    JLOG.enabled, LOG.enabled = old


def _content(path):
    with (gzip.open if str(path).endswith(".gz") else open)(path, "rb") as f:
        return f.read()


# ------------------------------------------------------------- raw files
@pytest.mark.parametrize("dtype", ["uint8", "uint16", "uint32", "float",
                                   "double"])
@pytest.mark.parametrize("order", ["col", "row"])
@pytest.mark.parametrize("gz", [False, True])
def test_raw_round_trip_matches_jax(dtype, order, gz, tmp_path):
    rng = np.random.default_rng(0)
    data = rng.random((5, 4, 3))
    data[0, 0, 0], data[1, 1, 1] = 0.0, 1.0
    ext = ".raw.gz" if gz else ".raw"
    mine, theirs = tmp_path / f"a{ext}", tmp_path / f"b{ext}"
    for scale in (None, 0.5):
        rawio.write_raw(str(mine), data, dtype, order, scale)
        jraw.write_raw(str(theirs), data, dtype, order, scale)
        assert _content(mine) == _content(theirs)
        rscale = None if scale is None else 1.0 / scale
        got = rawio.read_raw(str(mine), data.shape, dtype, order, rscale)
        want = jraw.read_raw(str(mine), data.shape, dtype, order, rscale)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        if dtype in ("float", "double"):
            np.testing.assert_allclose(got, data, rtol=1e-7 if dtype ==
                                       "float" else 0, atol=0)
    for thr in (-1.0, 0.5):
        np.testing.assert_array_equal(
            rawio.read_raw(str(mine), data.shape, dtype, order,
                           threshold=thr),
            jraw.read_raw(str(mine), data.shape, dtype, order,
                          threshold=thr))


def test_raw_header_bytes(tmp_path):
    data = np.arange(24, dtype=np.uint8).reshape(2, 3, 4)
    p = tmp_path / "h.raw"
    p.write_bytes(b"HEADER" + data.tobytes())
    got = rawio.read_raw(str(p), data.shape, header_bytes=6, scale=1.0)
    np.testing.assert_array_equal(got, data)
    np.testing.assert_array_equal(
        got, jraw.read_raw(str(p), data.shape, header_bytes=6, scale=1.0))


# ------------------------------------------------------------- VTK, PNG
@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_vtk_writer_matches_jax_and_reads_back(binary, dtype, tmp_path):
    rng = np.random.default_rng(1)
    fields = {"phi": rng.random((1, 5, 4, 3)), "u": rng.random((3, 5, 4, 3)),
              "eps": rng.random((6, 5, 4, 3)), "T": rng.random((5, 4, 3))}
    g = ft.Grid(5, 4, 3, 1.0, 2.0, 0.5, (0.1, 0.2, 0.3))
    vtk.write_vtk(str(tmp_path / "a.vtk"), g, fields, binary, dtype)
    jvtk.write_vtk(str(tmp_path / "b.vtk"),
                   fg.Grid(5, 4, 3, 1.0, 2.0, 0.5, (0.1, 0.2, 0.3)), fields,
                   binary, dtype)
    assert (tmp_path / "a.vtk").read_bytes() == \
        (tmp_path / "b.vtk").read_bytes()
    header, records = vtk.read_vtk(str(tmp_path / "a.vtk"))
    assert header[4] == "DIMENSIONS 5 4 3" and header[7] == "POINT_DATA 60"
    assert header[6] == "SPACING 0.2 0.5 0.16666666666666666"
    assert [(k, n) for k, n, _ in records] == \
        [("SCALARS", "phi"), ("VECTORS", "u"), ("SCALARS", "u_0"),
         ("SCALARS", "u_1"), ("SCALARS", "u_2")] + \
        [("SCALARS", f"eps_{k}") for k in range(6)] + [("SCALARS", "T")]
    arrays = {n: a for _, n, a in records}
    np.testing.assert_array_equal(arrays["u"], fields["u"].astype(dtype))
    np.testing.assert_array_equal(arrays["eps_4"],
                                  fields["eps"][4].astype(dtype))
    np.testing.assert_array_equal(arrays["T"], fields["T"].astype(dtype))


def test_png_writer_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    for img in (rng.random((7, 9)), rng.random((4, 5, 3)),
                (rng.random((3, 4)) * 255).astype(np.uint8)):
        png.write_png(str(tmp_path / "a.png"), img)
        jpng.write_png(str(tmp_path / "b.png"), img)
        assert (tmp_path / "a.png").read_bytes() == \
            (tmp_path / "b.png").read_bytes()
    np.testing.assert_array_equal(png.colormap_jet(np.linspace(0, 1, 9)),
                                  jpng.colormap_jet(np.linspace(0, 1, 9)))


def _vtk_equal(a, b, skip=()):
    """Two solution or geometry VTKs: the headers equal (the title line
    excepted), the names in the same order, the arrays within TOL (those
    named in ``skip`` only present)."""
    ha, ra = vtk.read_vtk(a)
    hb, rb = vtk.read_vtk(b)
    assert ha[0] == hb[0] and ha[2:] == hb[2:]
    assert [(k, n) for k, n, _ in ra] == [(k, n) for k, n, _ in rb]
    for (_, n, x), (_, _, y) in zip(ra, rb):
        if n.split("_")[0] not in skip:
            np.testing.assert_allclose(x, y, rtol=0, atol=TOL, err_msg=n)
    return {n: x for _, n, x in ra}


# --------------------------------------------------- the writer actions
def _pair(xml, tmp_path, mode_dirs=("jax", "port")):
    """(JAX FG, port FG) of ``xml``, each run in its own directory under
    tmp_path (the project's relative file names land there), float64
    geometry fields on the JAX side."""
    out = []
    for F, kw, d in ((fg.FG, {}, mode_dirs[0]),
                     (ft.FG, {"device": "cpu"}, mode_dirs[1])):
        os.makedirs(tmp_path / d, exist_ok=True)
        cwd = os.getcwd()
        os.chdir(tmp_path / d)
        try:
            f = F(**kw)
            f.set_xml(xml)
            if F is fg.FG:
                f._geometry_fields = functools.partial(f._geometry_fields,
                                                       dtype=jnp.float64)
            assert f.run() == 0
        finally:
            os.chdir(cwd)
        out.append(f)
    return out


WRITERS = """<settings>
  <restype>double</restype>
  <solver nx="9" ny="7" nz="5">
    <mode>heat</mode><tol>1e-10</tol>
    <materials><matrix mu="1" /><inc mu="5" /></materials>
  </solver>
  <actions>
    <select_material name="inc" />
    <place_fiber R="0.15" L="0.3" ax="1" ay="1" cx="0.4" />
    <place_fiber type="cylinder" R="0.1" L="0.3" cx="0.7" cy="0.6" az="1"
                 ax="0" />
    <place_fiber R="0.1" cx="0.2" cy="0.8" cz="0.3" />
    <place_fiber type="halfspace" cx="0.5" cy="0.95" ax="0" ay="1" />
    <place_tetrahedron p1x="0.5" p1y="0.1" p1z="0.1" p2x="0.95" p2y="0.1"
                       p2z="0.2" p3x="0.7" p3y="0.5" p3z="0.1" p4x="0.7"
                       p4y="0.3" p4z="0.6" />
    <init_phase />
    <write_vtk filename="geometry.vtk" />
    <write_vtk_phase name="inc" outfile="phase_inc.vtk" />
    <write_raw_data material="inc" filename="inc.raw" />
    <write_raw_data material="inc" filename="inc16.raw.gz" dtype="uint16"
                    order="row" />
    <write_png filename="d.png" a0z="0.3" w="20" h="12" exponent="0.5"
               scale="4" offset="0.01" />
    <write_pvpy filename="geo.py" />
    <write_voxel_data filename="voxels.txt" />
    <run_load_case e1="1" e3="0.5" outfile="lc.vtk" />
    <write_vtk2 outfile="sol2.vtk" />
    <write_lss_vtk filename="lss.vtk" />
    <calc_effective_properties outdir="cases" />
  </actions>
</settings>"""


def test_writer_actions_match_jax(tmp_path):
    a, b = _pair(WRITERS, tmp_path)
    ja, pb = tmp_path / "jax", tmp_path / "port"
    g = _vtk_equal(str(pb / "geometry.vtk"), str(ja / "geometry.vtk"))
    assert list(g)[:2] == ["distance", "normals"]
    _vtk_equal(str(pb / "phase_inc.vtk"), str(ja / "phase_inc.vtk"))
    for n in ("lc.vtk", "sol2.vtk", "lss.vtk", "cases/results_1.vtk",
              "cases/results_3.vtk"):
        s = _vtk_equal(str(pb / n), str(ja / n))
        assert list(s) == ["phi_matrix", "phi_inc", "epsilon_11",
                           "epsilon_22", "epsilon_33", "sigma_11",
                           "sigma_22", "sigma_33", "T"], n
    for n in ("inc.raw", "inc16.raw.gz", "d.png", "geo.py", "voxels.txt"):
        assert _content(pb / n) == _content(ja / n), n
    assert (pb / "d.png").stat().st_size > 60
    np.testing.assert_array_equal(
        rawio.read_raw(str(pb / "inc.raw"), (9, 7, 5)),
        np.round(b.get_field("inc")[0] * 255) * (1 / 255))
    assert "Box(" in (pb / "geo.py").read_text()
    assert len((pb / "voxels.txt").read_text().splitlines()) == 9 * 7 * 5 + 1


def test_fiber_data_and_pvpy_match_jax(tmp_path, monkeypatch):
    """write_fiber_data and write_fo_data text equal to the JAX package's
    on capsules, cylinders, spheres and a half space; write_pvpy on every
    primitive kind (a triangle, a tetrahedron, an STL surface and a tet
    mesh among them).  On mesh primitives the JAX package's fibre writer
    raises (no centre); the port writes the box's centre."""
    xml = WRITERS.replace('<place_tetrahedron', '<!-- ').replace(
        'p4y="0.3" p4z="0.6" />', ' -->').replace(
        '<init_phase />', '<write_fiber_data filename="f.txt" />'
        '<write_fo_data filename="fo.txt" /><exit />')
    xml = xml.split("<exit />")[0] + "</actions></settings>"
    a, b = _pair(xml, tmp_path)
    for n in ("f.txt", "fo.txt"):
        assert (tmp_path / "port" / n).read_text() == \
            (tmp_path / "jax" / n).read_text()
    (tmp_path / "m.vtk").write_text(
        "# vtk DataFile Version 2.0\ntet\nASCII\nDATASET UNSTRUCTURED_GRID\n"
        "POINTS 4 float\n0.1 0.1 0.1\n0.5 0.1 0.1\n0.1 0.5 0.1\n0.1 0.1 0.5\n"
        "CELLS 1 5\n4 0 1 2 3\nCELL_TYPES 1\n10\n")
    V = np.array([[0.6, 0.6, 0.6], [0.9, 0.6, 0.6], [0.6, 0.9, 0.6],
                  [0.6, 0.6, 0.9]])
    faces = [(0, 2, 1), (0, 1, 3), (0, 3, 2), (1, 2, 3)]
    stl = ["solid t"] + [
        line for f in faces for line in
        ["facet normal 0 0 0", "outer loop",
         *[f"vertex {V[i][0]} {V[i][1]} {V[i][2]}" for i in f],
         "endloop", "endfacet"]] + ["endsolid t"]
    (tmp_path / "t.stl").write_text("\n".join(stl) + "\n")
    mesh = f"""<settings><solver n="8"><mode>heat</mode><materials>
      <matrix mu="1" /><inc mu="5" /></materials></solver><actions>
      <select_material name="inc" />
      <place_fiber R="0.1" L="0.3" />
      <place_triangle p1x="0.1" p1y="0.2" p1z="0.3" p2x="0.8" p2y="0.3"
                      p2z="0.4" p3x="0.4" p3y="0.9" p3z="0.6" />
      <place_tetrahedron p2x="0.5" p3y="0.5" p4z="0.5" />
      <place_stl filename="{tmp_path / 't.stl'}" />
      <place_tetvtk filename="{tmp_path / 'm.vtk'}" />
      <write_pvpy filename="geo.py" bbox="0" />
    </actions></settings>"""
    a, b = _pair(mesh, tmp_path, ("jax_mesh", "port_mesh"))
    text = (tmp_path / "port_mesh" / "geo.py").read_text()
    assert text == (tmp_path / "jax_mesh" / "geo.py").read_text()
    # the mesh primitives and their periodic clones as polydata
    assert text.count("ProgrammableSource") >= 4 and "Box(" not in text
    b.set("actions.write_fiber_data..filename", str(tmp_path / "mf.txt"))
    monkeypatch.chdir(tmp_path / "port_mesh")
    assert b.run() == 0
    lines = (tmp_path / "mf.txt").read_text().splitlines()
    assert [ln.split()[2] for ln in lines[1:6]] == [
        "capsule", "triangle", "tetrahedron", "trianglesurface", "tetmesh"]
    with pytest.raises(AttributeError):
        a._action_write_fiber_data(None, _Attrs(filename=str(
            tmp_path / "jf.txt")))


class _Attrs:
    """An action's attributes for a direct call of an action handler."""

    def __init__(self, **kw):
        self.kw = kw

    def attr(self, name, default=None, typ=float):
        return self.kw.get(name, default)


def test_write_loadsteps_match_jax(tmp_path):
    xml = """<settings><restype>double</restype>
      <solver n="7"><tol>1e-10</tol><loadsteps>2</loadsteps>
        <write_loadsteps>1</write_loadsteps>
        <loadstep_filename>step_%d.vtk</loadstep_filename>
        <materials><matrix mu="1" lambda="1" /><inc mu="5" lambda="2" />
        </materials></solver>
      <actions><select_material name="inc" /><place_fiber R="0.3" />
        <run_load_case e11="1" e12="0.3" /></actions></settings>"""
    a, b = _pair(xml, tmp_path)
    for i in (0, 1, 2):        # the loadstep parameters 0, 0.5, 1
        s = _vtk_equal(str(tmp_path / "port" / f"step_{i}.vtk"),
                       str(tmp_path / "jax" / f"step_{i}.vtk"))
        assert "u" in s and "sigma_12" in s
    assert not (tmp_path / "port" / "step_3.vtk").exists()


# ---------------------------------------------- read_raw_data action
RAW_XML = """<settings>
  <solver n="16"><tol>1e-10</tol>
    <materials><matrix K="1" mu="1" /><quartz K="37" mu="44" />
      <calcite K="68" mu="28" /></materials>
    <batch_load_cases>off</batch_load_cases>
  </solver>
  <actions>
    {reads}
    <run_load_case e11="1" e23="0.2" />
  </actions>
</settings>"""


@pytest.mark.parametrize("mapped", [False, True])
def test_read_raw_data_matches_jax(mapped, tmp_path):
    rng = np.random.default_rng(3)
    v = rng.random((16, 16, 16))
    if mapped:
        labels = np.where(v < 0.3, 0, np.where(v < 0.7, 1, 2))
        rawio.write_raw(str(tmp_path / "labels.raw.gz"), labels / 255.0)
        reads = (f'<read_raw_data filename="{tmp_path}/labels.raw.gz" '
                 'material_1="quartz" material_2="calcite" />')
    else:
        rawio.write_raw(str(tmp_path / "q.raw"), (v > 0.7) * 1.0)
        rawio.write_raw(str(tmp_path / "c.raw.gz"), v * (v < 0.4),
                        dtype="uint16", order="row")
        reads = (f'<read_raw_data material="quartz" filename="'
                 f'{tmp_path}/q.raw" /><read_raw_data material="calcite" '
                 f'filename="{tmp_path}/c.raw.gz" dtype="uint16" '
                 f'order="row" />')
    a, b = _pair(RAW_XML.format(reads=reads), tmp_path)
    np.testing.assert_array_equal(b.get_field("phi"),
                                  np.asarray(a.get_field("phi")))
    if mapped:
        np.testing.assert_array_equal(b.get_field("quartz")[0],
                                      labels == 1)
    ra, rb = a.get_residuals(), b.get_residuals()
    assert len(ra) == len(rb)
    np.testing.assert_allclose(rb, ra, rtol=1e-8, atol=1e-14)
    assert demos.rel(b.get_mean_stress(), a.get_mean_stress()) <= 1e-10


# ----------------------------------------------------- field recovery
MODES = {
    "elasticity": ('mu="1" lambda="1"', 'mu="5" lambda="2"',
                   'e11="1" e23="0.2"'),
    "heat": ('mu="1"', 'mu="5"', 'e1="1" e2="0.3"'),
    "porous": ('mu="1"', 'mu="5"', 'e1="1" e3="0.3"'),
    "viscosity": ('mu="1"', 'mu="0.1"', 'e13="1" e12="0.5"'),
    "hyperelasticity": ('mu="1" lambda="1"', 'mu="5" lambda="2"',
                        'e11="1.02" e12="0.01"'),
}
MODE_XML = """<settings><restype>double</restype>
  <solver nx="9" ny="7" nz="5"><tol>{tol}</tol><mode>{mode}</mode>
    <error_estimator>{est}</error_estimator>
    <materials><matrix {m1} /><inc {m2} /></materials>
  </solver>
  <actions>
    <select_material name="inc" />
    <place_fiber R="0.3" L="0.3" ax="1" ay="1" />
    <run_load_case {load} outfile="sol.vtk" />
  </actions>
</settings>"""

_RUNS = {}


def _mode_pair(mode, tmp_path_factory):
    if mode not in _RUNS:
        m1, m2, load = MODES[mode]
        hyper = mode == "hyperelasticity"
        xml = MODE_XML.format(mode=mode, m1=m1, m2=m2, load=load,
                              tol=1e-8 if hyper else 1e-10,
                              est="residual" if hyper else "epsilon")
        _RUNS[mode] = _pair(xml, tmp_path_factory.mktemp(mode))
    return _RUNS[mode]


def _identity(lss, u):
    g, eps = lss.grid, lss.eps
    E = eps.mean(dim=(1, 2, 3))
    u = torch.as_tensor(np.array(u))
    op = {3: staggered.eps_staggered_heat, 6: staggered.eps_staggered,
          9: staggered.eps_staggered_hyper}[lss.dim]
    return float((op(g, E, u) - eps).abs().max() / eps.abs().max())


@pytest.mark.parametrize("mode", list(MODES))
def test_recovered_fields_match_jax(mode, tmp_path_factory):
    a, b = _mode_pair(mode, tmp_path_factory)
    assert len(a.get_residuals()) == len(b.get_residuals())
    u, p = b.get_field("u"), b.get_field("p")
    if mode == "viscosity":
        ua, pa = (np.asarray(x) for x in a._viscosity_velocity_pressure())
        assert u.shape == (3, 9, 7, 5) and p.shape == (1, 9, 7, 5)
    else:
        ua = pa = np.asarray(a.get_field("u"))
        np.testing.assert_array_equal(p, u)
    if mode == "hyperelasticity":
        # the JAX package recovers u from F's upper shear entries through
        # the symmetric operators: its u misses the identity
        assert _identity(b.solver, u) <= 1e-10
        assert _identity(b.solver, ua) > 1e-3
    else:
        assert demos.rel(u, ua) <= TOL and demos.rel(p, pa) <= TOL
    if mode in ("elasticity", "heat", "porous"):
        assert _identity(b.solver, u) <= 1e-10
    if mode == "viscosity":
        assert demos.rel(np.asarray(a.get_field("u")), ua) > 1e-3
    assert abs(float(u.reshape(u.shape[0], -1).mean(1).max())) < 1e-12


@pytest.mark.parametrize("mode", list(MODES))
def test_solution_vtk_matches_jax(mode, tmp_path_factory):
    a, b = _mode_pair(mode, tmp_path_factory)
    d = tmp_path_factory.getbasetemp()
    pa = [p for p in d.rglob("jax/sol.vtk") if p.parent.parent.name
          .startswith(mode)][0]
    pb = pa.parent.parent / "port" / "sol.vtk"
    names = _vtk_equal(str(pb), str(pa),
                       skip=("u",) if mode == "hyperelasticity" else ())
    want = {"elasticity": ["epsilon_11", "sigma_11", "u"],
            "heat": ["epsilon_11", "sigma_11", "T"],
            "porous": ["epsilon_11", "sigma_11", "p"],
            "viscosity": ["epsilon_11", "sigma_11", "u", "p"],
            "hyperelasticity": ["F_11", "F_21", "P_21", "u", "detF"]}[mode]
    assert all(n in names for n in want) and "phi_inc" in names
    key = {"heat": "T", "porous": "p"}.get(mode, "u")
    np.testing.assert_allclose(names[key],
                               b.get_field("u")[0 if key != "u" else
                                                slice(None)],
                               rtol=0, atol=TOL)


def test_poisson_solve_matches_jax():
    rng = np.random.default_rng(4)
    f = rng.standard_normal((1, 9, 6, 5))
    f -= f.mean()
    want = np.asarray(jgreen.poisson_solve(fg.Grid(9, 6, 5, 1.0, 2.0, 0.5),
                                           jnp.asarray(f)))
    got = green.poisson_solve(ft.Grid(9, 6, 5, 1.0, 2.0, 0.5),
                              torch.as_tensor(f)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * np.abs(want).max())
    # the 7-point Laplacian of p gives f back
    p = torch.as_tensor(got)
    lap = sum((torch.roll(p, -1, k) - 2 * p + torch.roll(p, 1, k))
              * (n / d) ** 2
              for k, n, d in ((1, 9, 1.0), (2, 6, 2.0), (3, 5, 0.5)))
    np.testing.assert_allclose(lap.numpy(), f, rtol=0, atol=1e-12)


# ------------------------------------------------------- checkpoints
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoints_load_across_packages(direction, tmp_path):
    m1, m2, load = MODES["elasticity"]
    xml = MODE_XML.format(mode="elasticity", m1=m1, m2=m2, load=load,
                          tol=1e-10, est="epsilon").replace(
        ' outfile="sol.vtk"', "")
    a, b = _pair(xml, tmp_path)
    ck = str(tmp_path / "state.npz")
    src, dst_cls = (a, ft.FG) if direction == "jax_to_port" else (b, fg.FG)
    src.solver.save_state(ck)
    kw = {"device": "cpu"} if dst_cls is ft.FG else {}
    dst = dst_cls(**kw)
    dst.set_xml(xml.replace(f"<run_load_case {load} />",
                            '<init_phase /><load_state filename="'
                            f'{ck}" />'))
    assert dst.run() == 0
    assert dst.solver.mu_0 == src.solver.mu_0
    np.testing.assert_allclose(np.asarray(dst.solver.eps),
                               np.asarray(src.solver.eps), rtol=0, atol=0)
    np.testing.assert_allclose(dst.get_mean_stress(), src.get_mean_stress(),
                               rtol=1e-12)
    np.testing.assert_array_equal(dst.get_residuals(), src.get_residuals())
    # the resumed solver solves as the source did
    assert not dst.solver.run()
    assert len(dst.get_residuals()) == len(src.get_residuals())
    assert demos.rel(dst.get_mean_stress(), src.get_mean_stress()) <= 1e-10
    # the save_state action writes the same keys
    b.set("actions.save_state..filename", str(tmp_path / "p.npz"))
    assert b.run() == 0
    z = np.load(str(tmp_path / "p.npz"))
    assert sorted(z.files) == sorted(np.load(ck).files)


def test_checkpoint_of_another_mode_raises(tmp_path):
    m1, m2, load = MODES["heat"]
    a, b = _pair(MODE_XML.format(mode="heat", m1=m1, m2=m2, load=load,
                                 tol=1e-8, est="epsilon"), tmp_path)
    ck = str(tmp_path / "h.npz")
    b.solver.save_state(ck)
    m1, m2, load = MODES["elasticity"]
    c = ft.FG(device="cpu")
    c.set_xml(MODE_XML.format(mode="elasticity", m1=m1, m2=m2, load=load,
                              tol=1e-8, est="epsilon"))
    c.init_lss()
    with pytest.raises(Exception, match="mode"):
        c.solver.load_state(ck)


def test_get_fft_time(tmp_path_factory):
    _, b = _mode_pair("elasticity", tmp_path_factory)
    s = b.solver
    t = b.get_fft_time()
    assert s._chain_calls == {("g0_staggered_chain", 3):
                              len(s.residuals) + 1}
    assert 0.0 < t <= s.solve_time
    assert ft.FG(device="cpu").get_fft_time() == 0.0
