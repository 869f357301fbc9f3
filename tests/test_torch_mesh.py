"""The port's mesh slice against the JAX package, on the CPU in float64.

* The readers (STL ASCII and binary, legacy-VTK tet meshes, Dolfin XML; the
  inputs of tests/test_mesh.py and the demos' meshes): the same arrays,
  bitwise.
* The mesh primitives' host ``distance`` within 1e-12 (the triangles'
  against the voxelizer's arithmetic and a dense sampling: the JAX
  package's host copy comes out short), and their volumes and bounding
  boxes.
* The voxelizer's mesh contributions (``phi_field``, which adds
  ``mesh_phi_contributions``) and the geometry fields (distance, normals,
  orientation, ids, translation) for a triangle, a tetrahedron, a tet
  mesh and a filled and an unfilled triangle surface, within 1e-12; the
  geometry fields of a filled surface against the closest triangle's
  signed distance instead (the JAX package's are not, see
  test_filled_surface_distance_is_signed_by_the_closest_triangle).  Where
  two primitives (or two faces of a tetrahedron) are the closest within
  rounding, at a shared edge, vertex or face, the JAX package keeps the
  one that its fused multiply-adds make closer (XLA contracts a*b + c on
  the CPU; the port's eager operations round each product), and the two
  normals differ: there the port's normal is held to one of the tied
  primitives' normals, and its phi to the tied points' share of the voxel
  (each supersampled point is 1/8 of it).
* ``detect_fibers`` on tests/test_detect.py's capsule and RSA phantom: the
  same fibre list, and the detect_fibers action.
"""
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fibergen_tpu as fg
import fibergen_tpu_torch as ft
from fibergen_tpu.geometry import discretize as jdisc
from fibergen_tpu.geometry import mesh as jmesh
from fibergen_tpu.geometry import primitives as jprim
from fibergen_tpu.utils.logging import LOG as JLOG
from fibergen_tpu_torch.geometry import discretize, mesh, primitives
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


def _cube(lo=0.3, hi=0.7):
    """tests/test_mesh.py's 12 triangles of a cube, outward normals."""
    v = np.array([[x, y, z] for x in (lo, hi) for y in (lo, hi)
                  for z in (lo, hi)])
    quads = [(0, 1, 3, 2, [-1, 0, 0]), (4, 6, 7, 5, [1, 0, 0]),
             (0, 4, 5, 1, [0, -1, 0]), (2, 3, 7, 6, [0, 1, 0]),
             (0, 2, 6, 4, [0, 0, -1]), (1, 5, 7, 3, [0, 0, 1])]
    tris = []
    for a, b, c, d, n in quads:
        for t in ((a, b, c), (a, c, d)):
            p0, p1, p2 = v[t[0]], v[t[1]], v[t[2]]
            if np.cross(p1 - p0, p2 - p0) @ np.array(n) < 0:
                p1, p2 = p2, p1
            tris.append((p0, p1, p2))
    a = np.asarray(tris)
    return a[:, 0], a[:, 1], a[:, 2]


TET_VTK = """# vtk DataFile Version 2.0
tet
ASCII
DATASET UNSTRUCTURED_GRID
POINTS 5 float
0 0 0
1 0 0
0 1 0
0 0 1
1 1 1
CELLS 3 14
4 0 1 2 3
3 0 1 2
4 1 2 3 4
CELL_TYPES 3
10
5
10
"""
DOLFIN = """<?xml version="1.0"?>
<dolfin>
  <mesh celltype="tetrahedron" dim="3">
    <vertices size="4">
      <vertex index="0" x="0" y="0" z="0"/>
      <vertex index="1" x="1" y="0" z="0"/>
      <vertex index="2" x="0" y="1" z="0"/>
      <vertex index="3" x="0" y="0" z="1"/>
    </vertices>
    <cells size="1">
      <tetrahedron index="0" v0="0" v1="1" v2="2" v3="3"/>
    </cells>
  </mesh>
</dolfin>
"""


def _write_stl(tmp_path):
    V0, V1, V2 = _cube()
    binary = tmp_path / "cube.stl"
    with open(binary, "wb") as f:
        f.write(b"\0" * 80)
        f.write(struct.pack("<I", V0.shape[0]))
        for a, b, c in zip(V0, V1, V2):
            f.write(struct.pack("<12fH", 0, 0, 0, *a, *b, *c, 0))
    ascii_ = tmp_path / "cube_ascii.stl"
    lines = ["solid cube"]
    for a, b, c in zip(V0, V1, V2):
        lines += ["facet normal 0 0 0", " outer loop"]
        lines += ["  vertex " + " ".join(repr(float(v)) for v in p)
                  for p in (a, b, c)]
        lines += [" endloop", "endfacet"]
    ascii_.write_text("\n".join(lines + ["endsolid cube"]) + "\n")
    # a binary file that starts with "solid" (the readers fall back)
    tricky = tmp_path / "solid_binary.stl"
    tricky.write_bytes(b"solid" + binary.read_bytes()[5:])
    return binary, ascii_, tricky


@pytest.mark.parametrize("kind", ["stl_binary", "stl_ascii",
                                  "stl_binary_named_solid", "stl_demo",
                                  "tet_vtk", "dolfin", "dolfin_demo"])
def test_readers_match_jax_bitwise(kind, tmp_path):
    binary, ascii_, tricky = _write_stl(tmp_path)
    (tmp_path / "m.vtk").write_text(TET_VTK)
    (tmp_path / "m.xml").write_text(DOLFIN)
    src = {"stl_binary": ("read_stl", binary),
           "stl_ascii": ("read_stl", ascii_),
           "stl_binary_named_solid": ("read_stl", tricky),
           "stl_demo": ("read_stl", f"{demos.DEMO_DIR}/geometry/stl/blob.stl"),
           "tet_vtk": ("read_tet_vtk", tmp_path / "m.vtk"),
           "dolfin": ("read_tet_dolfin", tmp_path / "m.xml"),
           "dolfin_demo": ("read_tet_dolfin",
                           f"{demos.DEMO_DIR}/geometry/tetmesh/plus.xml")}
    fn, path = src[kind]
    want = getattr(jmesh, fn)(str(path))
    got = getattr(mesh, fn)(str(path))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    if kind == "tet_vtk":
        assert got[1].tolist() == [[0, 1, 2, 3], [1, 2, 3, 4]]


def _primitives(P):
    """The mesh primitives of each kind, made by the module P."""
    V0, V1, V2 = _cube()
    pts, tets = jmesh.read_tet_dolfin(
        f"{demos.DEMO_DIR}/geometry/tetmesh/plus.xml")
    pts = pts * np.array([1.0, 1.0, 0.1]) + np.array([0.0, 0.0, 0.45])
    B0, B1, B2 = jmesh.read_stl(f"{demos.DEMO_DIR}/geometry/stl/blob.stl")
    return {
        "triangle": [P.Triangle(v0=np.array([0.1, 0.2, 0.3]),
                                v1=np.array([0.8, 0.3, 0.4]),
                                v2=np.array([0.4, 0.9, 0.6]), material=1,
                                fiber_id=1)],
        "tetrahedron": [P.Tetrahedron(
            verts=np.array([[0.1, 0.1, 0.2], [0.9, 0.15, 0.1],
                            [0.5, 0.85, 0.2], [0.45, 0.4, 0.9]]),
            material=1, fiber_id=2)],
        "tet_mesh": [P.TetMesh(points=pts, tets=tets, material=1,
                               fiber_id=3)],
        "surface_filled": [P.TriangleSurface(V0=V0, V1=V1, V2=V2, fill=True,
                                             material=1, fiber_id=4)],
        "surface_open": [P.TriangleSurface(V0=B0[:400], V1=B1[:400],
                                           V2=B2[:400], fill=False,
                                           material=1, fiber_id=5)],
        "blob_filled": [P.TriangleSurface(V0=B0, V1=B1, V2=B2, fill=True,
                                          material=1, fiber_id=6)],
        "mixed": [P.Triangle(v0=np.array([0.05, 0.6, 0.1]),
                             v1=np.array([0.5, 0.95, 0.2]),
                             v2=np.array([0.2, 0.7, 0.9]), material=1,
                             fiber_id=7),
                  P.Tetrahedron(verts=np.array([[0.5, 0.1, 0.1],
                                                [0.95, 0.1, 0.2],
                                                [0.7, 0.5, 0.1],
                                                [0.7, 0.3, 0.6]]),
                                material=1, fiber_id=8),
                  P.TriangleSurface(V0=V0 * 0.5, V1=V1 * 0.5, V2=V2 * 0.5,
                                    material=1, fiber_id=9)],
    }


def _brute(p, a, b, c, n=400):
    """The distance of the point p to the triangle abc on an n x n
    sampling of it."""
    u = np.linspace(0.0, 1.0, n)
    U, W = np.meshgrid(u, u)
    m = U + W <= 1
    q = a + U[m, None] * (b - a) + W[m, None] * (c - a)
    return np.sqrt(((q - p) ** 2).sum(1)).min()


def test_triangle_distance_is_exact_where_the_jax_copy_is_short():
    """The host triangle distance against a dense sampling and the
    voxelizer's arithmetic; the JAX package's copy clamps its barycentric
    coordinates one by one and comes out short where the clamped point
    leaves the triangle (ROADMAP.md, Queue 3), never long."""
    rng = np.random.default_rng(0)
    p = rng.random((60, 3)) * 2 - 0.5
    a, b, c = rng.random((3, 3))
    got = primitives._np_point_triangle(p, a, b, c)
    want = jprim._np_point_triangle(p, a, b, c)
    brute = np.array([_brute(x, a, b, c) for x in p])
    assert np.all(got <= brute + 1e-12) and np.all(brute - got < 5e-3)
    np.testing.assert_allclose(got, _tri_distance(p, [[a, b, c]])[0],
                               rtol=0, atol=TOL)
    assert np.all(want <= got + TOL)
    short = want < got - 1e-6
    assert short.any() and not np.any(brute[short] - want[short] < 1e-6)
    np.testing.assert_allclose(want[~short], got[~short], rtol=0, atol=TOL)


def test_primitive_distance_volume_bbox_match_jax():
    """The tetrahedra's, tet meshes' and points' distances within 1e-12 of
    the JAX package's; the triangles' and surfaces' within 1e-12 of the
    voxelizer's arithmetic (the JAX package's host copy is short, see
    above), and never more than it; volumes, boxes, translations."""
    pts = np.random.default_rng(0).random((200, 3)) * 1.4 - 0.2
    want, got = _primitives(jprim), _primitives(primitives)
    for k in want:
        for w, g in zip(want[k], got[k]):
            if isinstance(g, primitives.Triangle):
                exact = _tri_distance(pts, [[g.v0, g.v1, g.v2]])[0]
            elif isinstance(g, primitives.TriangleSurface):
                D = _tri_distance(pts, np.stack([g.V0, g.V1, g.V2], 1))
                exact = D.min(0)
                if g.fill:
                    i = D.argmin(0)
                    s = np.sign(np.einsum("ij,ij->i", pts - g.V0[i],
                                          g.normals[i]))
                    exact = exact * np.where(s == 0, 1.0, s)
            else:
                exact = w.distance(pts)
            np.testing.assert_allclose(g.distance(pts), exact, rtol=0,
                                       atol=TOL, err_msg=k)
            assert np.all(np.abs(w.distance(pts)) <= np.abs(exact) + TOL)
            assert g.volume() == w.volume(), k
            for a, b in zip(g.bbox(), w.bbox()):
                np.testing.assert_array_equal(a, b)
            t = np.array([0.1, -0.2, 0.3])
            np.testing.assert_allclose(g.translated(t).distance(pts + t),
                                       g.distance(pts), rtol=0, atol=TOL,
                                       err_msg=k)
    p = primitives.Point(center=np.array([0.5, 0.5, 0.5]))
    q = jprim.Point(center=np.array([0.5, 0.5, 0.5]))
    np.testing.assert_allclose(p.distance(pts), q.distance(pts), rtol=0,
                               atol=TOL)
    assert p.volume() == 0.0 and p.translated([1, 0, 0]).center[0] == 1.5
    tet = got["tetrahedron"][0]
    assert len(tet._faces) == 4
    assert abs(got["tet_mesh"][0].volume() - want["tet_mesh"][0].volume()) \
        < 1e-15


SHAPES = {"triangle": (12, 10, 9), "tetrahedron": (12, 10, 9),
          "tet_mesh": (16, 16, 6), "surface_filled": (11, 12, 10),
          "surface_open": (10, 9, 11), "blob_filled": (10, 10, 10),
          "mixed": (13, 11, 9)}


def _centres(grid, ss=1):
    """The (supersampled) voxel centres, (nx ss, ny ss, nz ss, 3)."""
    ax = [o + (np.arange(n * ss) + 0.5) * (d / (n * ss))
          for n, d, o in zip(grid.shape, (grid.dx, grid.dy, grid.dz),
                             grid.x0)]
    return np.stack(np.meshgrid(*ax, indexing="ij"), -1)


def _tri_distance(p, V):
    """(n, m) distances of the points p (m, 3) to the triangles V (n, 3, 3),
    by the voxelizer's arithmetic (discretize._tri_dn)."""
    c = [torch.as_tensor(p[:, k]).reshape(1, -1, 1, 1) for k in range(3)]
    V = torch.as_tensor(np.asarray(V, dtype=np.float64))
    v = [[V[:, i, k].reshape(-1, 1, 1, 1) for k in range(3)]
         for i in range(3)]
    return discretize._tri_dn(*c, *v)[0].reshape(V.shape[0], -1).numpy()


def _entries(fibers, p, whole_surfaces, tol, chunk=64):
    """Chunks of candidates of _closest at the points p: (metrics (c, m),
    normals (c, 3), fibre ids (c,)); then (None, the points where a
    tetrahedron's largest face planes tie, None)."""
    tets = [f for f in fibers if isinstance(f, primitives.Tetrahedron)]
    for f in fibers:
        if isinstance(f, primitives.TetMesh):
            tets += [primitives.Tetrahedron(verts=f.points[t],
                                            fiber_id=f.fiber_id)
                     for t in f.tets]
    face_tie = np.zeros(p.shape[0], bool)
    for c0 in range(0, len(tets), chunk // 4):
        ts = tets[c0:c0 + chunk // 4]
        N = np.stack([np.stack([pl[0] for pl in t._faces]) for t in ts])
        off = np.stack([[pl[0] @ pl[1] for pl in t._faces] for t in ts])
        P = np.einsum("tkc,mc->tkm", N, p) - off[..., None]   # (t, 4, m)
        d = P.max(1, keepdims=True)
        on = P >= d - tol
        face_tie |= (on.sum(1) > 1).any(0)
        yield (np.where(on, d, np.inf).reshape(-1, p.shape[0]),
               N.reshape(-1, 3), np.repeat([t.fiber_id for t in ts], 4))
    for f in fibers:
        if isinstance(f, primitives.Triangle):
            yield (_tri_distance(p, [[f.v0, f.v1, f.v2]]),
                   f.orientation()[None], np.array([f.fiber_id]))
        if isinstance(f, primitives.TriangleSurface):
            D = _tri_distance(p, np.stack([f.V0, f.V1, f.V2], 1))
            du, i = D.min(0), D.argmin(0)
            s = np.sign(np.einsum("ij,ij->i", p - f.V0[i], f.normals[i]))
            val = du * np.where(s == 0, 1.0, s) if f.fill else du
            for c0 in range(0, D.shape[0], chunk):
                Dc = D[c0:c0 + chunk]
                if whole_surfaces:
                    Dc = np.where(Dc <= du + tol * np.maximum(1.0, du), val,
                                  np.inf)
                yield (Dc, f.normals[c0:c0 + chunk],
                       np.full(Dc.shape[0], f.fiber_id))
    yield None, face_tie, None


def _closest(fibers, p, whole_surfaces, normals=(), tol=1e-12):
    """The voxelizer's choice of the closest mesh primitive at the points
    p (m, 3), by its arithmetic: a tetrahedron by its largest face plane
    (the face's normal), a thin triangle by its distance, a surface by
    each triangle's distance (``whole_surfaces`` False, as phi takes it)
    or by the distance of its closest triangle, signed by that triangle's
    side when filled (as the geometry fields take it).  Returns the (m,)
    distances, whether the choice is tied within ``tol`` between two
    normals (or two faces of a tetrahedron), for each (m, 3) field of
    ``normals`` the (m,) distance to the nearest tied candidate's normal,
    and the (m,) fibre id of the first closest."""
    m = p.shape[0]
    dmin = np.full(m, np.inf)
    fid = np.full(m, -1)
    for v, n, ids in _entries(fibers, p, whole_surfaces, tol):
        if v is not None:
            vm, i = v.min(0), v.argmin(0)
            fid = np.where(vm < dmin, ids[i], fid)
            dmin = np.minimum(dmin, vm)
    lim = dmin + tol * np.maximum(1.0, np.abs(dmin))
    lo, hi = np.full((m, 3), np.inf), np.full((m, 3), -np.inf)
    gaps = [np.full(m, np.inf) for _ in normals]
    for v, n, _ in _entries(fibers, p, whole_surfaces, tol):
        if v is None:
            face_tie = n
            continue
        c = (v <= lim)[..., None]                           # (c, m, 1)
        lo = np.minimum(lo, np.where(c, n[:, None], np.inf).min(0))
        hi = np.maximum(hi, np.where(c, n[:, None], -np.inf).max(0))
        for k, g in enumerate(normals):
            gap = np.abs(g[None] - n[:, None]).max(-1)
            gaps[k] = np.minimum(gaps[k], np.where(c[..., 0], gap,
                                                   np.inf).min(0))
    tied = ((hi - lo).max(1) > tol) | face_tie
    return dmin, tied, gaps, fid


def _check_phi(got, want, fibers, grid, ss=2):
    """phi within TOL but at voxels holding a supersampled point where the
    closest primitive is tied (see the module docstring); there within
    the tied points' share of the voxel."""
    _, tied, _, _ = _closest(fibers, _centres(grid, ss).reshape(-1, 3),
                             False)
    n_tied = tied.reshape(grid.nx, ss, grid.ny, ss, grid.nz, ss).sum(
        (1, 3, 5))
    diff = np.abs(got - want)
    assert diff[n_tied == 0].max(initial=0.0) <= TOL
    assert np.all(diff <= n_tied / ss ** 3 + TOL)


def _check_fields(gb, ga, fibers, grid):
    """The geometry fields against the voxelizer's choice (_closest): the
    distance within TOL, the normal and orientation that of the closest
    primitive, at a tie one of the tied ones', the id that of the
    closest.  Without a filled surface they match the JAX package's
    fields too, within TOL (ids equal) but at the ties."""
    dmin, tied, gaps, fid = _closest(
        fibers, _centres(grid).reshape(-1, 3), True,
        [gb[k].numpy().reshape(3, -1).T for k in ("normals", "orientation")])
    assert max(g.max() for g in gaps) <= TOL
    np.testing.assert_allclose(gb["distance"].numpy().reshape(-1), dmin,
                               rtol=0, atol=TOL)
    np.testing.assert_array_equal(gb["fiber_id"].numpy().reshape(-1)[~tied],
                                  fid[~tied])
    if any(getattr(f, "fill", False) for f in fibers):
        return
    tied = tied.reshape(grid.shape)
    for k, w in ga.items():
        w, g = np.asarray(w), gb[k].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, k
        ok = ~tied if g.ndim == 3 else ~tied[None].repeat(3, 0)
        np.testing.assert_allclose(g[ok], w[ok], rtol=0, atol=TOL,
                                   err_msg=k)


def test_filled_surface_distance_is_signed_by_the_closest_triangle():
    """A filled surface's distance field: minus the distance to the nearest
    face inside the cube, plus it outside (the JAX package reports the
    least signed distance over the triangles: the far face's inside, and
    a negative one outside beyond a face; ROADMAP.md, Queue 3)."""
    V0, V1, V2 = _cube()
    g = ft.Grid(10, 10, 10)
    got = discretize.geometry_fields(
        g, [primitives.TriangleSurface(V0=V0, V1=V1, V2=V2)], torch.float64,
        "cpu")["distance"]
    want = jdisc.geometry_fields(
        fg.Grid(10, 10, 10), [jprim.TriangleSurface(V0=V0, V1=V1, V2=V2)],
        jnp.float64)["distance"]
    assert abs(float(got[3, 5, 5]) + 0.05) < TOL     # x = 0.35, inside
    assert abs(float(got[0, 5, 5]) - 0.25) < TOL     # x = 0.05, outside
    assert abs(float(want[3, 5, 5]) + 0.35) < TOL
    assert abs(float(want[0, 5, 5]) + 0.65) < TOL


@pytest.mark.parametrize("kind", list(SHAPES))
def test_mesh_phi_and_geometry_fields_match_jax(kind):
    shape = SHAPES[kind]
    want, got = _primitives(jprim)[kind], _primitives(primitives)[kind]
    a = np.asarray(jdisc.phi_field(fg.Grid(*shape), want, 2, jnp.float64))
    b = discretize.phi_field(ft.Grid(*shape), got, 2, torch.float64, "cpu")
    _check_phi(b.numpy(), a, got, ft.Grid(*shape))
    assert a.max() > 0.1          # the primitive reaches the grid
    ga = jdisc.geometry_fields(fg.Grid(*shape), want, jnp.float64)
    gb = discretize.geometry_fields(ft.Grid(*shape), got, torch.float64,
                                    "cpu")
    _check_fields(gb, ga, got, ft.Grid(*shape))


def test_mesh_groups_are_exact(monkeypatch):
    """Any group size gives the same fields as one primitive a group."""
    fib = _primitives(primitives)["tet_mesh"] + \
        _primitives(primitives)["surface_open"]
    g = ft.Grid(8, 8, 6)
    out = []
    for budget in (1, 2 ** 18):
        monkeypatch.setitem(discretize.MESH_VOXELS, "cpu", budget)
        out.append((discretize.phi_field(g, fib, 2, torch.float64, "cpu"),
                    discretize.geometry_fields(g, fib, torch.float64,
                                               "cpu")))
    assert torch.equal(out[0][0], out[1][0])
    for k in out[0][1]:
        assert torch.equal(out[0][1][k], out[1][1][k]), k


def test_tetrahedron_and_surface_volumes():
    """tests/test_mesh.py's volume oracles on the port's voxelizer."""
    g = ft.Grid(24, 24, 24)
    tet = primitives.Tetrahedron(verts=np.array(
        [[0.2, 0.2, 0.2], [0.8, 0.2, 0.2], [0.2, 0.8, 0.2],
         [0.2, 0.2, 0.8]]))
    v = float(discretize.phi_field(g, [tet], 2, torch.float64, "cpu").mean())
    assert abs(v - tet.volume()) / tet.volume() < 0.05
    V0, V1, V2 = _cube()
    cube = primitives.TriangleSurface(V0=V0, V1=V1, V2=V2)
    v = float(discretize.phi_field(g, [cube], 2, torch.float64, "cpu").mean())
    assert abs(v - 0.064) < 0.005 and abs(cube.volume() - 0.064) < 1e-12


def _capsule_phi(grid_args, fibers):
    return np.asarray(jdisc.phi_field(fg.Grid(*grid_args), fibers, 1,
                                      jnp.float64))


def _same_fibres(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.fiber_id, g.material) == (w.fiber_id, w.material)
        for k in ("center", "axis"):
            np.testing.assert_array_equal(getattr(g, k), getattr(w, k))
        assert (g.length, g.radius) == (w.length, w.radius)


def test_detect_fibers_matches_jax_on_the_capsule():
    from fibergen_tpu.geometry.detect import detect_fibers as jdetect
    from fibergen_tpu_torch.geometry.detect import (detect_fibers,
                                                    orientation_moment)
    truth = jprim.Capsule(center=np.array([0.5, 0.5, 0.5]),
                          axis=np.array([1.0, 0, 0]), length=0.4,
                          radius=0.08)
    phi = _capsule_phi((32, 32, 32), [truth])
    want = jdetect(phi, fg.Grid(32, 32, 32), threshold=0.5)
    got = detect_fibers(phi, ft.Grid(32, 32, 32), threshold=0.5)
    _same_fibres(got, want)
    assert abs(got[0].radius - 0.08) < 0.03
    from fibergen_tpu.geometry.detect import orientation_moment as jom
    np.testing.assert_array_equal(orientation_moment(got), jom(want))


def test_detect_fibers_matches_jax_on_the_rsa_phantom():
    """tests/test_detect.py's RSA phantom (30 trials, the interior fibres,
    96^3): the same fibre list from the same phase field."""
    from fibergen_tpu.geometry.detect import detect_fibers as jdetect
    from fibergen_tpu.geometry.generator import (FiberGenerator,
                                                 GeneratorSettings)
    from fibergen_tpu_torch.geometry.detect import detect_fibers
    s = GeneratorSettings(seed=3, length=0.25, radius=0.035, dmin=0.02,
                          periodic_x=False, periodic_y=False,
                          periodic_z=False)
    gen = FiberGenerator(s)
    gen.run(N=30, M=60000)

    def inside(f):
        for sgn in (-1, 1):
            end = (np.asarray(f.center)
                   + sgn * 0.5 * f.length * np.asarray(f.axis))
            if np.any(end - f.radius < 0.01) or np.any(end + f.radius > 0.99):
                return False
        return True

    kept = [f for f in gen.fibers if inside(f)]
    assert len(kept) >= 5
    for f in kept:
        f.material = 1
    grid = fg.Grid(96, 96, 96)
    phi = np.asarray(jdisc.voxelize(grid, kept, 2)[1])
    want = jdetect(phi, grid, threshold=0.5)
    got = detect_fibers(phi, ft.Grid(96, 96, 96), threshold=0.5)
    _same_fibres(got, want)
    assert len(got) == len(kept)


DETECT_XML = """<settings>
  <solver n="24">
    <mode>heat</mode>
    <materials><matrix mu="1" /><fiber mu="10" /></materials>
  </solver>
  <actions>
    <select_material name="fiber" />
    <place_fiber L="0.4" R="0.08" cx="0.5" cy="0.5" cz="0.5"
                 ax="0" ay="1" az="0" />
    <init_phase />
    <detect_fibers filename="detected.txt" overwrite_phase="1" />
  </actions>
</settings>"""


def test_detect_fibers_action_matches_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = {}
    for F, kw in ((fg.FG, {}), (ft.FG, {"device": "cpu"})):
        f = F(**kw)
        f.set_xml(DETECT_XML)
        assert f.run() == 0
        out[F] = (f, (tmp_path / "detected.txt").read_text())
    (a, ta), (b, tb) = out[fg.FG], out[ft.FG]
    assert tb == ta and len(tb.splitlines()) >= 2
    assert len(b.gen.fibers) == len(a.gen.fibers) == 2
    np.testing.assert_allclose(b.get_field("phi"),
                               np.asarray(a.get_field("phi")), rtol=0,
                               atol=TOL)
    np.testing.assert_array_equal(b.get_A2(), a.get_A2())


PLACE_XML = """<settings>
  <solver n="12">
    <mode>heat</mode><tol>1e-8</tol>
    <materials><matrix mu="1" /><solid mu="5" /></materials>
  </solver>
  <actions>
    <select_material name="solid" />
    {place}
    <run_load_case e1="1" />
  </actions>
</settings>"""


@pytest.mark.parametrize("action", ["place_triangle", "place_tetrahedron",
                                    "place_stl", "place_stl_open",
                                    "place_tetvtk", "place_tetdolfin"])
def test_place_actions_match_jax(action, tmp_path):
    binary, _, _ = _write_stl(tmp_path)
    (tmp_path / "m.vtk").write_text(TET_VTK.replace("1 1 1", "0.9 0.8 0.7"))
    (tmp_path / "m.xml").write_text(DOLFIN)
    place = {
        "place_triangle": '<place_triangle p1x="0.1" p1y="0.2" p1z="0.3" '
                          'p2x="0.8" p2y="0.3" p2z="0.4" p3x="0.4" '
                          'p3y="0.9" p3z="0.6" />',
        "place_tetrahedron": '<place_tetrahedron p1x="0.2" p1y="0.2" '
                             'p1z="0.2" p2x="0.8" p2y="0.2" p2z="0.2" '
                             'p3x="0.2" p3y="0.8" p3z="0.2" p4x="0.2" '
                             'p4y="0.2" p4z="0.8" />',
        "place_stl": '<place_stl filename="cube.stl" />',
        "place_stl_open": '<place_stl filename="cube.stl" fill="0" />',
        "place_tetvtk": '<place_tetvtk filename="m.vtk" />',
        "place_tetdolfin": '<place_tetdolfin filename="m.xml" />'}[action]
    (tmp_path / "p.xml").write_text(PLACE_XML.format(place=place))
    a = fg.FG(str(tmp_path / "p.xml"))
    b = ft.FG(str(tmp_path / "p.xml"), device="cpu")
    assert a.run() == 0 and b.run() == 0
    np.testing.assert_allclose(b.get_field("phi"),
                               np.asarray(a.get_field("phi")), rtol=0,
                               atol=TOL)
    assert len(b.get_residuals()) == len(a.get_residuals())
    assert demos.rel(b.get_mean_stress(), a.get_mean_stress()) <= 1e-10
    assert b.get_distance_evals() == a.get_distance_evals() > 0
    assert [type(f).__name__ for f in b.gen.all_fibers()] == \
        [type(f).__name__ for f in a.gen.all_fibers()]
