"""The benchmark's fibre-mat configuration (``planar-fibres-heat-4096``) on
the CPU: its geometry (``fgbench/geometry/planar_fibres.py``) against the
port's voxelizer and a one-by-one adsorption, its reference
(``fgbench/reference/heat-laminate.py``) against the port's float64
``run_batched`` under the laminate rule, and a whole run of the cell cut
to the demo's own 128 x 128 x 1 with its output check and control."""
import json
import math
import subprocess
import sys

import numpy as np
import pytest
import torch

import fibergen_tpu_torch as ft
from fgbench.harness import check, manifest, problem
from fgbench.tools import control
from fibergen_tpu_torch.core.grid import Grid
from fibergen_tpu_torch.geometry import discretize
from fibergen_tpu_torch.geometry.primitives import Cylinder
from fibergen_tpu_torch.utils.logging import LOG

CONFIG = manifest.load_json(manifest.ROOT / "fgbench/configs/"
                            "planar-fibres-heat-4096.json")
DEMO = (128, 128, 1)
SEED = 2 ** 31 + 11
geometry = manifest.plugin("geometry", "planar_fibres")


@pytest.fixture(autouse=True)
def _quiet():
    old = LOG.enabled
    LOG.enabled = False
    yield
    LOG.enabled = old


def _images(fib, shape, keep):
    """The port's cylinders of the fibres ``keep``, each with its periodic
    images in x and y that reach into the cell."""
    out = []
    for i in keep:
        c, a, L = fib.centre[i], fib.axis[i], fib.length[i]
        ext = np.abs(a[:2]) * 0.5 * L + fib.radius + 1.0
        for tx in (-shape[0], 0, shape[0]):
            for ty in (-shape[1], 0, shape[1]):
                lo = c[:2] + (tx, ty) - ext
                hi = c[:2] + (tx, ty) + ext
                if np.all(hi > 0) and np.all(lo < shape[:2]):
                    out.append(Cylinder(center=c + (tx, ty, 0.0), axis=a,
                                        length=L, radius=fib.radius,
                                        material=1))
    return out


def test_fields_match_the_port_voxelizer():
    """Fraction (one level of refinement, summed and clamped) and the
    nearest fibre's normal on the interface voxels, against
    ``geometry.discretize`` for the same cylinders, to 1e-6: the fibres
    whose centres lie in a third of the demo's cell, close pairs among
    them."""
    fib = problem.draw(CONFIG, problem.rng_of(SEED), DEMO)
    keep = np.flatnonzero(fib.centre[:, 0] < 48)
    sub = geometry.Fibres(fib.centre[keep], fib.axis[keep],
                          fib.length[keep], fib.radius, fib.attempts)
    got = geometry.fields(CONFIG, sub, DEMO, "cpu", torch.float64)
    grid = Grid(*DEMO, dx=DEMO[0], dy=DEMO[1], dz=DEMO[2])
    cyl = _images(fib, DEMO, keep)
    phi = discretize.voxelize(grid, cyl, 2, 0, supersample=2,
                              dtype=torch.float64)[1]
    normals = discretize.geometry_fields(grid, cyl,
                                         dtype=torch.float64)["normals"]
    assert float((got.phi - phi).abs().max()) <= 1e-6
    iface = (phi > 0) & (phi < 1)
    assert int(iface.sum()) > 500
    assert float((got.normals - normals)[:, iface].abs().max()) <= 1e-6
    norm = got.normals[:, iface].norm(dim=0)
    assert float((norm - 1).abs().max()) <= 1e-12


def _clearance(fib, shape):
    """The least surface distance of the bounding capsules over every pair
    of fibres and every periodic image, by brute force."""
    P = fib.centre[:, :2] - 0.5 * fib.length[:, None] * fib.axis[:, :2]
    Q = fib.centre[:, :2] + 0.5 * fib.length[:, None] * fib.axis[:, :2]

    def pt_seg(p, a, b):
        u = b - a
        t = np.clip(((p - a) * u).sum(-1) / (u * u).sum(-1), 0, 1)
        return np.linalg.norm(p - a - t[..., None] * u, axis=-1)

    best = np.inf
    n = len(P)
    i, j = np.triu_indices(n, 1)
    for tx in (-shape[0], 0, shape[0]):
        for ty in (-shape[1], 0, shape[1]):
            t = np.array([tx, ty])
            d = np.minimum.reduce([pt_seg(P[i], P[j] + t, Q[j] + t),
                                   pt_seg(Q[i], P[j] + t, Q[j] + t),
                                   pt_seg(P[j] + t, P[i], Q[i]),
                                   pt_seg(Q[j] + t, P[i], Q[i])])
            best = min(best, float(d.min()))
    return best - 2 * fib.radius


def _seg_seg(p1, q1, p2, q2):
    """Distances between the segment p1 q1 and each segment p2 q2 (rows)
    in the plane: zero where they cross, else the least end-to-segment
    distance."""
    def pt_seg(p, a, b):
        u = b - a
        t = np.clip(((p - a) * u).sum(-1) / (u * u).sum(-1), 0, 1)
        return np.linalg.norm(p - a - t[..., None] * u, axis=-1)

    def side(a, b, c):
        return np.sign((b[..., 0] - a[..., 0]) * (c[..., 1] - a[..., 1])
                       - (b[..., 1] - a[..., 1]) * (c[..., 0] - a[..., 0]))
    cross = (side(p1, q1, p2) * side(p1, q1, q2) < 0) & \
        (side(p2, q2, p1) * side(p2, q2, q1) < 0)
    d = np.minimum.reduce([pt_seg(p2, p1, q1), pt_seg(q2, p1, q1),
                           pt_seg(p1, p2, q2), pt_seg(q1, p2, q2)])
    return np.where(cross, 0.0, d)


def _one_by_one(config, seed, shape):
    """Random sequential adsorption one candidate at a time from the same
    stream of uniforms, each tested against every image of every fibre
    accepted before it."""
    p = geometry._params(config, shape)
    rng = problem.rng_of(seed)
    P, Q, acc, attempts = [], [], [], 0
    clear = 2 * p["R"] + p["dmin"]
    r = [math.ceil((p["hi"] + clear) / shape[a]) for a in range(2)]
    shifts = [np.array([i * shape[0], j * shape[1]])
              for i in range(-r[0], r[0] + 1)
              for j in range(-r[1], r[1] + 1)]
    while len(acc) < p["n"] and attempts < p["cap"]:
        u = rng.random(4)
        attempts += 1
        c = u[:2] * shape[:2]
        a = np.array([math.cos(2 * math.pi * u[2]),
                      math.sin(2 * math.pi * u[2])])
        L = p["lo"] + (p["hi"] - p["lo"]) * u[3]
        p1, q1 = c - 0.5 * L * a, c + 0.5 * L * a
        if min(float(_seg_seg(p1, q1, np.array(P + [p1]) + t,
                              np.array(Q + [q1]) + t)[:-1 if t.any()
                                                       else len(P)].min(
                                                           initial=np.inf))
               for t in shifts) < clear:
            continue
        P.append(p1)
        Q.append(q1)
        acc.append((c, a, L))
    return acc, attempts


@pytest.mark.parametrize("shape,n", [(DEMO, 30), ((48, 40, 1), 12),
                                     ((16, 16, 16), 3)])
def test_draw_is_the_one_by_one_adsorption(shape, n):
    """The block-parallel draw accepts what a one-by-one process accepts,
    in its order, from the same uniforms, on the demo's cell and on cells
    smaller than a fibre, where a fibre meets its own images."""
    small = json.loads(json.dumps(CONFIG))
    small["inclusion"]["fibres_per_tile"] = n * 128 * 128 / (shape[0]
                                                            * shape[1])
    fib = problem.draw(small, problem.rng_of(SEED), shape)
    acc, attempts = _one_by_one(small, SEED, shape)
    assert len(fib.length) == len(acc) and fib.attempts == attempts
    assert len(acc) == n or attempts == geometry._params(small, shape)["cap"]
    assert len(acc) >= 2
    assert np.all(fib.centre[:, 2] == 0.5 * shape[2])
    assert np.array_equal(fib.centre[:, :2], np.array([c for c, _, _ in acc]))
    assert np.array_equal(fib.axis[:, :2], np.array([a for _, a, _ in acc]))
    assert np.array_equal(fib.length, np.array([L for _, _, L in acc]))


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 11, 2 ** 33 + 5])
def test_draws_keep_dmin_and_the_demo_counts(seed):
    fib = problem.draw(CONFIG, problem.rng_of(seed), DEMO)
    again = problem.draw(CONFIG, problem.rng_of(seed), DEMO)
    assert len(fib.length) == 100 and fib.radius == 1.28
    assert np.array_equal(fib.centre, again.centre)
    assert np.all(fib.centre[:, 2] == 0.5) and np.all(fib.axis[:, 2] == 0)
    assert np.all((fib.centre[:, :2] >= 0) & (fib.centre[:, :2] < 128))
    assert np.all((fib.length >= 2.56) & (fib.length <= 51.2))
    assert np.allclose(np.linalg.norm(fib.axis, axis=1), 1, atol=1e-14)
    assert _clearance(fib, DEMO) >= 0.5


def test_draws_distributions():
    """Over 20 seeds of the demo: the axes uniform in the plane (the
    second circular moments of the doubled angle near 0), the centres
    uniform over the cell, the lengths spread over their range and
    shortened by the adsorption (long candidates are rejected more)."""
    ang, cen, lens = [], [], []
    for seed in range(20):
        fib = problem.draw(CONFIG, problem.rng_of(1000 + seed), DEMO)
        ang.append(np.arctan2(fib.axis[:, 1], fib.axis[:, 0]))
        cen.append(fib.centre[:, :2] / 128.0)
        lens.append(fib.length)
    ang, cen, lens = (np.concatenate(x) for x in (ang, cen, lens))
    n = len(ang)
    assert abs(np.mean(np.cos(2 * ang))) < 4 / math.sqrt(n)
    assert abs(np.mean(np.sin(2 * ang))) < 4 / math.sqrt(n)
    assert np.all(np.abs(cen.mean(0) - 0.5) < 4 * math.sqrt(1 / 12 / n))
    assert lens.min() < 5 and lens.max() > 45
    assert lens.mean() < 0.5 * (2.56 + 51.2)


def test_attempt_cap_stops_the_draw():
    capped = json.loads(json.dumps(CONFIG))
    capped["inclusion"]["attempts_per_tile"] = 50
    fib = problem.draw(capped, problem.rng_of(SEED), DEMO)
    assert fib.attempts == 50 and 0 < len(fib.length) < 50


def test_fields_wrap_a_fibre_longer_than_the_cell():
    """On a cell narrower than a fibre every image adds its share: the
    fraction is the port voxelizer's for the images, and the fibre's
    area (2 R L at the mid-plane) is conserved."""
    shape = (24, 20, 1)
    fib = geometry.Fibres(np.array([[5.0, 7.0, 0.5]]),
                          np.array([[math.cos(0.3), math.sin(0.3), 0.0]]),
                          np.array([40.0]), 1.28, 1)
    got = geometry.fields(CONFIG, fib, shape, "cpu", torch.float64)
    grid = Grid(*shape, dx=shape[0], dy=shape[1], dz=shape[2])
    cyl = [Cylinder(center=fib.centre[0] + (i * 24, j * 20, 0),
                    axis=fib.axis[0], length=40.0, radius=1.28, material=1)
           for i in (-2, -1, 0, 1, 2) for j in (-2, -1, 0, 1, 2)]
    phi = discretize.voxelize(grid, cyl, 2, 0, supersample=2,
                              dtype=torch.float64)[1]
    assert float((got.phi - phi).abs().max()) <= 1e-6


def _solid_geometry(shape, rng):
    """A smoothed sphere's (or, one voxel thick, disc's) fraction and
    random unit normals, in the plane where the cell is one voxel thick:
    pure and mixed voxels, normals in any direction."""
    axes = [(np.arange(n) + 0.5) / n - 0.5 for n in shape]
    X, Y, Z = np.meshgrid(*axes, indexing="ij")
    r = np.sqrt(X ** 2 + Y ** 2 + Z ** 2)
    phi = np.clip((0.32 - r) * max(shape[:2]) / 2.5 + 0.5, 0, 1)
    n = rng.standard_normal((3,) + shape)
    if shape[2] == 1:
        n[2] = 0.0
    n /= np.linalg.norm(n, axis=0)
    return geometry.Fields(torch.as_tensor(phi), torch.as_tensor(n))


def _port(geom, shape, loads, estimator):
    mat = manifest.plugin("mixing", "laminate").build(ft, CONFIG, geom, 3)
    s = ft.LSSolver(ft.Grid(*shape), mat, ft.SolverOptions(
        mode="heat", tol=1e-13, dtype="float64", error_estimator=estimator),
        device="cpu")
    assert not s.run_batched(loads)
    return s.calc_mean_stress_batched(), s.eps_batch


@pytest.mark.parametrize("shape", [(12, 10, 8), (24, 20, 1)])
def test_reference_matches_port_float64(shape):
    """The laminate tensor's reference against the port's laminate jump,
    float64 run_batched of the unit gradients, 3-D and one voxel thick, to
    1e-9 in the mean flux and the gradient field.  One voxel thick, the
    in-plane cases take the residual estimator and the out-of-plane one,
    which the start solves, the default: its residual never falls."""
    geom = _solid_geometry(shape, np.random.default_rng(3))
    eye = np.eye(3)
    if shape[2] > 1:
        means, fields = _port(geom, shape, eye, "residual")
    else:
        m2, f2 = _port(geom, shape, eye[:2], "residual")
        mz, fz = _port(geom, shape, eye[2:], "epsilon")
        means, fields = np.concatenate([m2, mz]), torch.cat([f2, fz])
        # no fluctuation out of the plane: the Voigt mean
        assert mz[0][2] == pytest.approx(float(1 + 9 * geom.phi.mean()),
                                         rel=1e-12)
    ref = problem.reference(CONFIG)
    for b in range(3):
        sol = ref.solve(CONFIG, geom, eye[b], tol=1e-13)
        gap = np.linalg.norm(means[b] - sol.mean.numpy()) / np.linalg.norm(
            sol.mean.numpy())
        field = float((fields[b] - sol.field).norm() / sol.field.norm())
        assert gap <= 1e-9 and field <= 1e-9, (b, gap, field)


RUN = """
import json, sys, time
t = time.perf_counter()
sys.path.insert(0, {root!r})
from fgbench.harness import cell
rc, res = cell.execute("planar-fibres-tensor", {seed!r}, 1.0, False,
                       t_process=t, device="cpu", shape=(128, 128, 1))
sys.stderr.flush()
print(json.dumps({{"rc": rc, "result": res}}))
"""


def test_cell_cut_to_the_demo_is_correct_and_its_control_fails():
    """The cell on the demo's own 128 x 128 x 1 (n 100) in a fresh
    interpreter: every case of a 1 s window correct; the reference kept in
    bfloat16 in the program's place fails both limits of the check."""
    p = subprocess.run([sys.executable, "-c", RUN.format(
        root=str(manifest.ROOT), seed=SEED)], cwd=manifest.ROOT,
        capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    res = out["result"]
    assert out["rc"] == 0 and res["correct"], p.stderr[-3000:]
    assert res["attempted"] >= 3 and res["failed"] == 0
    drawn = problem.draw(CONFIG, problem.rng_of(SEED), DEMO)
    geom = problem.fields(CONFIG, drawn, DEMO, "cpu", torch.float64)
    loads = problem.load_cases(CONFIG, {"load_cases": "unit"})
    ref = problem.reference(CONFIG)
    cases = (0, 1, 2)
    means, fields = control.answers(ref, CONFIG, geom, loads, cases,
                                    torch.bfloat16)
    gaps = check.gaps(ref, CONFIG, geom, loads, [(cases, means)], cases,
                      fields)
    limits = check.limits_of(CONFIG)
    assert gaps["stress_gap"] > limits["stress_gap"]
    assert gaps["field_gap"] > limits["field_gap"]
