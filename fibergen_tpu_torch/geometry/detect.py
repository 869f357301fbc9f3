"""Fiber detection from voxel phase data (host numpy and scipy on the phase
field; a copy of fibergen_tpu/geometry/detect.py).

Functional equivalent of the reference's experimental detectFibers
(fibergen.cpp:15776-16621): segment a thresholded phase field into
capsule-like fibers.  Same overall shape as the reference's algorithm —
seed at the strongest interior point, FOLLOW THE RIDGE of the distance map
along the local fiber axis in both directions (the reference's followPath
walks the voxel graph the same way, fibergen.cpp:15776-15806), estimate the
radius from the distance values along the path, then carve the detected
capsule out and repeat.
"""
from __future__ import annotations

from typing import List

import numpy as np
from scipy import ndimage

from .primitives import Capsule

# 26-neighborhood steps, precomputed with unit step directions
_STEPS = np.array([(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1)
                   for k in (-1, 0, 1) if (i, j, k) != (0, 0, 0)])


def _seed_direction(work, idx, r_vox):
    """Initial axis estimate: principal direction of the near-ridge voxels
    in a local box around the seed."""
    lo = np.maximum(np.array(idx) - int(2 * r_vox + 2), 0)
    hi = np.minimum(np.array(idx) + int(2 * r_vox + 2) + 1, work.shape)
    sub = work[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]]
    pts = np.argwhere(sub >= 0.7 * work[idx]) + lo
    if pts.shape[0] < 2:
        return np.array([0.0, 0.0, 1.0])
    c = pts.mean(axis=0)
    _, _, vt = np.linalg.svd(pts - c, full_matrices=False)
    return vt[0] / np.linalg.norm(vt[0])


def _perp_basis(d):
    a = np.array([1.0, 0.0, 0.0]) if abs(d[0]) < 0.9 else np.array([0.0, 1.0, 0.0])
    u = np.cross(d, a)
    u /= np.linalg.norm(u)
    v = np.cross(d, u)
    return u, v


def _march(dist, idx, direction, r_seed, h, momentum=0.7, drop=0.5,
           patience=4, max_steps=None):
    """Predictor-corrector centerline tracing (the reference's followPath
    walks the raw voxel graph, fibergen.cpp:15776-15806; this variant adds
    re-centering so the tracer cannot drift off the medial axis): step one
    voxel along the heading, then hill-climb to the distance maximum in the
    plane perpendicular to the heading, with a few steps of patience across
    the discrete ridge's dips."""
    shape = np.asarray(dist.shape)

    def val(p):
        q = np.clip(np.round(p).astype(int), 0, shape - 1)
        return dist[q[0], q[1], q[2]]

    pos = np.asarray(idx, float)
    d = np.asarray(direction, float)
    path = [pos.copy()]
    good_len = 1
    weak = 0
    offs = [(a, b) for a in (-2, -1, 0, 1, 2) for b in (-2, -1, 0, 1, 2)]
    if max_steps is None:
        max_steps = 4 * int(max(shape))  # longest straight path in the box
    hmin = float(np.min(h))
    for _ in range(max_steps):
        # advance one (smallest) physical voxel along the heading; positions
        # are index-space, so physical directions map through 1/h per axis
        # (anisotropic grids step correctly this way)
        nxt = pos + (d * hmin) / h
        # re-center in the perpendicular plane (two corrector sweeps);
        # offsets are physical, converted to index space per axis
        u, v = _perp_basis(d)
        for _rc in range(2):
            best = nxt
            bestv = val(nxt)
            for a, b in offs:
                cand = nxt + 0.7 * hmin * (a * u + b * v) / h
                cv = val(cand)
                if cv > bestv:
                    bestv, best = cv, cand
            nxt = best
        newd = nxt - pos
        nn = np.linalg.norm(newd)
        # require real forward progress along the heading (re-centering can
        # otherwise stall the tracer in place)
        if nn < 0.3 or (newd / nn) @ d < 0.2:
            break
        d = momentum * d + (1 - momentum) * newd / nn
        d /= np.linalg.norm(d)
        pos = nxt
        path.append(pos.copy())
        if val(pos) < drop * r_seed:
            weak += 1
            if weak > patience:
                break
        else:
            weak = 0
            good_len = len(path)
    shape1 = shape - 1
    return [np.minimum(np.maximum(np.round(p).astype(int), 0), shape1)
            for p in path[:good_len]]


def detect_fibers(phi: np.ndarray, grid, threshold: float = 0.5,
                  min_radius_vox: float = 1.25, max_fibers: int = 10000,
                  material: int = 1) -> List[Capsule]:
    """Detect capsule fibers in a (nx, ny, nz) volume-fraction field.

    Greedy ridge following: seed at the voxel with the largest remaining
    distance-transform value, march the ridge in both directions along the
    local axis, fit a capsule (axis/length from the path endpoints, radius
    from the median ridge distance), carve it out, repeat."""
    phi = np.asarray(phi)
    mask = phi > threshold
    if not mask.any():
        return []
    h = np.asarray(grid.spacing)
    x0 = np.asarray(grid.x0)
    # zero-pad so the domain boundary counts as matrix: without this, a
    # fiber cut by the box face grows a medial SHEET along the face (the
    # EDT sees no zero voxels beyond the array) and the tracer wanders it
    dist = ndimage.distance_transform_edt(
        np.pad(mask, 1), sampling=h)[1:-1, 1:-1, 1:-1]

    work = dist.copy()
    fibers: List[Capsule] = []
    min_r = min_radius_vox * h.min()

    def to_phys(ijk):
        return (np.asarray(ijk) + 0.5) * h + x0

    while len(fibers) < max_fibers:
        idx = np.unravel_index(np.argmax(work), work.shape)
        r_seed = work[idx]
        if r_seed < min_r:
            break
        r_vox = r_seed / h.min()
        d0 = _seed_direction(work, idx, r_vox)
        # march on the ORIGINAL distance map: carving previous fibers out of
        # `work` must not truncate the ridge of the current one
        fwd = _march(dist, idx, d0, r_seed, h)
        bwd = _march(dist, idx, -d0, r_seed, h)
        path = bwd[::-1] + fwd[1:]
        rvals = np.array([dist[tuple(p)] for p in path])
        # the EDT at the axis voxel underestimates the true radius by the
        # voxel-center offset (~half a voxel on average)
        radius = float(np.median(rvals)) + 0.5 * float(h.min())
        # trim the cap overshoot: the tracer's patience walks a few voxels
        # into the end caps where the distance declines below the core value
        core = rvals >= 0.9 * np.median(rvals)
        if core.any():
            i0, i1 = np.argmax(core), len(core) - np.argmax(core[::-1])
            path = path[i0:i1]
        pts = to_phys(np.array(path))

        if len(path) >= 2:
            c = pts.mean(axis=0)
            _, _, vt = np.linalg.svd(pts - c, full_matrices=False)
            axis = vt[0] / np.linalg.norm(vt[0])
            t = (pts - c) @ axis
            # core-segment length; the capsule's caps extend by the radius
            L = float(t.max() - t.min())
            center = c + 0.5 * (t.max() + t.min()) * axis
        else:
            axis = d0
            L = 0.0
            center = to_phys(idx)

        fib = Capsule(center=center, axis=axis, length=L,
                      radius=radius, material=material,
                      fiber_id=len(fibers) + 1)
        fibers.append(fib)

        # carve the detected capsule (with a margin) out of the ridge map
        pad = 2.0 * radius
        lo = np.maximum(np.floor((center - (L / 2 + pad) - x0) / h - 1).astype(int), 0)
        hi = np.minimum(np.ceil((center + (L / 2 + pad) - x0) / h + 1).astype(int),
                        np.asarray(mask.shape))
        xs = [np.arange(lo[k], hi[k]) for k in range(3)]
        if all(len(a) for a in xs):
            X, Y, Z = np.meshgrid(*xs, indexing="ij")
            p = np.stack([(X + 0.5) * h[0] + x0[0],
                          (Y + 0.5) * h[1] + x0[1],
                          (Z + 0.5) * h[2] + x0[2]], axis=-1)
            d = fib.distance(p.reshape(-1, 3)).reshape(X.shape)
            sub = work[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]]
            sub[d < 0.8 * radius] = 0.0
        work[idx] = 0.0

    return fibers


def orientation_moment(fibers: List[Capsule]) -> np.ndarray:
    """Length-weighted second orientation moment A2 of detected fibers
    (matches FiberGenerator::getA2 weighting, fibergen.cpp:6683-6709)."""
    num = np.zeros((3, 3))
    den = 0.0
    for f in fibers:
        a = np.asarray(f.axis, float)
        a /= np.linalg.norm(a)
        w = f.length + 4.0 / 3.0 * f.radius
        num += w * np.outer(a, a)
        den += w
    return num / den if den > 0 else np.eye(3) / 3.0
