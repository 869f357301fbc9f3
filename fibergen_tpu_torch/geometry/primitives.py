"""Geometric fibre primitives (port of fibergen_tpu/geometry/primitives.py,
up to its mesh primitives).

Host-side dataclasses describing the fibres, used by the sequential RSA
generator, and their packing into parameter arrays for the voxelizer
(geometry/discretize.py), which evaluates the primitives of one type for
all voxels at once on the solver's device.  Redesign of the reference's
Fiber class hierarchy (fibergen.cpp:3011-5642).

Conventions: signed distance < 0 inside the fibre; ``axis`` is a unit
vector; the capsule/cylinder length L is that of the core segment (total
capsule length L + 2R).  The mesh primitives (Triangle, Tetrahedron,
TriangleSurface, TetMesh, Point) are not ported yet (ROADMAP.md, Queue 1
item 6).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class Fiber:
    material: int = 0
    fiber_id: int = 0
    # periodic-clone offset relative to the primary fiber (zero for
    # primaries): what the reference reports as 'fiber_translation'
    # (bbCenter() - parent()->bbCenter(), fibergen.cpp:6865-6884).
    # Set by FiberGenerator._make_clones; NOT a dataclass field so the
    # per-primitive constructors stay unchanged.
    translation = None

    def volume(self) -> float:
        raise NotImplementedError

    def orientation(self) -> np.ndarray:
        return np.array([0.0, 0.0, 1.0])

    def distance(self, p: np.ndarray) -> np.ndarray:
        """Signed distance for points p (..., 3) (host, numpy)."""
        raise NotImplementedError

    def translated(self, t) -> "Fiber":
        raise NotImplementedError

    def bbox(self):
        raise NotImplementedError


@dataclasses.dataclass
class Capsule(Fiber):
    """Cylinder with hemispherical caps (CapsuleFiber, fibergen.cpp:5236);
    L = 0 gives a sphere."""

    center: np.ndarray = None
    axis: np.ndarray = None
    length: float = 0.0
    radius: float = 1.0

    def volume(self):
        R, L = self.radius, self.length
        return np.pi * R * R * L + 4.0 / 3.0 * np.pi * R ** 3

    def orientation(self):
        return np.asarray(self.axis, dtype=np.float64)

    def distance(self, p):
        q = np.asarray(p, dtype=np.float64) - self.center
        t = np.clip(q @ self.axis, -0.5 * self.length, 0.5 * self.length)
        d = q - t[..., None] * self.axis
        return np.sqrt((d * d).sum(-1)) - self.radius

    def translated(self, t):
        return Capsule(material=self.material, fiber_id=self.fiber_id,
                       center=self.center + np.asarray(t), axis=self.axis,
                       length=self.length, radius=self.radius)

    def bbox(self):
        h = 0.5 * self.length * np.abs(self.axis) + self.radius
        return self.center - h, self.center + h


@dataclasses.dataclass
class Cylinder(Fiber):
    """Finite cylinder with flat caps (CylindricalFiber, fibergen.cpp:3648)."""

    center: np.ndarray = None
    axis: np.ndarray = None
    length: float = 0.0
    radius: float = 1.0

    def volume(self):
        return np.pi * self.radius ** 2 * self.length

    def orientation(self):
        return np.asarray(self.axis, dtype=np.float64)

    def distance(self, p):
        q = np.asarray(p, dtype=np.float64) - self.center
        t = q @ self.axis
        rad = q - t[..., None] * self.axis
        dr = np.sqrt((rad * rad).sum(-1)) - self.radius
        da = np.abs(t) - 0.5 * self.length
        outside = np.sqrt(np.maximum(dr, 0) ** 2 + np.maximum(da, 0) ** 2)
        inside = np.minimum(np.maximum(dr, da), 0.0)
        return outside + inside

    def translated(self, t):
        return Cylinder(material=self.material, fiber_id=self.fiber_id,
                        center=self.center + np.asarray(t), axis=self.axis,
                        length=self.length, radius=self.radius)

    def bbox(self):
        # loose: treat like capsule bbox
        h = 0.5 * self.length * np.abs(self.axis) + self.radius
        return self.center - h, self.center + h


@dataclasses.dataclass
class HalfSpace(Fiber):
    """Half space n.(x - p) <= 0 (HalfSpaceFiber, fibergen.cpp:5528)."""

    point: np.ndarray = None
    normal: np.ndarray = None

    def volume(self):
        return np.inf

    def orientation(self):
        return np.asarray(self.normal, dtype=np.float64)

    def distance(self, p):
        return (np.asarray(p, dtype=np.float64) - self.point) @ self.normal

    def translated(self, t):
        return HalfSpace(material=self.material, fiber_id=self.fiber_id,
                         point=self.point + np.asarray(t), normal=self.normal)

    def bbox(self):
        inf = np.full(3, np.inf)
        return -inf, inf


def sphere(center, radius, **kw) -> Capsule:
    return Capsule(center=np.asarray(center, dtype=np.float64),
                   axis=np.array([0.0, 0.0, 1.0]), length=0.0,
                   radius=radius, **kw)


# ---------------------------------------------------------------------------
# fiber-fiber distances (host, for RSA collision tests)
# ---------------------------------------------------------------------------

def _segment_points(f) -> tuple:
    """The core segment's end points, kept on the fibre: a placed fibre is
    not changed (every action makes new Fiber objects), and the generator
    asks for them at every trial."""
    seg = f.__dict__.get("_segment")
    if seg is None:
        a = np.asarray(f.axis, dtype=np.float64)
        c = np.asarray(f.center, dtype=np.float64)
        h = 0.5 * f.length
        seg = f.__dict__["_segment"] = (c - h * a, c + h * a)
    return seg


def segment_segment_distance(p1, q1, P2, Q2):
    """Min distance between segment (p1,q1) and a batch of segments
    (P2[i], Q2[i]).  Standard clamped closest-point algorithm, vectorized:
    the plain twin of native.segseg_distance_batch."""
    p1 = np.asarray(p1); q1 = np.asarray(q1)
    P2 = np.atleast_2d(P2); Q2 = np.atleast_2d(Q2)
    d1 = q1 - p1                      # (3,)
    d2 = Q2 - P2                      # (n, 3)
    r = p1 - P2                       # (n, 3)
    a = float(d1 @ d1)
    e = (d2 * d2).sum(-1)
    f = (d2 * r).sum(-1)
    eps = 1e-30

    c = r @ d1
    b = d2 @ d1
    denom = a * e - b * b

    s = np.where(denom > eps, np.clip((b * f - c * e) / np.maximum(denom, eps), 0, 1), 0.0)
    t = (b * s + f) / np.maximum(e, eps)
    # re-clamp t and recompute s
    t_cl = np.clip(t, 0.0, 1.0)
    s = np.where(t != t_cl,
                 np.clip((b * t_cl - c) / max(a, eps), 0, 1), s)
    t = t_cl
    # a degenerate segment 2 (e ~ 0) is a point: its projection onto
    # segment 1, as in the native library (the JAX package's copy takes
    # s = 0 there)
    s = np.where(e <= eps, np.clip(-c / max(a, eps), 0, 1), s)
    # degenerate segment 1 (a ~ 0)
    if a <= eps:
        s = np.zeros_like(t)
        t = np.clip(f / np.maximum(e, eps), 0, 1)
    c1 = p1 + s[:, None] * d1
    c2 = P2 + t[:, None] * d2
    diff = c1 - c2
    return np.sqrt((diff * diff).sum(-1))


def fiber_fiber_distance(f, others: List[Fiber]) -> np.ndarray:
    """Surface-surface distance between fiber f and a list of fibers
    (capsule metric; cylinders are treated by their bounding capsule, a
    conservative approximation of CylindricalFiber::distanceTo)."""
    if not others:
        return np.empty(0)

    def is_capsule(g):
        return isinstance(g, (Capsule, Cylinder))

    if not is_capsule(f) or not all(is_capsule(o) for o in others):
        # generic pairing (halfspaces, meshes): sample the capsule's segment
        # endpoints against the other primitive's signed distance
        out = np.empty(len(others))
        for i, o in enumerate(others):
            if not is_capsule(f) and is_capsule(o):
                p, q = _segment_points(o)
                d = min(float(np.min(f.distance(p))),
                        float(np.min(f.distance(q)))) - o.radius
            elif is_capsule(f):
                p, q = _segment_points(f)
                d = min(float(np.min(o.distance(p))),
                        float(np.min(o.distance(q)))) - f.radius
            else:
                lo1, hi1 = f.bbox()
                lo2, hi2 = o.bbox()
                gap = np.maximum(lo2 - hi1, lo1 - hi2)
                d = float(np.linalg.norm(np.maximum(gap, 0.0)))
            out[i] = d
        return out
    p1, q1 = _segment_points(f)
    segs = [_segment_points(o) for o in others]
    P2 = np.array([p for p, _ in segs])
    Q2 = np.array([q for _, q in segs])
    R2 = np.array([o.radius for o in others])
    from .. import native
    d = native.segseg_distance_batch(p1, q1, P2, Q2)
    if d is None:
        d = segment_segment_distance(p1, q1, P2, Q2)
    return d - f.radius - R2


# ---------------------------------------------------------------------------
# packed device-side representation
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PackedFibers:
    """Array-of-struct packing of capsule/cylinder fibers for device kernels:
    centers (F,3), axes (F,3), half-lengths (F,), radii (F,), flat (F,) bool
    (flat caps = cylinder), ids (F,)."""

    centers: np.ndarray
    axes: np.ndarray
    half_lengths: np.ndarray
    radii: np.ndarray
    flat: np.ndarray
    ids: np.ndarray

    @property
    def count(self):
        return self.centers.shape[0]


def pack_fibers(fibers: List[Fiber]) -> Optional[PackedFibers]:
    caps = [f for f in fibers if isinstance(f, (Capsule, Cylinder))]
    if not caps:
        return None
    return PackedFibers(
        centers=np.stack([f.center for f in caps]).astype(np.float64),
        axes=np.stack([f.axis for f in caps]).astype(np.float64),
        half_lengths=np.array([0.5 * f.length for f in caps]),
        radii=np.array([f.radius for f in caps]),
        flat=np.array([isinstance(f, Cylinder) for f in caps]),
        ids=np.array([f.fiber_id for f in caps], dtype=np.int32),
    )
