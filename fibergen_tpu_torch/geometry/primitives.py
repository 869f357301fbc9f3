"""Geometric fibre primitives (port of fibergen_tpu/geometry/primitives.py).

Host-side dataclasses describing the fibres, used by the sequential RSA
generator, and their packing into parameter arrays for the voxelizer
(geometry/discretize.py), which evaluates the primitives of one type for
all voxels at once on the solver's device.  Redesign of the reference's
Fiber class hierarchy (fibergen.cpp:3011-5642).

Conventions: signed distance < 0 inside the fibre; ``axis`` is a unit
vector; the capsule/cylinder length L is that of the core segment (total
capsule length L + 2R).  The mesh primitives (Triangle, Tetrahedron with
its outward face planes, TriangleSurface, TetMesh, Point) are host numpy
here as in the JAX package; the voxelizer evaluates them in PyTorch on the
solver's device.
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


# ---------------------------------------------------------------------------
# Mesh-based primitives (triangle / tetrahedron / surfaces)
# ---------------------------------------------------------------------------

def _np_point_triangle(p, v0, v1, v2):
    """Distance from points p (..., 3) to one triangle (numpy, host): the
    smaller of the distance to the plane's foot point, where that lies in
    the triangle, and the distances to the three edges.  (The JAX
    package's copy clamps the barycentric coordinates one by one, so its
    interior candidate may lie outside the triangle and the distance come
    out too small.)"""
    p = np.asarray(p, dtype=np.float64)
    ab = v1 - v0
    ac = v2 - v0
    ap = p - v0
    d1 = ap @ ab
    d2 = ap @ ac
    aa, bb, cc = float(ab @ ab), float(ab @ ac), float(ac @ ac)
    det = aa * cc - bb * bb

    def seg(a, b):
        t = np.clip(((p - a) @ (b - a))
                    / max(float((b - a) @ (b - a)), 1e-300), 0, 1)
        return np.linalg.norm(p - (a + t[..., None] * (b - a)), axis=-1)

    d = np.minimum(np.minimum(seg(v0, v1), seg(v1, v2)), seg(v0, v2))
    if det > 1e-300:
        v = (cc * d1 - bb * d2) / det
        w = (aa * d2 - bb * d1) / det
        inside = (v >= 0) & (w >= 0) & (v + w <= 1)
        q = v0 + v[..., None] * ab + w[..., None] * ac
        d = np.where(inside, np.minimum(d, np.linalg.norm(p - q, axis=-1)),
                     d)
    return d


@dataclasses.dataclass
class Triangle(Fiber):
    """Thin triangular sheet (TriangleFiber, fibergen.cpp:4417)."""

    v0: np.ndarray = None
    v1: np.ndarray = None
    v2: np.ndarray = None

    def volume(self):
        return 0.0

    def orientation(self):
        n = np.cross(self.v1 - self.v0, self.v2 - self.v0)
        return n / max(np.linalg.norm(n), 1e-300)

    def distance(self, p):
        return _np_point_triangle(p, self.v0, self.v1, self.v2)

    def translated(self, t):
        t = np.asarray(t)
        return Triangle(material=self.material, fiber_id=self.fiber_id,
                        v0=self.v0 + t, v1=self.v1 + t, v2=self.v2 + t)

    def bbox(self):
        V = np.stack([self.v0, self.v1, self.v2])
        return V.min(0), V.max(0)


@dataclasses.dataclass
class Tetrahedron(Fiber):
    """Solid tetrahedron (TetrahedronFiber, fibergen.cpp:3988); signed
    distance via the max of the four outward face-plane distances (exact
    inside; slightly conservative outside edges)."""

    verts: np.ndarray = None  # (4, 3)

    def __post_init__(self):
        if self.verts is not None:
            self.verts = np.asarray(self.verts, dtype=np.float64)
            self._faces = self._face_planes(self.verts)

    @staticmethod
    def _face_planes(V):
        faces = [(1, 2, 3, 0), (0, 3, 2, 1), (0, 1, 3, 2), (0, 2, 1, 3)]
        planes = []
        for a, b, c, opp in faces:
            n = np.cross(V[b] - V[a], V[c] - V[a])
            nn = np.linalg.norm(n)
            if nn < 1e-300:
                continue
            n = n / nn
            if (V[opp] - V[a]) @ n > 0:
                n = -n  # ensure outward
            planes.append((n, V[a]))
        return planes

    def volume(self):
        V = self.verts
        return abs(np.linalg.det(V[1:] - V[0])) / 6.0

    def distance(self, p):
        p = np.asarray(p, dtype=np.float64)
        d = None
        for n, a in self._faces:
            dk = (p - a) @ n
            d = dk if d is None else np.maximum(d, dk)
        return d

    def translated(self, t):
        return Tetrahedron(material=self.material, fiber_id=self.fiber_id,
                           verts=self.verts + np.asarray(t))

    def bbox(self):
        return self.verts.min(0), self.verts.max(0)


@dataclasses.dataclass
class TriangleSurface(Fiber):
    """Closed triangle-mesh surface (STL) filled solid
    (STLFiber, fibergen.cpp:4973): signed distance = unsigned distance to
    the closest triangle, sign from that triangle's outward normal."""

    V0: np.ndarray = None  # (n, 3)
    V1: np.ndarray = None
    V2: np.ndarray = None
    fill: bool = True

    def __post_init__(self):
        for k in ("V0", "V1", "V2"):
            setattr(self, k, np.asarray(getattr(self, k), dtype=np.float64))
        n = np.cross(self.V1 - self.V0, self.V2 - self.V0)
        self.normals = n / np.maximum(
            np.linalg.norm(n, axis=-1, keepdims=True), 1e-300)

    def volume(self):
        # divergence theorem over the closed surface
        cross = np.cross(self.V1 - self.V0, self.V2 - self.V0)
        return abs((self.V0 * cross).sum() / 6.0)

    def distance(self, p):
        p = np.atleast_2d(np.asarray(p, dtype=np.float64))
        best = np.full(p.shape[0], np.inf)
        sign = np.ones(p.shape[0])
        for i in range(self.V0.shape[0]):
            d = _np_point_triangle(p, self.V0[i], self.V1[i], self.V2[i])
            m = d < best
            best = np.where(m, d, best)
            s = np.sign(((p - self.V0[i]) @ self.normals[i]))
            sign = np.where(m, np.where(s == 0, 1.0, s), sign)
        out = best * sign if self.fill else best
        return out[0] if out.shape[0] == 1 else out

    def translated(self, t):
        t = np.asarray(t)
        return TriangleSurface(material=self.material, fiber_id=self.fiber_id,
                               V0=self.V0 + t, V1=self.V1 + t, V2=self.V2 + t,
                               fill=self.fill)

    def bbox(self):
        V = np.concatenate([self.V0, self.V1, self.V2])
        return V.min(0), V.max(0)


@dataclasses.dataclass
class TetMesh(Fiber):
    """Filled tetrahedral mesh (TetFiber hierarchy, fibergen.cpp:4668-4971)."""

    points: np.ndarray = None  # (n, 3)
    tets: np.ndarray = None    # (m, 4) int

    def volume(self):
        P, T = self.points, self.tets
        a = P[T[:, 1]] - P[T[:, 0]]
        b = P[T[:, 2]] - P[T[:, 0]]
        c = P[T[:, 3]] - P[T[:, 0]]
        return float(np.abs(np.einsum("ij,ij->i", a, np.cross(b, c))).sum() / 6.0)

    def distance(self, p):
        d = None
        for t in self.tets:
            tet = Tetrahedron(verts=self.points[t])
            dk = tet.distance(p)
            d = dk if d is None else np.minimum(d, dk)
        return d

    def translated(self, t):
        return TetMesh(material=self.material, fiber_id=self.fiber_id,
                       points=self.points + np.asarray(t), tets=self.tets)

    def bbox(self):
        return self.points.min(0), self.points.max(0)


@dataclasses.dataclass
class Point(Fiber):
    """Point marker (PointFiber, fibergen.cpp:5125): zero-volume sphere used
    for distance maps and seeding."""

    center: np.ndarray = None

    def volume(self):
        return 0.0

    def distance(self, p):
        d = np.asarray(p, dtype=np.float64) - self.center
        return np.sqrt((d * d).sum(-1))

    def translated(self, t):
        return Point(material=self.material, fiber_id=self.fiber_id,
                     center=self.center + np.asarray(t))

    def bbox(self):
        return self.center.copy(), self.center.copy()
