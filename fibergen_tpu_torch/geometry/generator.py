"""Random sequential adsorption (RSA) fibre generator (a copy of
fibergen_tpu/geometry/generator.py; host numpy).

Equivalent of the reference's FiberGenerator (fibergen.cpp:6074-7146): it
draws fibres one by one from the orientation, length and radius
distributions, rejects a placement that comes closer than dmin to a placed
fibre, and adds periodic clones, either the exact 27-neighbour mode or the
cheaper wall mode (fibergen.cpp:6392-6510).  The collision test runs the
native segment distances (native/) against every placed fibre.  It makes
the JAX package's numpy draws in the JAX package's order, so one seed gives
one fibre list, bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from ..utils.logging import LOG, ProgressBar
from . import distributions as dist
from .primitives import Capsule, Cylinder, Fiber, HalfSpace, fiber_fiber_distance


@dataclasses.dataclass
class GeneratorSettings:
    """<settings> geometry attributes (FiberGenerator::readSettings)."""

    fiber_type: str = "capsule"
    length: float = 1.0
    radius: float = 0.1
    target_volume: float = 0.0   # v
    target_count: int = 0        # n
    max_iter: int = 10000        # m
    dmin: float = 0.0
    dmax: float = np.inf
    intersecting: bool = False
    periodic_x: bool = True
    periodic_y: bool = True
    periodic_z: bool = True
    periodic_fast: bool = False
    planar_x: bool = False
    planar_y: bool = False
    planar_z: bool = False
    seed: int = 0
    x0: tuple = (0.0, 0.0, 0.0)
    dims: tuple = (1.0, 1.0, 1.0)


class FiberGenerator:
    """Owns the fiber list, distributions and orientation-moment statistics."""

    def __init__(self, settings: GeneratorSettings = None):
        self.s = settings or GeneratorSettings()
        self.fibers: List[Fiber] = []      # primary fibers (no clones)
        self.clones: List[Fiber] = []      # periodic clones
        self.material = 0
        self.material_names: Dict[int, str] = {}
        self.orientation_distribution: Optional[dist.Distribution] = None
        self.length_distribution: Optional[dist.Distribution] = None
        self.radius_distribution: Optional[dist.Distribution] = None
        self._A2 = np.zeros((3, 3))
        self._A4 = np.zeros((3, 3, 3, 3))
        self._stats_v: Dict[int, float] = {}
        self._stats_n = 0
        self._stats_i = 0

    # --------------------------------------------------------------- setup
    def select_material(self, mat: int, name: str = None):
        self.material = mat
        if name is not None:
            self.material_names[mat] = name

    def all_fibers(self) -> List[Fiber]:
        return self.fibers + self.clones

    def add_fiber(self, fiber: Fiber, periodic: bool = True):
        """Explicitly place a fiber (place_fiber action, fibergen.cpp:25788)
        and its periodic clones."""
        fiber.material = self.material
        fiber.fiber_id = self._stats_n + 1
        self._stats_n += 1
        self.fibers.append(fiber)
        if periodic and not isinstance(fiber, HalfSpace):
            self.clones.extend(self._make_clones(fiber))
        self._update_moments(fiber.orientation())
        v = fiber.volume() / self._v_rve()
        self._stats_v[fiber.material] = self._stats_v.get(fiber.material, 0.0) + v

    def _v_rve(self):
        d = self.s.dims
        return d[0] * d[1] * d[2]

    # ------------------------------------------------------------- moments
    def _update_moments(self, a):
        a = np.asarray(a, dtype=np.float64)
        n = np.linalg.norm(a)
        if n == 0:
            return
        a = a / n
        self._A2 += np.outer(a, a)
        self._A4 += np.einsum("i,j,k,l->ijkl", a, a, a, a)

    def get_A2(self):
        """Normalized 2nd-order orientation moment (fibergen.cpp:6683)."""
        tr = np.trace(self._A2)
        return self._A2 / (tr if tr != 0 else 1.0)

    def get_A4(self):
        """Normalized 4th-order orientation moment (fibergen.cpp:6689)."""
        A2 = np.einsum("iikl->kl", self._A4)
        tr = np.trace(A2)
        return self._A4 / (tr if tr != 0 else 1.0)

    # ----------------------------------------------------------- generation
    def run(self, V=0.0, N=0, M=0, dmin=None, intersecting=None,
            intersecting_materials=None):
        """RSA generation loop (FiberGenerator::run, fibergen.cpp:6278-6530).

        intersecting_materials: optional set of material indices to test
        collisions against (others may be intersected freely)."""
        s = self.s
        V = V or s.target_volume
        N = N or s.target_count
        M = M or s.max_iter
        if dmin is None:
            dmin = s.dmin
        if intersecting is None:
            intersecting = s.intersecting

        def pool_of(extra):
            base = self.all_fibers() + extra
            if intersecting_materials is None:
                return base
            return [f for f in base if f.material in intersecting_materials]

        rng = np.random.default_rng(s.seed)

        V_rve = self._v_rve()
        # progress against whichever target is active (count or volume)
        bar = ProgressBar(total=1000, text="placing fibers ")
        v = 0.0
        n = 0
        i = 0
        while True:
            done = (not intersecting and M and i >= M) or \
                   (N and n >= N) or (V and v >= V)
            frac = max(n / N if N else 0.0, v / V if V else 0.0)
            bar.update(int(1000 * min(1.0, frac)))
            if done:
                bar.complete()
                break
            fiber = self._random_fiber(rng, n)
            fiber.fiber_id = self._stats_n + n + 1
            fiber.material = self.material
            i += 1

            if not intersecting:
                pool = pool_of([])
                if pool:
                    d = fiber_fiber_distance(fiber, pool)
                    if d.size and d.min() < dmin:
                        continue

            clones = self._make_clones(fiber)
            if not intersecting and clones:
                ok = True
                placed = []
                for c in clones:
                    pool = pool_of(placed)
                    if pool:
                        d = fiber_fiber_distance(c, pool)
                        if d.size and d.min() < dmin:
                            ok = False
                            break
                    placed.append(c)
                if not ok:
                    continue

            self.clones.extend(clones)
            self.fibers.append(fiber)
            n += 1
            v += fiber.volume() / V_rve
            self._update_moments(fiber.orientation())

        LOG.info(f"generated {n} fibers in {i} iterations, "
                 f"volume fraction {v:.4f}")
        self._stats_v[self.material] = self._stats_v.get(self.material, 0.0) + v
        self._stats_n += n
        self._stats_i += i

    def _make_clones(self, fiber) -> List[Fiber]:
        """Periodic clones: exact 27-neighbor mode keeps every translated
        image that still touches the RVE; fast mode only clones across
        intersected walls (fibergen.cpp:6392-6510)."""
        s = self.s
        if not (s.periodic_x or s.periodic_y or s.periodic_z):
            return []
        x0 = np.asarray(s.x0)
        dims = np.asarray(s.dims)
        lo, hi = fiber.bbox()
        clones = []
        if not s.periodic_fast:
            rx = (-1, 0, 1) if s.periodic_x else (0,)
            ry = (-1, 0, 1) if s.periodic_y else (0,)
            rz = (-1, 0, 1) if s.periodic_z else (0,)
            for q in rx:
                for p in ry:
                    for k in rz:
                        if q == 0 and p == 0 and k == 0:
                            continue
                        t = np.array([q, p, k]) * dims
                        # keep the clone only if it can touch the RVE box
                        if np.any(lo + t > x0 + dims) or np.any(hi + t < x0):
                            continue
                        c = fiber.translated(t)
                        c.translation = t
                        clones.append(c)
        else:
            # wall mode: clone across each wall the fiber crosses, plus the
            # diagonals of multi-wall intersections
            crossed = []
            for ax in range(3):
                if not (s.periodic_x, s.periodic_y, s.periodic_z)[ax]:
                    continue
                if lo[ax] < x0[ax]:
                    crossed.append((ax, +dims[ax]))
                if hi[ax] > x0[ax] + dims[ax]:
                    crossed.append((ax, -dims[ax]))
            for k in range(1, 2 ** len(crossed)):
                t = np.zeros(3)
                for b, (ax, d) in enumerate(crossed):
                    if k >> b & 1:
                        t[ax] += d
                c = fiber.translated(t)
                c.translation = t
                clones.append(c)
        return clones

    def _random_fiber(self, rng, index) -> Fiber:
        """Draw a random fiber (randomFiber, fibergen.cpp:6537-6671)."""
        s = self.s
        if self.orientation_distribution is None:
            self.orientation_distribution = dist.UniformSphere()
        if self.length_distribution is None:
            self.length_distribution = dist.Dirac(np.array([s.length]))
        if self.radius_distribution is None:
            self.radius_distribution = dist.Dirac(np.array([s.radius]))

        x0 = np.asarray(s.x0)
        dims = np.asarray(s.dims)
        planar = (s.planar_x, s.planar_y, s.planar_z)

        while True:
            a = np.asarray(self.orientation_distribution.draw(rng, index),
                           dtype=np.float64)
            na = np.linalg.norm(a)
            if na == 0:
                raise ValueError("orientation vector of length zero")
            a = a / na
            L = float(self.length_distribution.draw(rng, index)[0])
            R = float(self.radius_distribution.draw(rng, index)[0])

            x = np.zeros(3)
            for i in range(3):
                if planar[i]:
                    x[i] = x0[i] + 0.5 * dims[i]
                else:
                    # margin so fibers may stick out of the box
                    m = ((0.5 * L + R) * abs(a[i])
                         + np.sqrt(max(0.0, 1 - a[i] * a[i])) * R) * 1.001
                    x[i] = x0[i] - m + (dims[i] + 2 * m) * rng.uniform()

            if s.fiber_type == "capsule":
                fiber = Capsule(center=x, axis=a, length=L, radius=R)
            elif s.fiber_type == "cylinder":
                fiber = Cylinder(center=x, axis=a, length=L, radius=R)
            else:
                raise ValueError(f"Unknown fiber type '{s.fiber_type}'")

            # reject fibers entirely outside the RVE
            lo, hi = fiber.bbox()
            if np.any(hi < x0) or np.any(lo > x0 + dims):
                continue
            return fiber

    def volume_fraction(self, material: int) -> float:
        return self._stats_v.get(material, 0.0)
