"""A planar mat of non-intersecting cylinder fibres in a one-voxel-thick
periodic cell: the geometry of fibergen's heat demo
(``demo/heat/heat/project.xml``), in voxel units.

The demo places ``n`` = 100 cylinders of radius 0.01 and length uniform in
0.02-0.4 with axes uniform in the x-y plane and centres in the mid-plane
of a 128 x 128 x 1 cell of voxel size 1/128, no two closer than ``dmin`` =
0.5 / 128.  Here every length is in voxels (R 1.28, L 2.56-51.2, dmin
0.5), and a grid of nx x ny voxels holds ``fibres_per_tile`` fibres for
every ``tile`` (128 x 128) voxels, so a 128 x 128 x 1 grid is the demo
and a larger one the same mat grown at the demo's own voxel size.

``draw``: random sequential adsorption.  Candidates come from the seed's
generator four uniforms each, in this order: the centre's x and y
(uniform over the periodic cell), the axis angle (uniform in [0, 2 pi))
and the length (uniform between the two limits); the centre lies in the
mid-plane (z = nz / 2).  A candidate is accepted where its bounding
capsule keeps ``dmin`` to every periodic image of every fibre accepted
before it and to its own (surface distance = segment distance - 2 R),
until the target count is reached or the attempts reach
``attempts_per_tile`` for every tile.  Candidates are taken in blocks:
tested against the fibres accepted before the block at once (a cell
list), then against each other in draw order, so the result is the
one-by-one process's.  The tests run on the card where there is one
(float64: the same seed gives the same fibres on any machine).

``fields``: the fibre fraction and the interface normals of the composite
voxels, as fibergen's voxelizer gives them with its default one level of
refinement: on the grid refined twice per axis, each fibre adds the
fraction of the sub-voxel that the tangent plane at its centre cuts off
(the signed distance and outward normal of the cylinder, flat caps), the
sum is clamped to [0, 1] and averaged back over each voxel's eight
sub-voxels; the normal of a voxel is that of the fibre with the least
signed distance at its centre (the earlier fibre on a tie), on the
voxels some fibre reaches and zero elsewhere.  Each fibre is evaluated
only on a window around it, on the device, in float64, returned in
``dtype``.  Plain PyTorch and numpy: nothing of the program.
"""
from __future__ import annotations

import math

import numpy as np
import torch

BLOCK = 4096
SUPERSAMPLE = 2
# values of a group's (fibres, window) temporaries, by device type
GROUP_VALUES = {"cuda": 2 ** 24, "cpu": 2 ** 20}


class Fibres:
    """The accepted fibres in voxel units, in order of acceptance: centres
    (n, 3), unit axes (n, 3) with z = 0, lengths (n,), the radius and the
    attempts the draw took."""

    def __init__(self, centre, axis, length, radius, attempts):
        self.centre, self.axis, self.length = centre, axis, length
        self.radius, self.attempts = radius, attempts


class Fields:
    """The fibre fraction ``phi`` (nx, ny, nz) and the outward ``normals``
    (3, nx, ny, nz) of the nearest fibre."""

    def __init__(self, phi, normals):
        self.phi, self.normals = phi, normals


def _params(config: dict, shape):
    inc = config["inclusion"]
    tiles = shape[0] * shape[1] / float(inc["tile"][0] * inc["tile"][1])
    lo, hi = (float(v) for v in inc["length"])
    return dict(n=int(round(inc["fibres_per_tile"] * tiles)),
                cap=int(round(inc["attempts_per_tile"] * tiles)),
                R=float(inc["radius"]), lo=lo, hi=hi,
                dmin=float(inc["dmin"]))


def _wrap(d, n):
    """The periodic nearest image of a difference along a cell edge n."""
    return d - n * torch.round(d / n)


def _pt_seg(px, py, ax, ay, bx, by):
    """Distance from the points p to the segments ab."""
    ux, uy = bx - ax, by - ay
    uu = torch.clamp(ux * ux + uy * uy, min=1e-300)
    t = torch.clamp(((px - ax) * ux + (py - ay) * uy) / uu, 0.0, 1.0)
    dx, dy = px - ax - t * ux, py - ay - t * uy
    return torch.sqrt(dx * dx + dy * dy)


def _seg_dist(c1, a1, h1, c2, a2, h2, n=None):
    """Distance between coplanar segments (centre c, unit axis a: (k, 2);
    half length h: (k,)), the second at its periodic nearest image of the
    first on a cell of edges ``n`` (where it as given with ``n`` None):
    zero where they cross, else the least of the four end-to-segment
    distances."""
    dx, dy = c2[:, 0] - c1[:, 0], c2[:, 1] - c1[:, 1]
    if n is not None:
        dx, dy = _wrap(dx, n[0]), _wrap(dy, n[1])
    p1x, p1y = -h1 * a1[:, 0], -h1 * a1[:, 1]
    q1x, q1y = h1 * a1[:, 0], h1 * a1[:, 1]
    p2x, p2y = dx - h2 * a2[:, 0], dy - h2 * a2[:, 1]
    q2x, q2y = dx + h2 * a2[:, 0], dy + h2 * a2[:, 1]

    def orient(ax, ay, bx, by, cx, cy):
        return (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
    cross = ((orient(p1x, p1y, q1x, q1y, p2x, p2y)
              * orient(p1x, p1y, q1x, q1y, q2x, q2y) < 0)
             & (orient(p2x, p2y, q2x, q2y, p1x, p1y)
                * orient(p2x, p2y, q2x, q2y, q1x, q1y) < 0))
    d = torch.minimum(
        torch.minimum(_pt_seg(p2x, p2y, p1x, p1y, q1x, q1y),
                      _pt_seg(q2x, q2y, p1x, p1y, q1x, q1y)),
        torch.minimum(_pt_seg(p1x, p1y, p2x, p2y, q2x, q2y),
                      _pt_seg(q1x, q1y, p2x, p2y, q2x, q2y)))
    return torch.where(cross, torch.zeros_like(d), d)


def shifts(n, reach, device):
    """The periodic translations (i nx, j ny) that can bring a fibre within
    ``reach`` of another's centre, (s, 2), the zero shift first."""
    r = [int(math.ceil(reach / n[a])) for a in range(2)]
    out = [(0.0, 0.0)] + [(i * n[0], j * n[1])
                          for i in range(-r[0], r[0] + 1)
                          for j in range(-r[1], r[1] + 1) if i or j]
    return torch.tensor(out, dtype=torch.float64, device=device)


class _Cells:
    """Fibres (centre, axis, half length in the x-y plane) bucketed by
    centre in square cells of at least the reach (the farthest apart two
    centres of fibres within ``clear`` can be) on the periodic x-y cell,
    where the nearest image alone can come within reach; on a cell of
    fewer than three reaches a side a single bucket, every image
    within reach tested."""

    def __init__(self, n, reach, clear, capacity, device):
        self.n, self.clear, self.dev = n, clear, device
        self.k = [max(1, int(n[a] // reach)) for a in range(2)]
        self.shifts = None
        if min(self.k) < 3:
            self.k = [1, 1]
            self.shifts = shifts(n, reach, device)
        i64 = dict(dtype=torch.int64, device=device)
        self.slots = torch.full((self.k[0] * self.k[1], 16), -1, **i64)
        self.count = torch.zeros(self.k[0] * self.k[1], **i64)
        f64 = dict(dtype=torch.float64, device=device)
        self.c = torch.zeros((capacity, 2), **f64)
        self.a = torch.zeros((capacity, 2), **f64)
        self.h = torch.zeros(capacity, **f64)
        self.size = 0

    def _cell(self, c, dx=0, dy=0):
        ix = torch.floor(c[:, 0] * (self.k[0] / self.n[0])).long() + dx
        iy = torch.floor(c[:, 1] * (self.k[1] / self.n[1])).long() + dy
        return (ix % self.k[0]) * self.k[1] + iy % self.k[1]

    def add(self, c, a, h):
        """Appends the fibres (k, 2), (k, 2), (k,) in order."""
        i0, k = self.size, len(h)
        if k == 0:
            return
        self.c[i0:i0 + k], self.a[i0:i0 + k], self.h[i0:i0 + k] = c, a, h
        self.size += k
        cell = self._cell(c)
        cs, order = torch.sort(cell, stable=True)
        first = torch.searchsorted(cs, cs, right=False)
        slot = self.count[cs] + torch.arange(k, device=self.dev) - first
        need = int(slot.max()) + 1
        if need > self.slots.shape[1]:
            grown = torch.full((self.slots.shape[0], 2 * need), -1,
                               dtype=torch.int64, device=self.dev)
            grown[:, :self.slots.shape[1]] = self.slots
            self.slots = grown
        self.slots[cs, slot] = i0 + order
        self.count.index_add_(0, cs, torch.ones_like(cs))

    def hits(self, c, a, h):
        """(i, j): the fibres j held here that fibre i of (c, a, h) comes
        closer to than ``clear`` (surface to surface plus 2 R)."""
        if self.size == 0 or len(h) == 0:
            return c.new_zeros(0, dtype=torch.int64), \
                c.new_zeros(0, dtype=torch.int64)
        if self.shifts is not None:
            i0 = torch.arange(len(h), device=self.dev).repeat_interleave(
                self.size)
            j0 = torch.arange(self.size, device=self.dev).repeat(len(h))
            hit = torch.zeros(len(i0), dtype=torch.bool, device=self.dev)
            for t in self.shifts:
                dc = self.c[j0] + t - c[i0]
                near = torch.nonzero((dc * dc).sum(1) < (
                    h[i0] + self.h[j0] + self.clear) ** 2)[:, 0]
                i, j = i0[near], j0[near]
                d = _seg_dist(c[i], a[i], h[i], self.c[j] + t, self.a[j],
                              self.h[j])
                hit[near[d < self.clear]] = True
            return i0[hit], j0[hit]
        nb = torch.cat([self.slots[self._cell(c, dx, dy)]
                        for dx in (-1, 0, 1) for dy in (-1, 0, 1)], 1)
        i, m = torch.nonzero(nb >= 0, as_tuple=True)
        j = nb[i, m]
        dx = _wrap(self.c[j, 0] - c[i, 0], self.n[0])
        dy = _wrap(self.c[j, 1] - c[i, 1], self.n[1])
        near = dx * dx + dy * dy < (h[i] + self.h[j] + self.clear) ** 2
        i, j = i[near], j[near]
        d = _seg_dist(c[i], a[i], h[i], self.c[j], self.a[j], self.h[j],
                      self.n)
        return i[d < self.clear], j[d < self.clear]


def draw(config: dict, rng, shape) -> Fibres:
    """The fibres of the seed's generator ``rng`` on the grid ``shape``
    (voxel units), in order of acceptance; the tests run on a card where
    there is one."""
    p = _params(config, shape)
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    f64 = dict(dtype=torch.float64, device=dev)
    n = (float(shape[0]), float(shape[1]))
    clear = 2.0 * p["R"] + p["dmin"]
    reach = p["hi"] + clear
    cells = _Cells(n, reach, clear, p["n"], dev)
    attempts = 0
    while cells.size < p["n"] and attempts < p["cap"]:
        # blocks no larger than a few times what is left to place: the
        # stream of uniforms is the same for any block size
        take = min(BLOCK, 8 * (p["n"] - cells.size), p["cap"] - attempts)
        u = torch.as_tensor(rng.random((take, 4)), **f64)
        c = u[:, :2] * torch.tensor(n, **f64)
        theta = 2.0 * math.pi * u[:, 2]
        a = torch.stack([torch.cos(theta), torch.sin(theta)], dim=1)
        h = 0.5 * (p["lo"] + (p["hi"] - p["lo"]) * u[:, 3])
        # against the fibres accepted before the block
        ok = torch.ones(take, dtype=torch.bool, device=dev)
        ok[cells.hits(c, a, h)[0]] = False
        if cells.shifts is not None:     # and against its own images
            for t in cells.shifts[1:]:
                ok &= _seg_dist(c, a, h, c + t, a, h) >= clear
        s = torch.nonzero(ok)[:, 0]
        # the survivors against each other: a later one is accepted where
        # no earlier survivor it clashes with was
        block = _Cells(n, reach, clear, len(s), dev)
        block.add(c[s], a[s], h[s])
        i, j = block.hits(c[s], a[s], h[s])
        later = i > j
        i, j = i[later].cpu().numpy(), j[later].cpu().numpy()
        taken = np.ones(len(s), dtype=bool)
        taken[i] = False
        if len(i):
            order = np.argsort(i, kind="stable")
            i, j = i[order], j[order]
            bounds = np.searchsorted(i, np.arange(len(s) + 1))
            for t in np.unique(i):
                taken[t] = not taken[j[bounds[t]:bounds[t + 1]]].any()
        acc = s.cpu().numpy()[taken][:p["n"] - cells.size]
        at = torch.as_tensor(acc, device=dev)
        cells.add(c[at], a[at], h[at])
        attempts += take if cells.size < p["n"] else int(acc[-1]) + 1
    m = cells.size
    cc, aa = cells.c[:m].cpu().numpy(), cells.a[:m].cpu().numpy()
    centre = np.column_stack([cc, np.full(m, 0.5 * shape[2])])
    axis = np.column_stack([aa, np.zeros(m)])
    return Fibres(centre, axis, 2.0 * cells.h[:m].cpu().numpy(), p["R"],
                  attempts)


def plane_cut(d, n, h):
    """The fraction of a box of edges h (3 floats) on the inside of a
    plane at signed distance d from its centre with unit normal n (3
    tensors): P(U0 + U1 + U2 <= -d), U_i uniform on (-b_i, b_i), b_i =
    |n_i| h_i / 2, the cubic spline of the sum of three uniforms as nested
    central differences of relu^3, the two smaller half-widths floored at
    1e-6 of the largest so that axis-aligned planes keep their digits."""
    b = [torch.abs(n[i]) * (0.5 * h[i]) for i in range(3)]
    b0 = torch.maximum(b[0], torch.maximum(b[1], b[2]))
    b2 = torch.minimum(b[0], torch.minimum(b[1], b[2]))
    b1 = b[0] + b[1] + b[2] - b0 - b2
    b1 = torch.maximum(b1, 1e-6 * b0)
    b2 = torch.maximum(b2, 1e-6 * b0)
    zero = torch.zeros((), dtype=d.dtype, device=d.device)

    def cube_diff(y):           # relu(y + b2)^3 - relu(y - b2)^3
        r = torch.clamp(y + b2, min=0.0)
        return torch.where(y >= b2, 2.0 * b2 * (3.0 * y * y + b2 * b2),
                           torch.where(y <= -b2, zero, r * r * r))

    def ramp(x):                # the sum of the two smaller uniforms' CDF
        mid = (cube_diff(x + b1) - cube_diff(x - b1)) / (24.0 * b1 * b2)
        return torch.where(x >= b1 + b2, x,
                           torch.where(x <= -(b1 + b2), zero, mid))
    t = -d
    return torch.clamp((ramp(t + b0) - ramp(t - b0)) / (2.0 * b0), 0.0, 1.0)


def cylinder_dn(x, y, z, c, a, hl, R):
    """Signed distance and outward unit normal of cylinders with flat caps
    (centre c, unit axis a: three tensors each; half length hl, radius R)
    at the points (x, y, z), all broadcast together."""
    qx, qy, qz = x - c[0], y - c[1], z - c[2]
    t = qx * a[0] + qy * a[1] + qz * a[2]
    rx, ry, rz = qx - t * a[0], qy - t * a[1], qz - t * a[2]
    rr = torch.sqrt(rx * rx + ry * ry + rz * rz)
    dr, da = rr - R, torch.abs(t) - hl
    u, v = torch.clamp(dr, min=0.0), torch.clamp(da, min=0.0)
    out = torch.sqrt(u * u + v * v)
    d = out + torch.clamp(torch.maximum(dr, da), max=0.0)
    outside = out > 0
    den = torch.clamp(out, min=1e-30)
    wr = torch.where(outside, u / den, (dr >= da).to(rr.dtype))
    wa = torch.where(outside, v / den, (dr < da).to(rr.dtype))
    rr = torch.clamp(rr, min=1e-30)
    sa = torch.sign(t)
    return d, (wr * rx / rr + wa * sa * a[0], wr * ry / rr + wa * sa * a[1],
               wr * rz / rr + wa * sa * a[2])


def _windows(fib: Fibres, shape):
    """Each fibre's window: the first voxel (x, y) and the voxel counts of
    its bounding box with one voxel to spare, as (n, 2) ints.  A window
    may be wider than the grid: its voxels wrap, and each image of the
    fibre adds its share."""
    ext = np.abs(fib.axis[:, :2]) * (0.5 * fib.length[:, None]) + fib.radius
    lo = np.floor(fib.centre[:, :2] - ext).astype(np.int64) - 1
    hi = np.floor(fib.centre[:, :2] + ext).astype(np.int64) + 2
    return lo, hi - lo


def fields(config: dict, drawn: Fibres, shape, device,
           dtype=torch.float32) -> Fields:
    """The fibre fraction and the interface normals on the grid ``shape``,
    computed in float64 on ``device`` and returned in ``dtype``."""
    dev = torch.device(device)
    f64 = dict(dtype=torch.float64, device=dev)
    nx, ny, nz = (int(s) for s in shape)
    ss = SUPERSAMPLE
    sub = torch.zeros(nx * ss * ny * ss * nz * ss, **f64)
    dmin = torch.full((nx * ny * nz,), math.inf, **f64)
    normals = torch.zeros((3, nx * ny * nz), **f64)
    owner = torch.full((nx * ny * nz,), -1, dtype=torch.int64, device=dev)
    if len(drawn.length):
        lo, size = _windows(drawn, shape)
        order = np.argsort(size[:, 0] * size[:, 1], kind="stable")
        budget = GROUP_VALUES.get(dev.type, GROUP_VALUES["cpu"])
        g0 = 0
        while g0 < len(order):
            w = size[order[g0]]
            g1 = g0 + 1
            while g1 < len(order):
                w1 = np.maximum(w, size[order[g1]])
                if (g1 + 1 - g0) * int(np.prod(w1)) * nz * ss ** 3 > budget:
                    break
                w, g1 = w1, g1 + 1
            idx = order[g0:g1]
            _group(drawn, idx, lo[idx], w, (nx, ny, nz), ss, sub, dmin,
                   normals, owner, f64)
            g0 = g1
    phi = torch.clamp(sub, 0.0, 1.0).reshape(nx, ss, ny, ss, nz, ss)
    phi = phi.mean(dim=(1, 3, 5))
    return Fields(phi.to(dtype), normals.reshape(3, nx, ny, nz).to(dtype))


def _group(fib, idx, lo, w, shape, ss, sub, dmin, normals, owner, f64):
    """Adds the fibres ``idx`` (windows from ``lo``, ``w`` voxels a side)
    to the refined fraction ``sub``, and takes each one's normal at the
    voxel centres where it is the nearest so far."""
    nx, ny, nz = shape
    dev = sub.device
    t = lambda v: torch.as_tensor(np.asarray(v), **f64)
    col = lambda v: t(v).reshape(-1, 1, 1, 1)
    c = [col(fib.centre[idx, i]) for i in range(3)]
    a = [col(fib.axis[idx, i]) for i in range(3)]
    hl, R = col(0.5 * fib.length[idx]), fib.radius
    ox = torch.as_tensor(lo[:, 0], device=dev).reshape(-1, 1, 1, 1)
    oy = torch.as_tensor(lo[:, 1], device=dev).reshape(-1, 1, 1, 1)
    # refined grid: sub-voxel centres (i + 0.5) / ss in voxel units
    ix = ox * ss + torch.arange(w[0] * ss, device=dev).reshape(1, -1, 1, 1)
    iy = oy * ss + torch.arange(w[1] * ss, device=dev).reshape(1, 1, -1, 1)
    iz = torch.arange(nz * ss, device=dev).reshape(1, 1, 1, -1)
    pos = lambda i: (i.to(torch.float64) + 0.5) / ss
    d, nrm = cylinder_dn(pos(ix), pos(iy), pos(iz), c, a, hl, R)
    frac = plane_cut(d, nrm, (1.0 / ss,) * 3)
    del d, nrm
    flat = ((ix % (nx * ss)) * (ny * ss) + iy % (ny * ss)) * (nz * ss) + iz
    sub.index_add_(0, flat.expand(frac.shape).reshape(-1), frac.reshape(-1))
    del frac, flat
    # voxel centres: the nearest fibre's normal
    jx = ox + torch.arange(w[0], device=dev).reshape(1, -1, 1, 1)
    jy = oy + torch.arange(w[1], device=dev).reshape(1, 1, -1, 1)
    jz = torch.arange(nz, device=dev).reshape(1, 1, 1, -1)
    d, nrm = cylinder_dn(jx.to(torch.float64) + 0.5, jy.to(torch.float64)
                         + 0.5, jz.to(torch.float64) + 0.5, c, a, hl, R)
    vox = (((jx % nx) * ny + jy % ny) * nz + jz).expand(d.shape).reshape(-1)
    fid = torch.as_tensor(idx, device=dev).reshape(-1, 1, 1, 1).expand(
        d.shape).reshape(-1)
    d = d.reshape(-1)
    big = torch.iinfo(torch.int64).max
    old = dmin[vox]
    dmin.scatter_reduce_(0, vox, d, reduce="amin")
    best = d == dmin[vox]
    # ties: the earlier fibre (a later one takes a voxel only where it is
    # strictly closer), against the owner from earlier groups too
    cand = torch.where(best, fid, big)
    prev = torch.where(old == d, owner[vox], big)
    lead = torch.full_like(owner, big)
    lead.scatter_reduce_(0, vox, cand, reduce="amin")
    keep_prev = (prev >= 0) & (prev < lead[vox])
    win = best & (fid == lead[vox]) & ~keep_prev
    owner[vox[win]] = fid[win]
    for i in range(3):
        normals[i, vox[win]] = nrm[i].expand(
            (len(idx),) + tuple(nrm[i].shape[1:])).reshape(-1)[win]
