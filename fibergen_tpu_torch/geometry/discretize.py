"""Voxelization: fibres -> per-phase volume-fraction fields on the solver's
device.

Port of fibergen_tpu/geometry/discretize.py up to its mesh contributions,
in PyTorch (the JAX package computes this outside any Pallas kernel).  The
equivalent of LSSolver::initPhi + integratePhiVoxel (fibergen.cpp:16622-16760,
17489-17645): every voxel takes, for every fibre, the volume fraction that
the tangent plane of the fibre surface (signed distance and SDF normal at
the voxel centre) cuts from it, the reference's level-0 composite-voxel
rule, on a grid supersampled ``ss`` times per axis and average-pooled back.
The plane/box cut is the closed-form CDF of a sum of three uniforms (the
reference's halfspace_box_cut_volume, fibergen.cpp:1377-1578).

The fibres are evaluated in groups against an x-slab of the supersampled
grid, a group's (G, slab) temporaries within ``PHI_SLAB_VOXELS`` values, so
that the launches and the memory stay bounded; the contributions add in
fibre order, as the JAX package's scan does.  Mesh primitives are not
ported yet (ROADMAP.md, Queue 1 item 6).
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..core.grid import Grid
from ..utils.logging import LOG
from .primitives import Capsule, Cylinder, Fiber, HalfSpace, pack_fibers

# fibre-distance evaluations of the voxelizer (get_distance_evals,
# fibergen.cpp:25087): one per primitive per (supersampled) voxel
DIST_EVALS = 0

# values of one (group, slab) temporary: the x-slab sweep engages when the
# supersampled grid exceeds it, and a group holds as many fibres as fit
PHI_SLAB_VOXELS = 2 ** 27


def reset_distance_evals():
    global DIST_EVALS
    DIST_EVALS = 0


def _check_primitives(fibers):
    for f in fibers:
        if not isinstance(f, (Capsule, Cylinder, HalfSpace)):
            raise NotImplementedError(
                f"{type(f).__name__}: mesh primitives are not ported yet "
                f"(ROADMAP.md, Queue 1 item 6)")


def _axis(n, d, o, ss):
    """Supersampled voxel-centre coordinates of one axis (float64)."""
    return o + (np.arange(n * ss) + 0.5) * (d / (n * ss))


def _coords(grid: Grid, ss, dtype, device, rows=None):
    """Coordinates broadcastable over (group, x, y, z); ``rows`` a slice of
    the supersampled x axis."""
    x = _axis(grid.nx, grid.dx, grid.x0[0], ss)
    if rows is not None:
        x = x[rows]
    t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
    return (t(x).reshape(1, -1, 1, 1),
            t(_axis(grid.ny, grid.dy, grid.x0[1], ss)).reshape(1, 1, -1, 1),
            t(_axis(grid.nz, grid.dz, grid.x0[2], ss)).reshape(1, 1, 1, -1))


def plane_cut_fraction(d, n0, n1, n2, h):
    """Volume fraction of a voxel with edges h = (h0, h1, h2) on the inside
    (negative) side of a plane at signed distance d from the voxel centre
    with unit normal n (tensors that broadcast together).

    P(U0 + U1 + U2 <= -d) with U_i ~ Uniform(-a_i, a_i), a_i = |n_i| h_i / 2,
    evaluated as a nested central difference of relu(x)^3 with the limits
    of each regime, so that axis-aligned normals lose no digits to
    cancellation (halfspace_box_cut_volume, fibergen.cpp:1377-1578)."""
    b0 = torch.abs(n0) * (0.5 * h[0])
    b1 = torch.abs(n1) * (0.5 * h[1])
    b2 = torch.abs(n2) * (0.5 * h[2])
    # a0 the largest width (the outer difference), a2 the smallest, the
    # minor widths floored relative to a0
    a0 = torch.maximum(b0, torch.maximum(b1, b2))
    amin = torch.minimum(b0, torch.minimum(b1, b2))
    amid = (b0 + b1 + b2) - a0 - amin
    rel_eps = 1e-6
    a1 = torch.maximum(amid, rel_eps * a0)
    a2 = torch.maximum(amin, rel_eps * a0)
    t = -d
    zero = torch.zeros((), dtype=d.dtype, device=d.device)

    def k(y):
        """Delta_{a2} relu(y)^3: the polynomial away from the kink."""
        quad = 2.0 * a2 * (3.0 * y * y + a2 * a2)
        r = torch.clamp(y + a2, min=0.0)
        return torch.where(y >= a2, quad,
                           torch.where(y <= -a2, zero, r * r * r))

    def hfun(x):
        """(Delta_{a1} Delta_{a2} relu^3)(x) / (24 a1 a2): x in the linear
        regime, 0 below, the nested differences near the kink."""
        inner = (k(x + a1) - k(x - a1)) / (24.0 * a1 * a2)
        return torch.where(x >= a1 + a2, x,
                           torch.where(x <= -(a1 + a2), zero, inner))

    f = (hfun(t + a0) - hfun(t - a0)) / (2.0 * a0)
    return torch.clamp(f, 0.0, 1.0)


def _capsule_dn(x, y, z, c, a, hl, R, flat):
    """Signed distance and outward normal of a group of capsule/cylinder
    fibres at broadcast coordinates: ``c``, ``a`` three (G, 1, 1, 1)
    tensors each, ``hl``, ``R`` (G, 1, 1, 1); ``flat`` False (capsules),
    True (cylinders, flat caps) or a (G, 1, 1, 1) bool tensor."""
    qx, qy, qz = x - c[0], y - c[1], z - c[2]
    t = qx * a[0] + qy * a[1] + qz * a[2]
    out_cap = out_cyl = None
    if flat is not True:
        # capsule: distance to the core segment
        tc = torch.clamp(t, -hl, hl)
        dx_, dy_, dz_ = qx - tc * a[0], qy - tc * a[1], qz - tc * a[2]
        r = torch.sqrt(dx_ * dx_ + dy_ * dy_ + dz_ * dz_)
        rs = torch.clamp(r, min=1e-30)
        out_cap = (r - R, (dx_ / rs, dy_ / rs, dz_ / rs))
    if flat is not False:
        # cylinder: radial and axial parts with flat caps
        rx, ry, rz = qx - t * a[0], qy - t * a[1], qz - t * a[2]
        rr = torch.sqrt(rx * rx + ry * ry + rz * rz)
        dr = rr - R
        da = torch.abs(t) - hl
        u = torch.clamp(dr, min=0.0)
        v = torch.clamp(da, min=0.0)
        d_out = torch.sqrt(u * u + v * v)
        d_cyl = d_out + torch.clamp(torch.maximum(dr, da), max=0.0)
        rrs = torch.clamp(rr, min=1e-30)
        sa = torch.sign(t)
        outside = d_out > 0
        dos = torch.clamp(d_out, min=1e-30)
        wr = torch.where(outside, u / dos, (dr >= da).to(rr.dtype))
        wa = torch.where(outside, v / dos, (dr < da).to(rr.dtype))
        out_cyl = (d_cyl, (wr * rx / rrs + wa * sa * a[0],
                           wr * ry / rrs + wa * sa * a[1],
                           wr * rz / rrs + wa * sa * a[2]))
    if out_cyl is None:
        return out_cap
    if out_cap is None:
        return out_cyl
    return (torch.where(flat, out_cyl[0], out_cap[0]),
            tuple(torch.where(flat, nc, nk)
                  for nc, nk in zip(out_cyl[1], out_cap[1])))


class _Packed:
    """The capsule/cylinder fibres' parameters on the device, in fibre
    order, each (F, 1, 1, 1)."""

    def __init__(self, fibers, dtype, device):
        p = pack_fibers(fibers)
        self.count = 0 if p is None else p.count
        if p is None:
            return
        t = lambda v, dt=dtype: torch.as_tensor(v, dtype=dt, device=device
                                                ).reshape(-1, 1, 1, 1)
        self.c = [t(p.centers[:, i]) for i in range(3)]
        self.a = [t(p.axes[:, i]) for i in range(3)]
        self.hl, self.R = t(p.half_lengths), t(p.radii)
        self.flat_np = p.flat
        self.flat = t(p.flat, torch.bool)
        self.axes = p.axes

    def dn(self, x, y, z, g0, g1):
        """_capsule_dn of fibres g0:g1."""
        s = slice(g0, g1)
        fl = self.flat_np[s]
        flat = bool(fl[0]) if fl.all() or not fl.any() else self.flat[s]
        return _capsule_dn(x, y, z, [c[s] for c in self.c],
                           [a[s] for a in self.a], self.hl[s], self.R[s],
                           flat)


def _group(count, voxels):
    """Fibres per group against ``voxels`` values."""
    return max(1, min(count, PHI_SLAB_VOXELS // max(1, voxels)))


def _halfspace_d(f, x, y, z):
    """Signed distance to a half space and its unit normal (floats)."""
    nv = np.asarray(f.normal, dtype=np.float64)
    nv = nv / np.linalg.norm(nv)
    d = ((x - float(f.point[0])) * float(nv[0])
         + (y - float(f.point[1])) * float(nv[1])
         + (z - float(f.point[2])) * float(nv[2]))
    return d, nv


def _pool_ss(phi, ss):
    """Average-pool by ss per axis, the strided slices summed in the JAX
    package's order."""
    acc = None
    for a in range(ss):
        for b in range(ss):
            for c in range(ss):
                s = phi[a::ss, b::ss, c::ss]
                acc = s if acc is None else acc + s
    return acc / float(ss ** 3)


def _phi_slab(grid, packed, halfspaces, rows, h, ss, dtype, device):
    x, y, z = _coords(grid, ss, dtype, device, rows)
    shape = (x.shape[1], y.shape[2], z.shape[3])
    phi = torch.zeros(shape, dtype=dtype, device=device)
    G = _group(packed.count, int(np.prod(shape)))
    for g0 in range(0, packed.count, G):
        g1 = min(g0 + G, packed.count)
        d, n = packed.dn(x, y, z, g0, g1)
        frac = plane_cut_fraction(d, n[0], n[1], n[2], h)
        del d, n
        for g in range(g1 - g0):
            phi += frac[g]
        del frac
    for f in halfspaces:
        d, nv = _halfspace_d(f, x, y, z)
        n = [torch.tensor(float(v), dtype=dtype, device=device) for v in nv]
        phi += plane_cut_fraction(d, n[0], n[1], n[2], h)[0]
    phi = torch.clamp(phi, 0.0, 1.0)
    return _pool_ss(phi, ss) if ss > 1 else phi


def phi_field(grid: Grid, fibers: List[Fiber], supersample: int = 1,
              dtype=torch.float32, device="cpu"):
    """Volume-fraction field (nx, ny, nz) of a set of same-material fibres,
    their contributions summed and clamped like integratePhiVoxel
    (fibergen.cpp:16681-16704).  A supersampled grid of more than
    PHI_SLAB_VOXELS voxels is swept in x-slabs."""
    global DIST_EVALS
    _check_primitives(fibers)
    ss = max(1, int(supersample))
    DIST_EVALS += len(fibers) * int(np.prod(grid.shape)) * ss ** 3
    h = (grid.dx / (grid.nx * ss), grid.dy / (grid.ny * ss),
         grid.dz / (grid.nz * ss))
    packed = _Packed(fibers, dtype, device)
    halfspaces = [f for f in fibers if isinstance(f, HalfSpace)]
    nvox_ss = int(np.prod(grid.shape)) * ss ** 3
    sx = grid.nx
    if nvox_ss > PHI_SLAB_VOXELS:
        # the largest divisor of nx whose slab fits the budget
        max_rows = max(1, PHI_SLAB_VOXELS // (ss ** 3 * grid.ny * grid.nz))
        sx = max(d for d in range(1, max_rows + 1) if grid.nx % d == 0)
        LOG.info(f"phi voxelization in {grid.nx // sx} x-slabs of {sx} rows "
                 f"(supersampled grid {nvox_ss} voxels)")
    outs = [_phi_slab(grid, packed, halfspaces, slice(i * ss, (i + sx) * ss),
                      h, ss, dtype, device)
            for i in range(0, grid.nx, sx)]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)


def voxelize(grid: Grid, fibers: List[Fiber], n_materials: int,
             matrix_material: int = 0, supersample: int = 1,
             dtype=torch.float32, device="cpu") -> List[torch.Tensor]:
    """Per-material volume-fraction fields, the matrix filled and the set
    normalized (initPhi + normalizePhi, fibergen.cpp:17489-17645: later
    materials take priority, the matrix gets the remainder)."""
    phis = []
    for m in range(n_materials):
        if m == matrix_material:
            phis.append(torch.ones(grid.shape, dtype=dtype, device=device))
        else:
            fl = [f for f in fibers if f.material == m]
            phis.append(phi_field(grid, fl, supersample, dtype, device) if fl
                        else torch.zeros(grid.shape, dtype=dtype,
                                         device=device))
    return normalize_phi(phis)


def normalize_phi(phis: List[torch.Tensor]) -> List[torch.Tensor]:
    """Sum_m phi_m = 1 with priority to later materials (normalizePhi,
    fibergen.cpp:17588-17645); logs each volume fraction (one host read)."""
    rem = torch.ones_like(phis[0])
    out = [None] * len(phis)
    for m in range(len(phis) - 1, -1, -1):
        vol = torch.minimum(rem, phis[m])
        out[m] = vol
        rem = rem - vol
    if LOG.enabled:
        vols = torch.stack([p.mean() for p in out]).cpu().numpy()
        for m, v in enumerate(vols):
            LOG.info(f"material {m} volume fraction: {v:.6f}")
    return out


def _translation_of(f) -> np.ndarray:
    t = getattr(f, "translation", None)
    return np.zeros(3) if t is None else np.asarray(t, dtype=np.float64)


def geometry_fields(grid: Grid, fibers: List[Fiber], dtype=torch.float32,
                    device="cpu"):
    """Distance, normals, orientation, fiber_id, material_id and
    fiber_translation of the closest fibre at each voxel centre
    (get_raw_field's derived fields, fibergen.cpp:15396-15695;
    fiber_translation is the periodic-clone offset of the closest fibre,
    :6865-6884).  The fibres are taken in order, a later one where it is
    strictly closer, capsules and cylinders first, then half spaces."""
    global DIST_EVALS
    _check_primitives(fibers)
    x, y, z = _coords(grid, 1, dtype, device)
    shape = grid.shape
    nvox = int(np.prod(shape))
    kw = dict(dtype=dtype, device=device)
    dmin = torch.full(shape, torch.finfo(dtype).max / 4, **kw)
    normal = torch.zeros((3,) + shape, **kw)
    orient = torch.zeros((3,) + shape, **kw)
    fid = torch.full(shape, -1, dtype=torch.int32, device=device)
    mid = torch.full(shape, -1, dtype=torch.int32, device=device)
    trans = torch.zeros((3,) + shape, **kw)

    def take_closest(d, n, o, i, m, tr):
        nonlocal dmin, normal, orient, fid, mid, trans
        take = d < dmin
        dmin = torch.where(take, d, dmin)
        normal = torch.where(take, n, normal)
        orient = torch.where(take, o, orient)
        fid = torch.where(take, i, fid)
        mid = torch.where(take, m, mid)
        trans = torch.where(take, tr, trans)

    col = lambda v: torch.as_tensor(np.asarray(v, dtype=np.float64), **kw
                                    ).reshape(3, 1, 1, 1)
    caps = [f for f in fibers if isinstance(f, (Capsule, Cylinder))]
    packed = _Packed(fibers, dtype, device)
    DIST_EVALS += len(caps) * nvox
    G = _group(packed.count, nvox)
    for g0 in range(0, packed.count, G):
        g1 = min(g0 + G, packed.count)
        d, n = packed.dn(x, y, z, g0, g1)
        for g in range(g1 - g0):
            f = caps[g0 + g]
            take_closest(d[g], torch.stack([c[g] for c in n]),
                         col(packed.axes[g0 + g]), f.fiber_id, f.material,
                         col(_translation_of(f)))
        del d, n
    for f in fibers:
        if isinstance(f, HalfSpace):
            DIST_EVALS += nvox
            d, nv = _halfspace_d(f, x, y, z)
            take_closest(d[0], col(nv), col(nv), f.fiber_id, f.material,
                         col(_translation_of(f)))
    return {"distance": dmin, "normals": normal, "orientation": orient,
            "fiber_id": fid, "material_id": mid,
            "fiber_translation": trans}
