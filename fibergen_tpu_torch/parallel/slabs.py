"""A value held whole or as the x-slabs of a mesh, and the ops that take
either.

This module is the one place that tells the two layouts apart.  A sharded
field is a list of x-slabs, slab i on the mesh's device i; a sharded
scalar or vector is a list with the value on every slab's device, as
:func:`.comm.psum` leaves it.  A whole value is one tensor.  Code that runs
on either layout maps its per-voxel work with :func:`smap`, reduces with
:func:`vmean` or :func:`fold`, and reads a replicated value with
:func:`local`.
"""
from __future__ import annotations

from . import comm, gather_field


def sharded(x) -> bool:
    """Whether ``x`` is held as slabs (a list, one entry per slab)."""
    return isinstance(x, list)


def part(x, i):
    """Slab i of a sharded value; a whole value as it is."""
    return x[i] if sharded(x) else x


def local(x):
    """The first slab's entry of a sharded value (the value itself for a
    replicated one); a whole value as it is."""
    return part(x, 0)


def smap(fn, *args):
    """``fn(*args)`` on whole values.  Where an argument is sharded, the
    list of ``fn`` applied slab by slab: each sharded argument gives its
    slab, the others are passed as they are."""
    n = next((len(a) for a in args if sharded(a)), None)
    if n is None:
        return fn(*args)
    return [fn(*(part(a, i) for a in args)) for i in range(n)]


def vmean(fn, *args):
    """A mean over the voxels: ``fn`` returns the mean over the voxels of
    the (slabs of the) fields it is given.  Whole, ``fn(*args)``; sharded,
    the slabs' means averaged in slab order (the slabs are of equal size),
    on every slab's device."""
    parts = smap(fn, *args)
    if not sharded(parts):
        return parts
    return [s / len(parts) for s in comm.psum(parts)]


def fold(op, parts):
    """``op`` (e.g. ``torch.minimum``) folded over per-slab values in slab
    order on the first slab's device; a whole value as it is."""
    if not sharded(parts):
        return parts
    out = parts[0]
    for p in parts[1:]:
        out = op(out, p.to(out.device))
    return out


def whole(x, device=None):
    """A sharded field gathered into one tensor; a whole one as it is.  On
    ``device`` when given."""
    if sharded(x):
        return gather_field(x, device)
    return x if device is None else x.to(device)
