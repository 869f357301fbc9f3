"""Field-level reductions (TensorField average/dot, fibergen.cpp:9549-10286).

Shear components carry a weight of 2 in double contractions for dim-6
fields (fibergen.cpp:20897-20919).

On the x-slabs of a mesh (``parallel/slabs.py``) each reduction is the
mean of the slabs' means added in slab order, a list with the value on
every slab's device, as ``psum`` leaves it on every device of a mesh.
"""
from __future__ import annotations

import math

import torch

from ..parallel import slabs
from ..utils.logging import span
from . import voigt

_SPACE = (-3, -2, -1)


def mean(field):
    """Per-component spatial mean; TensorField::average (fibergen.cpp:10171)."""
    return slabs.vmean(lambda f: f.mean(dim=_SPACE), field)


def component_norm(field):
    """Per-component sqrt(mean(f^2)) (fibergen.cpp:10088-10138)."""
    return slabs.smap(torch.sqrt, slabs.vmean(
        lambda f: (f * f).mean(dim=_SPACE), field))


def _w(dim, like):
    """The Voigt weights on ``like``'s device: a pageable copy from the
    host, which waits for the device (the span ``fg.sync.upload``)."""
    with span("fg.sync.upload"):
        w = torch.as_tensor(voigt.weights(dim), dtype=like.dtype,
                            device=like.device)
    return w.reshape(dim, 1, 1, 1)


def inner_l2(a, b):
    """Voigt-weighted mean inner product sum(a : b)/nxyz
    (innerProductL2, fibergen.cpp:20955-21036)."""
    return slabs.vmean(lambda a, b: (a * _w(a.shape[0], a) * b).sum()
                       / math.prod(a.shape[1:]), a, b)


def inner_l2_diff(a, b, c):
    """sum(a : (b - c))/nxyz (fibergen.cpp:20871-20952)."""
    return slabs.vmean(lambda a, b, c: (a * _w(a.shape[0], a) * (b - c)).sum()
                       / math.prod(a.shape[1:]), a, b, c)


def const_field(grid, values, dtype, device, nx=None):
    """Constant field of shape (len(values), nx, ny, nz), contiguous; ``nx``
    the x extent of an x-slab, the grid's by default."""
    v = torch.as_tensor(values, dtype=dtype, device=device).reshape(-1, 1, 1, 1)
    shape = grid.shape if nx is None else (nx, grid.ny, grid.nz)
    return v.expand((v.shape[0],) + shape).contiguous()
