"""Field-level reductions (TensorField average/dot, fibergen.cpp:9549-10286).

Shear components carry a weight of 2 in double contractions for dim-6
fields (fibergen.cpp:20897-20919).
"""
from __future__ import annotations

import math

import torch

from . import voigt

_SPACE = (-3, -2, -1)


def mean(field):
    """Per-component spatial mean; TensorField::average (fibergen.cpp:10171)."""
    return field.mean(dim=_SPACE)


def component_norm(field):
    """Per-component sqrt(mean(f^2)) (fibergen.cpp:10088-10138)."""
    return torch.sqrt((field * field).mean(dim=_SPACE))


def _w(dim, like):
    return torch.as_tensor(voigt.weights(dim), dtype=like.dtype,
                           device=like.device).reshape(dim, 1, 1, 1)


def inner_l2(a, b):
    """Voigt-weighted mean inner product sum(a : b)/nxyz
    (innerProductL2, fibergen.cpp:20955-21036)."""
    return (a * _w(a.shape[0], a) * b).sum() / math.prod(a.shape[1:])


def inner_l2_diff(a, b, c):
    """sum(a : (b - c))/nxyz (fibergen.cpp:20871-20952)."""
    return (a * _w(a.shape[0], a) * (b - c)).sum() / math.prod(a.shape[1:])


def const_field(grid, values, dtype, device):
    """Constant field of shape (len(values), nx, ny, nz), contiguous."""
    v = torch.as_tensor(values, dtype=dtype, device=device).reshape(-1, 1, 1, 1)
    return v.expand((v.shape[0],) + grid.shape).contiguous()
