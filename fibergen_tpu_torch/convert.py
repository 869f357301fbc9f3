"""Build the port's objects from plain numpy values.

A problem set up elsewhere (for instance with the JAX package) carries
across as numbers and arrays: the grid's shape and cell, each phase's
moduli and volume-fraction array, and the solver options as a dict.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.device import resolve_device
from .core.grid import Grid
from .materials.laws import LinearIsotropic, ScalarLinearIsotropic
from .materials.mixing import Phase, VoigtMixed
from .solvers.ls import SolverOptions


def grid_from_numpy(shape, cell=(1.0, 1.0, 1.0)) -> Grid:
    """Grid of ``shape`` voxels over a cell of edge lengths ``cell``."""
    nx, ny, nz = (int(n) for n in shape)
    dx, dy, dz = (float(d) for d in cell)
    return Grid(nx, ny, nz, dx=dx, dy=dy, dz=dz)


def material_from_numpy(phases, dim=6, device=None, law="isotropic"
                        ) -> VoigtMixed:
    """VoigtMixed from numpy phases, moved to ``device`` (default ``cuda``;
    raises without a card unless ``device="cpu"``).  ``phi`` is a
    (nx, ny, nz) numpy array and keeps its numpy dtype.

    * ``law="isotropic"``: ``[(name, mu, lam, phi), ...]``, LinearIsotropic
      phases (elasticity, dim 6);
    * ``law="scalar"``: ``[(name, mu, phi), ...]``, ScalarLinearIsotropic
      phases (sigma = mu E): heat and porous flow with ``dim=3``, viscosity
      (mu the fluidity) with ``dim=6``."""
    dev = resolve_device(device)
    if law not in ("isotropic", "scalar"):
        raise ValueError(f"law must be 'isotropic' or 'scalar', got {law!r}")
    out = []
    for name, *moduli, phi in phases:
        t = torch.as_tensor(np.array(phi, order="C"), device=dev)
        if law == "scalar":
            (mu,) = moduli
            pl = ScalarLinearIsotropic(mu=float(mu), dim=dim)
        else:
            mu, lam = moduli
            pl = LinearIsotropic(mu=float(mu), lam=float(lam), dim=dim)
        out.append(Phase(str(name), pl, t))
    return VoigtMixed(out, dim=dim)


def options_from_dict(d) -> SolverOptions:
    """SolverOptions from a dict of option names to values (unknown names
    raise TypeError)."""
    return SolverOptions(**dict(d))
