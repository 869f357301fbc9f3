"""Build the port's objects from plain numpy values.

A problem set up elsewhere (for instance with the JAX package) carries
across as numbers and arrays: the grid's shape and cell, each phase's law,
moduli and volume-fraction array, the mixing rule, and the solver options
as a dict.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.device import resolve_device
from .core.grid import Grid
from .materials import laws
from .materials.mixing import MixedMaterial, Phase, make_mixed
from .solvers.ls import SolverOptions


def grid_from_numpy(shape, cell=(1.0, 1.0, 1.0)) -> Grid:
    """Grid of ``shape`` voxels over a cell of edge lengths ``cell``."""
    nx, ny, nz = (int(n) for n in shape)
    dx, dy, dz = (float(d) for d in cell)
    return Grid(nx, ny, nz, dx=dx, dy=dy, dz=dz)


_LAWS = ("isotropic", "scalar", "general", "tiso", "aniso", "svk",
         "neohooke", "neohooke2")


def _law(law, moduli, dim, dev):
    if law == "scalar":
        (mu,) = moduli
        return laws.ScalarLinearIsotropic(mu=float(mu), dim=dim)
    if law == "isotropic":
        mu, lam = moduli
        return laws.LinearIsotropic(mu=float(mu), lam=float(lam), dim=dim)
    if law in ("general", "aniso"):
        (M,) = moduli
        M = np.asarray(M, dtype=np.float64)
        n = 6 if law == "general" else 3
        if M.shape != (n, n):
            raise ValueError(f"law {law!r} takes a {n}x{n} matrix, got shape "
                             f"{M.shape}")
        return laws.LinearGeneral(C=M) if law == "general" else \
            laws.MatrixLinearAnisotropic(K=M)
    if law == "tiso":
        params, axis = moduli
        axis = np.asarray(axis)
        kw = {k: float(v) for k, v in params.items()}
        if axis.shape == (3,):
            return laws.LinearTransverselyIsotropic(
                a=axis.astype(np.float64), **kw)
        return laws.LinearTransverselyIsotropic(orientation=torch.as_tensor(
            np.array(axis, order="C"), device=dev), **kw)
    if law in ("svk", "neohooke"):
        mu, lam = moduli
        cls = laws.SaintVenantKirchhoff if law == "svk" else laws.NeoHooke
        return cls(mu=float(mu), lam=float(lam))
    if law == "neohooke2":
        mu, K = moduli
        return laws.NeoHooke2(mu=float(mu), K=float(K))
    (params,) = moduli
    return laws.GOLDBERG_LAWS[law](**{k: float(v) for k, v in params.items()})


def _check_law(law):
    if law not in _LAWS and law not in laws.GOLDBERG_LAWS:
        raise ValueError(f"unknown law {law!r}")


def material_from_numpy(phases, dim=6, device=None, law="isotropic",
                        rule="voigt", normals=None) -> MixedMaterial:
    """The mixed material of numpy phases under the mixing ``rule`` (any
    name of ``mixing.make_mixed``), moved to ``device`` (default ``cuda``;
    raises without a card unless ``device="cpu"``).  ``phi`` is a
    (nx, ny, nz) numpy array and keeps its numpy dtype.  ``normals``, a
    (3, nx, ny, nz) array of interface normals pointing from the second
    phase into the first, is the laminate, infinity-laminate and fluidity
    rules' field; it moves to ``device`` in its numpy dtype.  The
    ``half_staggered`` and ``full_staggered`` schemes take phases (and
    normals) given on the doubly-fine (2nx, 2ny, 2nz) grid of the solve's
    (nx, ny, nz) grid, in a ``dfg.DfgMaterial`` around the result:
    ``DfgMaterial(material_from_numpy(...))``, as the JAX package's FG
    wraps its material.  Each phase is
    ``(name, *moduli, phi)`` with the moduli of ``law``:

    * ``law="isotropic"``: ``(name, mu, lam, phi)``, LinearIsotropic
      phases (elasticity, dim 6);
    * ``law="scalar"``: ``(name, mu, phi)``, ScalarLinearIsotropic phases
      (sigma = mu E): heat and porous flow with ``dim=3``, viscosity (mu
      the fluidity) with ``dim=6``;
    * ``law="general"``: ``(name, C, phi)``, a 6x6 Voigt stiffness
      (LinearGeneral, dim 6); ``law="aniso"``: ``(name, K, phi)``, a 3x3
      conductivity (MatrixLinearAnisotropic, dim 3);
    * ``law="tiso"``: ``(name, {E, nu, E_a, G_a, nu_a}, axis, phi)``,
      LinearTransverselyIsotropic about the fixed ``axis`` (3 values) or
      the per-voxel unit field ``axis`` of shape (3, nx, ny, nz), which
      moves to ``device`` in its numpy dtype;
    * hyperelasticity, ``dim=9``: ``law="svk"`` or ``"neohooke"`` with
      ``(name, mu, lam, phi)``, ``law="neohooke2"`` with
      ``(name, mu, K, phi)``, and any key of ``laws.GOLDBERG_LAWS`` with
      ``(name, {param: value}, phi)``.

    A phase may name its own law instead: ``(name, (law, *moduli), phi)``,
    e.g. ``("fibre", ("tiso", {...}, [1, 0, 0]), phi)`` beside
    ``("matrix", ("isotropic", mu, lam), phi)``."""
    dev = resolve_device(device)
    _check_law(law)
    out = []
    for name, *moduli, phi in phases:
        kind = law
        if len(moduli) == 1 and isinstance(moduli[0], tuple) \
                and isinstance(moduli[0][0], str):
            kind, *moduli = moduli[0]
            _check_law(kind)
        t = torch.as_tensor(np.array(phi, order="C"), device=dev)
        out.append(Phase(str(name), _law(kind, moduli, dim, dev), t))
    mat = make_mixed(rule, out, dim=dim)
    if normals is not None:
        if not hasattr(mat, "normals"):
            raise ValueError(f"the {rule} mixing rule takes no normals")
        mat.normals = torch.as_tensor(np.array(normals, order="C"),
                                      device=dev)
    return mat


def options_from_dict(d) -> SolverOptions:
    """SolverOptions from a dict of option names to values (unknown names
    raise TypeError)."""
    return SolverOptions(**dict(d))
