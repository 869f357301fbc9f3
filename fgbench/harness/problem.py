"""A cell's inputs from its configuration and ``--seed``: the phase field,
the load cases and the order in which they are sent.

The seed moves the inclusion's centre by whole voxels, a periodic
translation: every seed has the same voxelised shape, the same iterations
and the same work, and other fields.  The field is made on the device.
"""
from __future__ import annotations

import numpy as np
import torch

DIM = {"elasticity": 6, "heat": 3}


def rng_of(seed: int) -> np.random.Generator:
    return np.random.default_rng(int(seed) % 2 ** 64)


def shift_of(config: dict, rng: np.random.Generator, shape) -> tuple:
    """The whole-voxel translation of the inclusion (the first draws)."""
    return tuple(int(rng.integers(0, n)) for n in shape)


def phase_field(config: dict, shift, shape, device, dtype=torch.float32):
    """The inclusion's indicator on the grid: 1 inside, 0 outside.  The
    sphere of ``bench.py``: voxel centres (i + 0.5) / n - 0.5, inside where
    x^2 + y^2 + z^2 < r^2, then rolled by ``shift``."""
    inc = config["inclusion"]
    if inc["shape"] != "sphere":
        raise ValueError(f"unknown inclusion shape {inc['shape']!r}")
    r2 = float(inc["radius"]) ** 2
    a2 = [((torch.arange(n, dtype=torch.float64, device=device) + 0.5) / n
           - 0.5) ** 2 for n in shape]
    inside = (a2[0][:, None, None] + a2[1][None, :, None]
              + a2[2][None, None, :]) < r2
    return torch.roll(inside.to(dtype), shifts=tuple(shift), dims=(0, 1, 2))


def load_cases(config: dict, traffic: dict) -> np.ndarray:
    """(n_cases, dim) load vectors of the traffic's ``load_cases``."""
    dim = DIM[config["mode"]]
    if traffic["load_cases"] != "unit":
        raise ValueError(f"unknown load_cases {traffic['load_cases']!r}")
    return np.eye(dim)


def region(phi, where):
    return phi if where == "inside" else 1.0 - phi
