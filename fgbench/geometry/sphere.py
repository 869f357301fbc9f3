"""The sphere of ``bench.py``, moved by whole voxels drawn from the seed.

The seed moves the inclusion's centre by whole voxels, a periodic
translation: every seed has the same voxelised shape, the same iterations
and the same work, and other fields.  The field is made on the device.
Plain PyTorch: nothing of the program.
"""
from __future__ import annotations

import torch


def draw(config: dict, rng, shape) -> tuple:
    """The whole-voxel translation of the inclusion (the first draws)."""
    return tuple(int(rng.integers(0, n)) for n in shape)


def fields(config: dict, drawn, shape, device, dtype=torch.float32):
    """The inclusion's indicator on the grid: 1 inside, 0 outside.  The
    sphere of ``bench.py``: voxel centres (i + 0.5) / n - 0.5, inside where
    x^2 + y^2 + z^2 < r^2, then rolled by the translation ``drawn``."""
    r2 = float(config["inclusion"]["radius"]) ** 2
    a2 = [((torch.arange(n, dtype=torch.float64, device=device) + 0.5) / n
           - 0.5) ** 2 for n in shape]
    inside = (a2[0][:, None, None] + a2[1][None, :, None]
              + a2[2][None, None, :]) < r2
    return torch.roll(inside.to(dtype), shifts=tuple(drawn), dims=(0, 1, 2))
