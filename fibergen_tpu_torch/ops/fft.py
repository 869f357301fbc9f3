"""Real-to-complex FFT wrappers over the last three axes of a field.

``norm="forward"`` scales the forward transform by 1/N so the DC bin holds
the field mean (fibergen.cpp:18481-18510).  The plain twins use these; on
a card the K3 chain (``ops/spectral_kernels.py``) runs its own transforms.
"""
from __future__ import annotations

import torch

_AXES = (-3, -2, -1)


def fftn(x):
    """Forward FFT of a (ncomp, nx, ny, nz) real field -> (ncomp, nx, ny,
    nz//2+1) complex."""
    return torch.fft.rfftn(x, dim=_AXES, norm="forward")


def ifftn(y, shape):
    """Inverse of :func:`fftn`; ``shape`` is the real-space (nx, ny, nz)."""
    return torch.fft.irfftn(y, s=tuple(shape), dim=_AXES, norm="forward")
