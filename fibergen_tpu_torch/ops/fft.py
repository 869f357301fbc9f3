"""Real-to-complex FFT wrappers over the last three axes of a field.

``norm="forward"`` scales the forward transform by 1/N so the DC bin holds
the field mean (fibergen.cpp:18481-18510).  The plain twins use these; on
a card the chains of ``ops/spectral_kernels.py`` run their own transforms.
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


def fftn_zero_trace(x):
    """Forward FFT of a traceless (6, nx, ny, nz) field: components 1..
    are transformed, component 0 is rebuilt as -(c1 + c2) in the Fourier
    domain (fibergen.cpp:18531-18560, the viscosity Delta scheme)."""
    y = fftn(x[1:])
    return torch.cat([-(y[0] + y[1])[None], y])


def ifftn_zero_trace(y, shape):
    """Inverse of :func:`fftn_zero_trace`: components 1.. are inverted and
    component 0 is rebuilt as -(c1 + c2) (fibergen.cpp:18563-18584)."""
    x = ifftn(y[1:], shape)
    return torch.cat([-(x[0] + x[1])[None], x])
