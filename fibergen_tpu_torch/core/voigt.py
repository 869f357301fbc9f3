"""Voigt-notation helpers used by the elasticity slice.

Symmetric rank-2 tensors are vectors of *tensor* components in the order
[xx, yy, zz, yz, xz, xy] (fibergen.cpp:19120-19121); the shear entries are
not doubled, so double contractions weigh them by 2 (fibergen.cpp:539-575).
"""
from __future__ import annotations

import numpy as np


def weights(dim: int, dtype=np.float64) -> np.ndarray:
    """Double-contraction weights (2 on shear entries for dim 6)."""
    w = np.ones(dim, dtype=dtype)
    if dim == 6:
        w[3:6] = 2.0
    return w
