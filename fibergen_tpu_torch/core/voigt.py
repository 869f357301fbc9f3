"""Voigt-notation helpers.

Tensors are vectors of *tensor* components (fibergen.cpp:19120-19121,
22213-22214):

    dim 3:  [x, y, z]                                (vectors, gradients)
    dim 6:  [xx, yy, zz, yz, xz, xy]                 (symmetric tensors)
    dim 9:  [xx, yy, zz, yz, xz, xy, zy, zx, yx]     (full tensors: the
                                                      deformation gradient)

The shear entries of dim 6 are not doubled, so double contractions weigh
them by 2 (fibergen.cpp:539-575); dim 9 weighs every entry by 1.
"""
from __future__ import annotations

import numpy as np


def weights(dim: int, dtype=np.float64) -> np.ndarray:
    """Double-contraction weights (2 on shear entries for dim 6)."""
    w = np.ones(dim, dtype=dtype)
    if dim == 6:
        w[3:6] = 2.0
    return w


def identity_vec(dim: int, dtype=np.float64) -> np.ndarray:
    """Identity rank-2 tensor as a Voigt vector (zero for dim 3, where a
    plain vector has no identity)."""
    v = np.zeros(dim, dtype=dtype)
    if dim != 3:
        v[0:3] = 1.0
    return v
