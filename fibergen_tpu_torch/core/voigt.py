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

# (row, column) of each Voigt component in the 3x3 matrix
VI = {3: np.array([0, 1, 2]), 6: np.array([0, 1, 2, 1, 0, 0]),
      9: np.array([0, 1, 2, 1, 0, 0, 2, 2, 1])}
VJ = {3: np.array([0, 1, 2]), 6: np.array([0, 1, 2, 2, 2, 1]),
      9: np.array([0, 1, 2, 2, 2, 1, 1, 0, 0])}


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


def id4(dim: int, dtype=np.float64) -> np.ndarray:
    """Fourth-order identity as a Voigt matrix (fibergen.cpp:500-512); for
    dim 6 the shear diagonal is 1/2, so that dyad4_mv(id4, v) == v."""
    m = np.eye(dim, dtype=dtype)
    if dim == 6:
        m[3, 3] = m[4, 4] = m[5, 5] = 0.5
    return m


def ii4(dim: int, dtype=np.float64) -> np.ndarray:
    """I (x) I as a Voigt matrix (fibergen.cpp:517-525)."""
    m = np.zeros((dim, dim), dtype=dtype)
    m[0:3, 0:3] = 1.0
    return m


def dyad4_mv(M, v):
    """Voigt matrix times Voigt vector, shear doubled (fibergen.cpp:563-575)."""
    return M @ (v * weights(M.shape[1]))


def dyad4_mm(A, B):
    """Voigt matrix product, shear doubled (fibergen.cpp:582-597)."""
    return A @ (B * weights(A.shape[1])[:, None])


def dyad_vv(a, b):
    """Double contraction of two Voigt vectors (fibergen.cpp:544-556)."""
    return (a * weights(a.shape[-1]) * b).sum(-1)


def norm_2(v) -> float:
    """Tensor 2-norm of a Voigt vector (fibergen.cpp:530-537)."""
    return float(np.sqrt(dyad_vv(v, v)))


def to_matrix(v) -> np.ndarray:
    """A Voigt vector (dim 6 or 9, leading axes kept) as a 3x3 matrix."""
    v = np.asarray(v)
    dim = v.shape[-1]
    m = np.zeros(v.shape[:-1] + (3, 3), dtype=v.dtype)
    for k in range(dim):
        m[..., VI[dim][k], VJ[dim][k]] = v[..., k]
        if dim == 6:
            m[..., VJ[dim][k], VI[dim][k]] = v[..., k]
    return m


def from_matrix(m, dim: int) -> np.ndarray:
    """A 3x3 matrix as a Voigt vector of ``dim`` (symmetrized for dim 6)."""
    m = np.asarray(m)
    out = np.zeros(m.shape[:-2] + (dim,), dtype=m.dtype)
    for k in range(dim):
        i, j = VI[dim][k], VJ[dim][k]
        out[..., k] = 0.5 * (m[..., i, j] + m[..., j, i]) if dim == 6 \
            else m[..., i, j]
    return out


def expand_6_to_9(v):
    """The shear entries duplicated, [a..f] -> [a..f, d, e, f]
    (fibergen.cpp:12117-12121), on a numpy array or a torch tensor."""
    if isinstance(v, np.ndarray):
        return np.concatenate([v, v[..., 3:6]], axis=-1)
    import torch
    return torch.cat([v, v[..., 3:6]], dim=-1)


def expand_matrix_6_to_9(M: np.ndarray) -> np.ndarray:
    """A symmetric 6x6 Voigt matrix extended to 9x9: index i >= 6 maps to
    i - 3 (fibergen.cpp:26632-26639)."""
    idx = [0, 1, 2, 3, 4, 5, 3, 4, 5]
    return M[np.ix_(idx, idx)].copy()


def reduce_matrix_9_to_6(M: np.ndarray) -> np.ndarray:
    """A 9x9 matrix reduced to a symmetric 6x6 one by averaging the
    duplicated shear rows and columns (fibergen.cpp:20653-20662)."""
    M = M.copy()
    for i in range(3):
        for j in range(6):
            M[j, 3 + i] = 0.5 * (M[j, 3 + i] + M[j, 6 + i])
            M[3 + i, j] = 0.5 * (M[3 + i, j] + M[6 + i, j])
    return M[:6, :6]
