"""The arithmetic of the JAX package's FG front end that the port needs
before FG itself is ported: the effective viscosity of the five traceless
load cases (FG._effective_viscosity, fibergen.cpp:26252-26399).

Run the cases through a viscosity solver, e.g.
``s.run_batched(VISCOSITY_CASES)``, then hand
``s.calc_mean_stress_batched()`` to :func:`effective_viscosity`.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# the five traceless unit cases as rows (Voigt, tensor shears):
# e_xx - e_yy, e_yy - e_zz, e_yz, e_xz, e_xy
VISCOSITY_CASES = np.array([[1.0, -1, 0, 0, 0, 0], [0, 1.0, -1, 0, 0, 0],
                            [0, 0, 0, 1.0, 0, 0], [0, 0, 0, 0, 1.0, 0],
                            [0, 0, 0, 0, 0, 1.0]])


@dataclasses.dataclass
class EffectiveViscosity:
    """``C55``: the effective viscosity "2 eta" on the five traceless
    components (yy, zz, yz, xz, xy); ``C``: the 6x6 in Voigt notation
    (shear columns halved); ``alpha``, ``beta``: the Nunan-Keller
    coefficients, the means over the six off-diagonal index pairs."""

    C55: np.ndarray
    C: np.ndarray
    alpha: float
    beta: float


def effective_viscosity(S, matrix_fluidity) -> EffectiveViscosity:
    """The effective viscosity from the (5, 6) mean stresses ``S`` (Voigt,
    tensor shears) of :data:`VISCOSITY_CASES` in order, and the Nunan-Keller
    alpha and beta against the matrix phase's law fluidity
    ``matrix_fluidity`` (the law's ``mu``; a project file's viscosity
    ``mu`` is scaled by 0.5 when the law is made, and 0.5 / mu is the
    matrix viscosity "2 eta")."""
    E = VISCOSITY_CASES.T
    S = np.asarray(S, dtype=np.float64).T
    C55 = E[1:6] @ np.linalg.inv(S[1:6])
    C = np.zeros((6, 6))
    C[1:6, 1:6] = C55
    for i in range(5):
        if S[0, i] != 0:
            for j in range(1, 6):
                C[j, 0] = (E[j, i] - C[j, 1:6] @ S[1:6, i]) / S[0, i]
            break
    C[0, :] = -(C[1, :] + C[2, :])
    for i in range(6):
        C[i, 0:3] -= C[i, 0:3].min()
    C[:, 3:6] *= 0.5
    v = [[0, 5, 4], [5, 1, 3], [4, 3, 2]]
    mu0 = 0.5 / matrix_fluidity
    alphas, betas = [], []
    for i in range(3):
        for j in range(3):
            if i != j:
                betas.append(C[v[i][j]][v[i][j]] / mu0 - 1.0)
                alphas.append(0.5 * C[v[i][i]][v[i][i]] / mu0
                              - 0.5 * C[v[i][i]][v[j][j]] / mu0 - 1.0)
    return EffectiveViscosity(C55, C, float(np.mean(alphas)),
                              float(np.mean(betas)))
