"""Mixed boundary conditions: the strain-control projector.

Port of fibergen_tpu/solvers/bc.py (setBCProjector / calcBCMean /
applyBCProjector, fibergen.cpp:20599-20712, 20220-20279).  A symmetric
idempotent Voigt projector P selects the strain-controlled subspace, Q = I -
P the stress-controlled one.  Each Gamma application corrects its mean with
the C0-weighted Moore-Penrose pseudo-inverse M of Q:C0:Q, computed through
the reference's 6 -> 9 -> 6 symmetrization.

The matrices are numpy on the host; :meth:`BCProjector.on` hands a solve
the one it applies per step as a small tensor on its device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import voigt


@dataclasses.dataclass
class BCProjector:
    """Host matrices of a projector (Voigt, tensor shear components;
    products use the dyad4 shear doubling)."""

    P: np.ndarray
    Q: np.ndarray
    QC0: np.ndarray
    M: np.ndarray
    MQ: np.ndarray
    bc_relax: float = 1.0
    _tensors: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def dim(self):
        return self.P.shape[0]

    @property
    def is_trivial(self):
        """True for P == Id (pure strain control): M == 0, no correction."""
        return not np.any(self.MQ)

    def on(self, dtype, device):
        """M:Q with the shear weights folded in (``MQ @ F0`` is
        dyad4_mv(MQ, F0)) as a tensor of ``dtype`` on ``device``, made once
        per dtype and device."""
        key = (dtype, torch.device(device))
        if key not in self._tensors:
            self._tensors[key] = torch.as_tensor(
                self.MQ * voigt.weights(self.dim)[None, :], dtype=dtype,
                device=device)
        return self._tensors[key]


def make_bc_projector(P, mu_0: float, lambda_0: float,
                      bc_relax: float = 1.0) -> BCProjector:
    """The projector's matrices for the reference material (mu_0,
    lambda_0) (setBCProjector, fibergen.cpp:20599-20665)."""
    P = np.asarray(P, dtype=np.float64)
    dim = P.shape[0]
    eps = np.sqrt(np.finfo(np.float64).eps)
    if P.shape[1] != dim or np.linalg.norm(P - P.T) > eps:
        raise ValueError("Projector is not symmetric")
    if np.linalg.norm(P - voigt.dyad4_mm(P, P)) > eps:
        raise ValueError("Specified projector is not a projector (P:P != P)")

    C0 = 2.0 * mu_0 * voigt.id4(dim) + lambda_0 * voigt.ii4(dim)
    Q = voigt.id4(dim) - P
    QC0 = voigt.dyad4_mm(Q, C0)
    QC0Q = voigt.dyad4_mm(QC0, Q)
    A = voigt.expand_matrix_6_to_9(QC0Q) if dim == 6 else QC0Q

    # Moore-Penrose pseudo-inverse through the SVD, cut off at sqrt(eps)|s|
    U, s, Vt = np.linalg.svd(A)
    cutoff = eps * np.linalg.norm(s)
    sinv = np.where(np.abs(s) > cutoff, 1.0 / np.where(s == 0, 1.0, s), 0.0)
    M = (Vt.T * sinv) @ U.T
    if dim == 6:
        M = voigt.reduce_matrix_9_to_6(M)
    return BCProjector(P=P, Q=Q, QC0=QC0, M=M, MQ=voigt.dyad4_mm(M, Q),
                       bc_relax=bc_relax)


def calc_bc_mean(bc: BCProjector, E, S):
    """E + bc_relax M : (S - Q:C0 : E) (calcBCMean, fibergen.cpp:20242-20245),
    on host vectors."""
    return E + bc.bc_relax * voigt.dyad4_mv(bc.M, S - voigt.dyad4_mv(bc.QC0, E))


def bc_correction(bc: BCProjector, F0, F00=None):
    """The mean correction of one Gamma application (calcBCProjector,
    fibergen.cpp:20258-20261),

        R = bc_relax (M:Q) : F0 - (1 - bc_relax) M : (Q:C0 : F00),

    F0 the mean of the polarization field tau and F00 the mean strain of
    the field the operator is applied to, tensors on the solve's device (so
    is R).  The second term is :func:`relax_term`; without F00 it is left
    out, as the JAX package leaves it out (fibergen_tpu/solvers/bc.py:
    121-129; none of its callers passes F00)."""
    R = bc.bc_relax * (bc.on(F0.dtype, F0.device) @ F0)
    if F00 is not None:
        R = R + relax_term(bc, F00)
    return R


def relax_term(bc: BCProjector, F00):
    """-(1 - bc_relax) M : (Q:C0 : F00), the term of R in the mean strain
    F00 (zero for bc_relax == 1).  With it a relaxed solve keeps the fixed
    point of bc_relax == 1 as long as Q:C0:P == 0, which holds for the
    reference material lambda_0 == 0 (see :func:`check_relax`)."""
    key = ("relax", F00.dtype, F00.device)
    if key not in bc._tensors:
        MQC0 = voigt.dyad4_mm(bc.M, bc.QC0) * voigt.weights(bc.dim)[None, :]
        bc._tensors[key] = torch.as_tensor(
            -(1.0 - bc.bc_relax) * MQC0, dtype=F00.dtype, device=F00.device)
    return bc._tensors[key] @ F00


def check_relax(bc: BCProjector, mode: str):
    """Refuse bc_relax != 1 where the relaxed correction has another fixed
    point.  With Q:C0:P != 0 (a reference material with lambda_0 != 0) the
    mean strain it settles on misses the prescribed stress by a term in
    (1 - bc_relax) M:Q:C0:P:E.  In hyperelasticity the term in F00 (the
    mean deformation gradient, or its displacement part) leaves Newton's
    solution far off the prescribed stress."""
    if bc.bc_relax == 1.0 or bc.is_trivial:
        return
    if mode == "hyperelasticity":
        raise ValueError(
            f"bc_relax={bc.bc_relax:g} is refused in hyperelasticity: the "
            "relaxed mean correction does not reach the bc_relax=1 "
            "solution there; use bc_relax=1")
    QC0P = voigt.dyad4_mm(bc.QC0, bc.P)
    if np.abs(QC0P).max() > np.sqrt(np.finfo(np.float64).eps) * max(
            np.abs(bc.QC0).max(), 1.0):
        raise ValueError(
            f"bc_relax={bc.bc_relax:g} needs Q:C0:P == 0 (a reference "
            "material with lambda_0 == 0): otherwise the relaxed mean "
            "correction converges to a mean strain that misses the "
            "prescribed stress; use bc_relax=1 or drop ref_lambda")
