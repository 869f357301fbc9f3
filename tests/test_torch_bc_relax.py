"""The relaxed mixed-BC mean correction (``bc_relax`` != 1) of the port, on
its own, in float64 on the CPU:

* ``bc_correction`` with its term in the mean strain F00 against a numpy
  evaluation of R = bc_relax (M:Q):F0 - (1 - bc_relax) M:(Q:C0:F00);
* mixed-BC solves at bc_relax = 0.5 on every linear path (K1 route CG and
  basic, collocated, polarization, the lm6 low-memory CG, heat, viscosity),
  whole and on two x-slabs: each meets ``bc_tol`` and ends at the
  bc_relax = 1 solution within the solve's tolerance;
* the refusals (a reference material with lambda_0 != 0, hyperelasticity).

The JAX package leaves the F00 term out, so it takes no part here.
"""
import numpy as np
import pytest
import torch

import fibergen_tpu_torch as ft
from fibergen_tpu_torch import parallel
from fibergen_tpu_torch.core import voigt
from fibergen_tpu_torch.solvers import bc
from fibergen_tpu_torch.utils.logging import LOG

torch.set_num_threads(2)

SHAPE = (8, 6, 5)


@pytest.fixture(autouse=True)
def _quiet():
    old = LOG.enabled
    LOG.enabled = False
    yield
    LOG.enabled = old


def _projector(dim, rank, seed):
    rng = np.random.default_rng(seed)
    U, _ = np.linalg.qr(rng.standard_normal((dim, rank)))
    s = 1.0 / np.sqrt(voigt.weights(dim))
    return (s[:, None] * U) @ (U.T * s[None, :])


@pytest.mark.parametrize("dim", [3, 6, 9])
@pytest.mark.parametrize("lam0", [0.0, 0.4])
def test_bc_correction_matches_numpy(dim, lam0):
    """R with and without F00 against the formula, the shear components
    doubled in every contraction (dyad4)."""
    P = _projector(dim, 2, 11)
    proj = bc.make_bc_projector(P, 1.3, lam0, bc_relax=0.6)
    rng = np.random.default_rng(3)
    F0, F00 = rng.standard_normal(dim), rng.standard_normal(dim)
    w = voigt.weights(dim)
    C0 = 2.0 * 1.3 * voigt.id4(dim) + lam0 * voigt.ii4(dim)
    Q = voigt.id4(dim) - P
    QC0 = Q @ (C0 * w[:, None])
    ref = 0.6 * (proj.M @ ((Q @ (F0 * w)) * w)) \
        - 0.4 * (proj.M @ ((QC0 @ (F00 * w)) * w))
    t = lambda v: torch.as_tensor(v, dtype=torch.float64)
    np.testing.assert_allclose(bc.bc_correction(proj, t(F0), t(F00)).numpy(),
                               ref, rtol=0, atol=1e-13)
    np.testing.assert_allclose(bc.bc_correction(proj, t(F0)).numpy(),
                               0.6 * (proj.M @ ((Q @ (F0 * w)) * w)),
                               rtol=0, atol=1e-13)
    unrelaxed = bc.make_bc_projector(P, 1.3, lam0)
    assert not np.any(bc.relax_term(unrelaxed, t(F00)).numpy())


def _sphere(shape):
    ax = [(np.arange(s) + 0.5) / s - 0.5 for s in shape]
    X, Y, Z = np.meshgrid(*ax, indexing="ij")
    return ((X * X + Y * Y + Z * Z) < 0.09).astype(np.float64)


P6 = voigt.id4(6)
P6[4, 4] = 0.0
P1 = np.zeros((6, 6))
P1[0, 0] = 1.0
P3 = np.zeros((3, 3))
P3[0, 0] = 1.0
ELASTIC = ("isotropic", ((10.0, 5.0), (1.0, 1.0)))
UNIAXIAL = (P1, [0.01, 0, 0, 0, 0, 0], np.zeros(6))
SHEAR = (P6, [0.01, -0.002, 0, 0.003, 0, 0], [0, 0, 0, 0, 0.05, 0])
PATHS = {
    "k1-cg": (6, ELASTIC, UNIAXIAL, {}),
    "k1-basic": (6, ELASTIC, SHEAR, {"method": "basic"}),
    "collocated": (6, ELASTIC, UNIAXIAL, {"gamma_scheme": "collocated"}),
    "polarization": (6, ELASTIC, UNIAXIAL, {"method": "polarization",
                                            "error_estimator": "epsilon"}),
    "lm6": (6, ELASTIC, SHEAR, {"low_mem": "on", "check_every": 2}),
    "heat": (3, ("scalar", ((10.0,), (1.0,))), (P3, [1.0, 0, 0], [0, 0.5, 0]),
             {"mode": "heat"}),
    "viscosity": (6, ("scalar", ((0.1,), (1.0,))),
                  (P6, [0, 0, 0, 1.0, 0, 0], [0, 0, 0, 0, 0.4, 0]),
                  {"mode": "viscosity"}),
}


def _solve(path, relax, slabs=None, **extra):
    dim, (law, moduli), (P, E, S), opts = PATHS[path]
    phi = _sphere(SHAPE)
    mat = ft.convert.material_from_numpy(
        [("fibre", *moduli[0], phi), ("matrix", *moduli[1], 1.0 - phi)],
        dim=dim, law=law, device="cpu")
    o = dict(mode="elasticity", dtype="float64", maxiter=1000, tol=1e-12,
             bc_relax=relax)
    o.update(opts)
    o.update(extra)
    kw = {} if slabs is None else {"sharding": parallel.field_sharding(
        parallel.make_mesh(["cpu"] * slabs))}
    s = ft.LSSolver(ft.Grid(*SHAPE), mat, ft.SolverOptions(**o),
                    device="cpu", **kw)
    s.set_bc_projector(P)
    s.set_stress(S)
    s.set_strain(E)
    return s


@pytest.mark.parametrize("slabs", [None, 2])
@pytest.mark.parametrize("path", list(PATHS))
def test_relaxed_solve_reaches_the_unrelaxed_solution(path, slabs):
    """bc_relax = 0.5 converges, meets ``bc_tol`` and ends at the
    bc_relax = 1 mean strain and stress within 1e-7 of their largest
    entries.  Both solves stop at tol 1e-12 of the first residual; the
    bc_relax = 1 CG's uniaxial stress keeps 1.4e-8 of the largest entry
    where the prescribed value is 0."""
    ref = _solve(path, 1.0, slabs)
    assert not ref.run()
    s = _solve(path, 0.5, slabs)
    assert not s.run()
    assert len(s.residuals) < s.opt.maxiter
    assert s.bc_error() < s.opt.bc_tol
    for got, want in ((s.calc_mean_strain(), ref.calc_mean_strain()),
                      (s.calc_mean_stress(), ref.calc_mean_stress())):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-7 * np.abs(want).max())


def test_relaxed_solve_refusals():
    """bc_relax != 1 raises where its fixed point is not the solution: a
    reference material with lambda_0 != 0 (Q:C0:P != 0) and
    hyperelasticity; bc_relax = 1 solves both."""
    s = _solve("k1-cg", 0.5, ref_mu=3.0, ref_lambda=1.0, update_ref="never")
    with pytest.raises(ValueError, match="lambda_0 == 0"):
        s.run()
    assert not _solve("k1-cg", 1.0, ref_mu=3.0, ref_lambda=1.0,
                      update_ref="never").run()
    phi = _sphere((7, 5, 5))
    mat = ft.convert.material_from_numpy(
        [("pore", 10.0, 100.0, phi), ("matrix", 10.0, 10.0, 1.0 - phi)],
        dim=9, law="svk", device="cpu")
    P = voigt.id4(9)
    P[0, 0] = 0.0
    S = np.zeros(9)
    S[0] = 1.0
    h = ft.LSSolver(ft.Grid(7, 5, 5), mat, ft.SolverOptions(
        mode="hyperelasticity", dtype="float64", bc_relax=0.5,
        error_estimator="residual", outer_error_estimator="epsilon"),
        device="cpu")
    h.set_bc_projector(P)
    h.set_strain(voigt.dyad4_mv(P, voigt.identity_vec(9)))
    h.set_stress(S)
    with pytest.raises(ValueError, match="hyperelasticity"):
        h.run()
