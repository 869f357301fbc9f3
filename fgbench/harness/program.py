"""The system under test, ``fibergen_tpu_torch``, as the cells drive it:
the solver built from a configuration, and its two entries."""
from __future__ import annotations

import numpy as np
import torch

from fgbench.harness import problem


def build(ft, config: dict, phi: torch.Tensor, device):
    """``LSSolver`` over the configuration's phases mixed by the Voigt rule
    on ``phi``, as ``bench.py`` builds its RVE."""
    laws = {"isotropic": lambda p: ft.LinearIsotropic(mu=p["mu"],
                                                      lam=p["lam"]),
            "scalar": lambda p: ft.ScalarLinearIsotropic(
                mu=p["mu"], dim=problem.DIM[config["mode"]])}
    if config.get("mixing", "voigt") != "voigt":
        raise ValueError("only the Voigt rule is driven")
    phases = [ft.Phase(p["name"], laws[p["law"]](p),
                       problem.region(phi, p["region"]))
              for p in config["phases"]]
    mat = ft.VoigtMixed(phases, dim=problem.DIM[config["mode"]])
    return ft.LSSolver(ft.Grid(*phi.shape), mat,
                       ft.SolverOptions(**config["solver"]), device=device)


def call(solver, entry: str, loads: np.ndarray):
    """One request: the load cases ``loads`` (k, dim) through ``entry``.
    Returns (mean stresses (k, dim), failed (k bools), CG iterations).  A
    case failed where the entry reports failure or its last residual is
    above tol (a solve stopped at its stagnation guard or maxiter)."""
    if entry == "run":
        solver.set_strain(loads[0])
        bad = solver.run()
        means = solver.calc_mean_stress()[None]
    else:
        bad = solver.run_batched(loads)
        means = solver.calc_mean_stress_batched()
    res = solver.residuals
    bad = bool(bad) or not res or not res[-1] <= solver.opt.tol
    return np.asarray(means, dtype=np.float64), [bad] * len(loads), len(res)


def fields(solver, entry: str) -> torch.Tensor:
    """The last request's solved fields, (k, dim, nx, ny, nz)."""
    return solver.eps[None] if entry == "run" else solver.eps_batch
