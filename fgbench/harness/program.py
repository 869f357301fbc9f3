"""The system under test, ``fibergen_tpu_torch``, as the cells drive it:
the solver built from a configuration, and its two entries."""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from fgbench.harness import manifest, problem


def build(ft, config: dict, geom, device, shape=None,
          root: Path = manifest.ROOT):
    """``LSSolver`` on the grid ``shape`` (by default ``geom``'s own) over
    the material that the configuration's mixing rule
    (``fgbench/mixing/<mixing>.py``) builds on the geometry's fields
    ``geom``."""
    mat = problem.plugin("mixing", config["mixing"], root).build(
        ft, config, geom, problem.dim(config, root))
    return ft.LSSolver(ft.Grid(*(shape or geom.shape)), mat,
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
