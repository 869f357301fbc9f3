"""The output check that decides ``correct``.

Once the window has closed and the program's state is freed, the plain
reference that the configuration names (``fgbench/reference/<reference>.py``,
by default ``<mode>.py``) solves each load case that the window served, in
float64 to a relative residual of 1e-10, on the same geometry, whose
fields it is given and from which it works out its moduli and
preconditioner itself.  Compared, each against the configuration's limit
(its ``check``):

* ``stress_gap``: over every request of the window and each of its cases,
  the largest |mean stress - reference| / |reference| (2-norms of the
  Voigt vectors): every answer served;
* ``field_gap``: over the cases of the window's last request, the largest
  |field - reference| / |reference| of the solved strain or gradient field
  (2-norms over all components and voxels);
* ``failed_cases``: cases whose solve reported failure or stopped above
  tol; its limit is 0.
"""
from __future__ import annotations

import numpy as np
import torch

REF_TOL = 1e-10
NAMES = ("stress_gap", "field_gap", "failed_cases")


def gaps(reference, config, geom, loads, requests, last_cases, last_fields):
    """The compared numbers of a run.  ``requests``: (cases, means) pairs;
    ``last_fields``: the last request's (k, dim, ...) fields, on any
    device, in the order of ``last_cases``."""
    cases = sorted({c for cs, _ in requests for c in cs} | set(last_cases))
    stress, field = 0.0, 0.0
    for c in cases:
        sol = reference.solve(config, geom, loads[c], tol=REF_TOL)
        ref = sol.mean.cpu().numpy()
        norm = np.linalg.norm(ref)
        for cs, means in requests:
            for k, ck in enumerate(cs):
                if ck == c:     # a missing answer is a wrong one
                    g = float(np.linalg.norm(means[k] - ref) / norm) \
                        if k < len(means) else float("inf")
                    stress = max(stress, g) if g == g else float("nan")
        for k, ck in enumerate(last_cases):
            if ck == c and k >= len(last_fields):
                field = float("inf")
            elif ck == c:
                out = last_fields[k].to(sol.field.device, torch.float64)
                g = float(torch.linalg.vector_norm(out - sol.field)
                          / torch.linalg.vector_norm(sol.field))
                field = max(field, g) if g == g else float("nan")
                del out
        del sol
    return {"stress_gap": stress, "field_gap": field}


def verdict(numbers: dict, limits: dict) -> bool:
    """Every number at or under its limit (NaN fails)."""
    return all(numbers[k] <= limits[k] for k in NAMES)


def plain(x):
    """A compared number as the result line carries it: a non-finite one
    (a wrong or missing answer) as its name, so the line stays JSON."""
    return x if np.isfinite(x) else str(x)


def limits_of(config: dict) -> dict:
    out = {k: float(v) for k, v in config["check"].items()}
    out["failed_cases"] = 0
    return out
