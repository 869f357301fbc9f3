"""Convergence error estimators.

Host-side state machines fed by device metrics computed by the solver
step (fibergen.cpp:14344-14642).  `metric_kind` tells the step which
reduction to compute:

    epsilon  -> per-component RMS norms of the strain field
    residual -> CG gamma (residual norm^2), updated via update_cg
    none     -> nothing
"""
from __future__ import annotations

import numpy as np


def _norm9(v):
    """2-norm with dim-6 vectors expanded to 9 entries (fix_dim semantics,
    fibergen.cpp:14602-14608)."""
    v = np.asarray(v, dtype=np.float64)
    if v.size == 6:
        v = np.concatenate([v, v[3:6]])
    return float(np.sqrt((v * v).sum()))


class ErrorEstimator:
    metric_kind = "none"

    def start(self, metric):
        """Initialize from the metric of the initial field."""

    def update(self, metric):
        raise NotImplementedError

    def update_cg(self, gamma, gamma0):
        self.update(None)

    def abs_error(self):
        return self._abs

    def rel_error(self):
        return self._rel


class NoneEstimator(ErrorEstimator):
    metric_kind = "none"
    _abs = 1.0
    _rel = 1.0

    def update(self, metric):
        pass


class EpsilonEstimator(ErrorEstimator):
    """|‖cn_prev‖ - ‖cn‖| on component RMS norms (fibergen.cpp:14592-14637)."""

    metric_kind = "epsilon"

    def __init__(self):
        self._prev = None
        self._abs = np.inf
        self._rel = 1.0

    def start(self, metric):
        self._prev = _norm9(metric)

    def update(self, metric):
        n = _norm9(metric)
        self._abs = abs((self._prev if self._prev is not None else np.inf) - n)
        self._rel = self._abs / (np.finfo(np.float64).tiny + n)
        self._prev = n


class ResidualEstimator(ErrorEstimator):
    """CG residual sqrt(gamma/gamma0) (fibergen.cpp:14385-14405)."""

    metric_kind = "residual"

    def __init__(self):
        self._abs = np.inf
        self._rel = 1.0

    def update(self, metric):
        pass

    def update_cg(self, gamma, gamma0):
        self._abs = float(np.sqrt(gamma))
        self._rel = float(np.sqrt(gamma / gamma0))


def make_estimator(name: str) -> ErrorEstimator:
    """Factory (create_error_estimator, fibergen.cpp:14940-14972)."""
    table = {
        "none": NoneEstimator,
        # the reference's div_sigma estimator is a stub returning 0
        # (fibergen.cpp:14470-14509); mirrored here
        "div_sigma": NoneEstimator,
        "epsilon": EpsilonEstimator,
        "residual": ResidualEstimator,
    }
    if name in ("sigma", "energy"):
        raise NotImplementedError(
            f"error estimator '{name}' is not ported yet")
    try:
        return table[name]()
    except KeyError:
        raise ValueError(f"Unknown error estimator '{name}'") from None
