"""Convergence error estimators.

Host-side state machines fed by device metrics computed by the solver
step (fibergen.cpp:14344-14642).  `metric_kind` tells the step which
reduction to compute:

    epsilon  -> per-component RMS norms of the strain field
    sigma    -> phase-weighted mean stress vector
    energy   -> mean energy scalar
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


class SigmaEstimator(ErrorEstimator):
    """Change in mean stress, two-step averaged (fibergen.cpp:14514-14587)."""

    metric_kind = "sigma"

    def __init__(self):
        self._prev = None
        self._prev_prev = None
        self._iter = 0
        self._abs = np.inf
        self._rel = 1.0

    @staticmethod
    def _fix(v):
        v = np.asarray(v, dtype=np.float64)
        if v.size == 6:
            v = np.concatenate([v, v[3:6]])
        elif v.size == 3:
            v = np.concatenate([v, np.zeros(6)])
        return v

    def start(self, metric):
        m = self._fix(metric)
        self._prev = m.copy()
        self._prev_prev = m.copy()

    def update(self, metric):
        m = self._fix(metric)
        tiny = np.finfo(np.float64).tiny
        if self._iter > 1:
            self._abs = 0.5 * (
                float(np.linalg.norm(self._prev_prev - m))
                + float(np.linalg.norm(self._prev - m)))
        else:
            self._abs = float(np.linalg.norm(self._prev - m))
        self._rel = self._abs / (tiny + float(np.linalg.norm(m)))
        self._prev_prev = self._prev
        self._prev = m
        self._iter += 1


class EnergyEstimator(ErrorEstimator):
    """Change in mean energy (fibergen.cpp:14410-14465)."""

    metric_kind = "energy"

    def __init__(self):
        self._prev = None
        self._abs = np.inf
        self._rel = 1.0

    def start(self, metric):
        self._prev = float(metric)

    def update(self, metric):
        m = float(metric)
        tiny = np.finfo(np.float64).tiny
        self._abs = abs((self._prev if self._prev is not None else np.inf)
                        - m)
        self._rel = self._abs / (tiny + abs(m))
        self._prev = m


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
        "sigma": SigmaEstimator,
        "energy": EnergyEstimator,
        "residual": ResidualEstimator,
    }
    try:
        return table[name]()
    except KeyError:
        raise ValueError(f"Unknown error estimator '{name}'") from None
