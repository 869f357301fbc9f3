"""The unit load cases: each Voigt strain or gradient component alone."""
from __future__ import annotations

import numpy as np


def cases(config: dict, dim: int) -> np.ndarray:
    return np.eye(dim)
