"""Sampling distributions for fibre orientation, length and radius (a copy
of fibergen_tpu/geometry/distributions.py; host numpy).

Equivalents of the reference's DiscreteDistribution hierarchy
(fibergen.cpp:2496-3010): dirac, normal (sphere / interval), uniform
(sphere / interval), angular central Gaussian (with the second-order moment
inversion through Carlson's R_D), list, and weighted composite.  Sampling
draws from an explicit numpy Generator: the generator (geometry/generator.py)
makes the same draws in the same order as the JAX package's, so one seed
gives one fibre list.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
from scipy.special import elliprd


class Distribution:
    weight: float = 1.0

    def draw(self, rng: np.random.Generator, index: int = 0) -> np.ndarray:
        raise NotImplementedError


@dataclasses.dataclass
class Dirac(Distribution):
    """Constant value (DiracDistribution, fibergen.cpp:2529)."""

    value: np.ndarray
    weight: float = 1.0

    def draw(self, rng, index=0):
        return np.atleast_1d(np.asarray(self.value, dtype=np.float64))


@dataclasses.dataclass
class UniformSphere(Distribution):
    """Uniform direction on S^2 (fibergen.cpp:2684)."""

    weight: float = 1.0

    def draw(self, rng, index=0):
        while True:
            v = rng.standard_normal(3)
            n = np.linalg.norm(v)
            if n > 0:
                return v / n


@dataclasses.dataclass
class UniformInterval(Distribution):
    """Uniform scalar on [a, b] (fibergen.cpp:2712-2743)."""

    a: float
    b: float
    weight: float = 1.0

    def draw(self, rng, index=0):
        return np.array([self.a + (self.b - self.a) * rng.uniform()])


@dataclasses.dataclass
class NormalScalar(Distribution):
    """Normal scalar N(mu, sigma) (fibergen.cpp:2649-2672)."""

    mu: float
    sigma: float
    weight: float = 1.0

    def draw(self, rng, index=0):
        return np.array([self.mu + self.sigma * rng.standard_normal()])


@dataclasses.dataclass
class NormalSphere(Distribution):
    """Direction scattered around a mean direction x with stddev sigma in the
    tangent plane (fibergen.cpp:2565-2610)."""

    x: np.ndarray
    sigma: float = 1.0
    weight: float = 1.0

    def __post_init__(self):
        x = np.asarray(self.x, dtype=np.float64)
        self.x = x / np.linalg.norm(x)
        # orthonormal tangent frame (fibergen.cpp:2600-2610)
        u = np.array([-x[0] * x[1], x[0] + x[2], -x[2] * x[1]])
        u = u / np.linalg.norm(u)
        w = np.cross(self.x, u)
        self._u, self._w = u, w / np.linalg.norm(w)

    def draw(self, rng, index=0):
        v = (self.x + self.sigma * rng.standard_normal() * self._u
             + self.sigma * rng.standard_normal() * self._w)
        return v / np.linalg.norm(v)


@dataclasses.dataclass
class ListDistribution(Distribution):
    """Cycle through an explicit list of values (fibergen.cpp:2885)."""

    values: Sequence
    weight: float = 1.0

    def draw(self, rng, index=0):
        return np.atleast_1d(np.asarray(
            self.values[index % len(self.values)], dtype=np.float64))


@dataclasses.dataclass
class Composite(Distribution):
    """Weighted mixture of distributions (fibergen.cpp:2933)."""

    parts: List[Distribution]
    weight: float = 1.0

    def draw(self, rng, index=0):
        w = np.array([p.weight for p in self.parts], dtype=np.float64)
        w = w / w.sum()
        i = rng.choice(len(self.parts), p=w)
        return self.parts[i].draw(rng, index)


# ---------------------------------------------------------------------------
# Angular central Gaussian
# ---------------------------------------------------------------------------

def acg_moments_from_b(b: np.ndarray) -> np.ndarray:
    """Second-order moments a_i of the ACG with (det-1-normalized) parameter
    eigenvalues b: a_i = R_D(b_j, b_k, b_i)/3 (A_from_B, fibergen.cpp:2195)."""
    b = np.asarray(b, dtype=np.float64)
    a0 = float(elliprd(b[1], b[2], b[0])) / 3.0
    a1 = float(elliprd(b[0], b[2], b[1])) / 3.0
    a2 = float(elliprd(b[0], b[1], b[2])) / 3.0
    s = a0 + a1 + a2
    with np.errstate(invalid="ignore"):  # extreme b: moments saturate to 0/1
        return np.array([a0, a1, a2]) / s


def acg_b_from_moments(a: np.ndarray, tol: float = 1e-12,
                       max_iter: int = 200) -> np.ndarray:
    """Invert the ACG moment map a(b) for the parameter eigenvalues b with
    det(B) = 1 (compute_B_from_A, fibergen.cpp:2203-2492).

    Uses a damped log-space Newton iteration with numerical Jacobian — more
    robust than the reference's exponent-tracking fixed point and accurate to
    ~1e-12."""
    a = np.asarray(a, dtype=np.float64)
    a = a / a.sum()
    # degenerate (planar/axial) moments: clamp slightly inside the simplex;
    # b-eigenvalues grow like a^-1.65 so 1e-5 keeps exp() in range while the
    # sampled distribution is indistinguishable from the degenerate limit
    a = np.maximum(a, 1e-5)
    a = a / a.sum()

    # parameterize b = exp(t) / geometric-mean(exp(t)) => det B = 1
    t = np.log(a ** 1.65)

    def residual(t):
        # clamp the centered exponent: Newton trial steps on near-degenerate
        # moments can overshoot; exp would overflow (harmlessly, but noisily)
        with np.errstate(over="ignore", invalid="ignore"):
            b = np.exp(np.clip(t - t.mean(), -250.0, 250.0))
            return acg_moments_from_b(b) - a

    r = residual(t)
    for it in range(max_iter):
        if np.abs(r).max() < tol:
            break
        # numerical Jacobian in t
        J = np.zeros((3, 3))
        h = 1e-6
        for j in range(3):
            tp = t.copy(); tp[j] += h
            J[:, j] = (residual(tp) - r) / h
        # remove the null direction (uniform shift of t)
        J += np.ones((3, 3)) / 3.0 * 1e-3
        try:
            dt = np.linalg.lstsq(J, -r, rcond=None)[0]
        except np.linalg.LinAlgError:
            break
        step = 1.0
        for _ in range(30):
            t_new = t + step * dt
            r_new = residual(t_new)
            if np.abs(r_new).max() < np.abs(r).max():
                t, r = t_new, r_new
                break
            step *= 0.5
        else:
            break
    # det-normalize in log space (exp of a centered exponent cannot overflow
    # into inf -> nan the way exp-then-divide-by-cbrt(prod) does for
    # near-degenerate moments)
    lb = np.clip(t - t.mean(), -250.0, 250.0)
    lb = lb - lb.mean()
    return np.exp(lb)


@dataclasses.dataclass
class ACG(Distribution):
    """Angular central Gaussian on S^2 parameterized by its second-order
    moment matrix A (fibergen.cpp:2762-2882).  Samples x = normalize(U b^{-1/2} z),
    z ~ N(0, I)."""

    A: np.ndarray
    weight: float = 1.0

    def __post_init__(self):
        A = np.asarray(self.A, dtype=np.float64)
        A = A / np.trace(A)
        evals, evecs = np.linalg.eigh(A)
        # descending like the reference's SVD ordering
        order = np.argsort(evals)[::-1]
        self._a = evals[order]
        self._U = evecs[:, order]
        b = acg_b_from_moments(self._a, tol=np.finfo(np.float64).eps ** (2 / 3))
        self._binv_sqrt = 1.0 / np.sqrt(b)

    def draw(self, rng, index=0):
        for _ in range(1000):
            z = self._binv_sqrt * rng.standard_normal(3)
            v = self._U @ z
            n = np.linalg.norm(v)
            if np.isfinite(n) and n > 0:
                return v / n
        raise RuntimeError(
            f"ACG sampling failed: degenerate parameters b^-1/2 = {self._binv_sqrt}")
