"""Isotropic material constant conversion.

Any two of (K, E, lambda, mu, nu, M) determine the rest; ambiguous or
incomplete definitions raise (Material::readSettings, fibergen.cpp:7292-7455).
Plain Python: the results are host numbers.
"""
from __future__ import annotations


_NAMES = ("K", "E", "lam", "mu", "nu", "M")

# supported input pairs, matching the reference's table (fibergen.cpp:7339-7348)
_PAIRS = [
    ("K", "E"), ("K", "lam"), ("K", "mu"), ("K", "nu"),
    ("E", "mu"), ("E", "nu"),
    ("lam", "mu"), ("lam", "nu"),
    ("mu", "nu"), ("mu", "M"),
]


def elastic_constants(**kwargs) -> dict:
    """All of K, E, lam, mu, nu, M from exactly two of them ('lambda' is an
    alias for 'lam')."""
    vals = {}
    for k, v in kwargs.items():
        name = "lam" if k == "lambda" else k
        if name not in _NAMES:
            raise ValueError(f"Unknown material constant '{k}'")
        if v is not None:
            vals[name] = float(v)

    given = set(vals)
    pair = next((p for p in _PAIRS if set(p) == given), None)
    if pair is None:
        if len(given) != 2:
            raise ValueError(f"Material definition must give exactly 2 "
                             f"constants, got {sorted(given)}")
        raise ValueError(f"Unsupported material constant pair {sorted(given)}")

    K, E, lam = vals.get("K"), vals.get("E"), vals.get("lam")
    mu, nu, M = vals.get("mu"), vals.get("nu"), vals.get("M")

    if pair == ("K", "E"):
        lam = 3 * K * (3 * K - E) / (9 * K - E)
        mu = 3 * K * E / (9 * K - E)
    elif pair == ("K", "lam"):
        mu = 1.5 * (K - lam)
    elif pair == ("K", "mu"):
        lam = K - 2 * mu / 3
    elif pair == ("K", "nu"):
        lam = 3 * K * nu / (1 + nu)
        mu = 3 * K * (1 - 2 * nu) / (2 * (1 + nu))
    elif pair == ("E", "mu"):
        lam = mu * (E - 2 * mu) / (3 * mu - E)
    elif pair == ("E", "nu"):
        lam = E * nu / ((1 + nu) * (1 - 2 * nu))
        mu = E / (2 * (1 + nu))
    elif pair == ("lam", "nu"):
        mu = lam * (1 - 2 * nu) / (2 * nu)
    elif pair == ("mu", "nu"):
        lam = 2 * mu * nu / (1 - 2 * nu)
    elif pair == ("mu", "M"):
        lam = M - 2 * mu

    K = lam + 2 * mu / 3
    E = mu * (3 * lam + 2 * mu) / (lam + mu)
    nu = lam / (2 * (lam + mu))
    M = lam + 2 * mu
    return {"K": K, "E": E, "lam": lam, "mu": mu, "nu": nu, "M": M}


def hashin_shtrikman_bounds(mu1, lam1, phi1, mu2, lam2, phi2):
    """Two-phase Hashin-Shtrikman bounds on (K, mu) (HashinBounds::get,
    fibergen.cpp:7458-7485): (K_lower, mu_lower, K_upper, mu_upper)."""
    k1 = lam1 + 2.0 / 3.0 * mu1
    k2 = lam2 + 2.0 / 3.0 * mu2

    kl = k2 + phi1 * (k1 - k2) * (k2 + 4.0 / 3.0 * mu2) / (
        k2 + 4.0 / 3.0 * mu2 + phi2 * (k1 - k2))
    ku = k1 + phi2 * (k2 - k1) * (k1 + 4.0 / 3.0 * mu1) / (
        k1 + 4.0 / 3.0 * mu1 + phi1 * (k2 - k1))
    if ku < kl:
        kl, ku = ku, kl

    mul = mu2 + phi1 * (mu1 - mu2) / (
        1 + 2 * phi2 * (mu1 - mu2) / (5 * mu2)
        + 4 * phi2 * (mu1 - mu2) / (15 * k2 + 20 * mu2))
    muu = mu1 + phi2 * (mu2 - mu1) / (
        1 + 2 * phi1 * (mu2 - mu1) / (5 * mu1)
        + 4 * phi1 * (mu2 - mu1) / (15 * k1 + 20 * mu1))
    if muu < mul:
        mul, muu = muu, mul
    return kl, mul, ku, muu
