"""The Voigt rule, as ``bench.py`` builds its RVE: each phase's law
weighted by its fraction of the indicator ``geom`` (``inside``) or of its
complement (``outside``)."""
from __future__ import annotations


def region(phi, where):
    return phi if where == "inside" else 1.0 - phi


def build(ft, config: dict, geom, dim: int):
    """``VoigtMixed`` over the configuration's phases, each ``isotropic``
    (``mu``, ``lam``) or ``scalar`` (``mu``)."""
    laws = {"isotropic": lambda p: ft.LinearIsotropic(mu=p["mu"],
                                                      lam=p["lam"]),
            "scalar": lambda p: ft.ScalarLinearIsotropic(mu=p["mu"],
                                                         dim=dim)}
    phases = [ft.Phase(p["name"], laws[p["law"]](p),
                       region(geom, p["region"]))
              for p in config["phases"]]
    return ft.VoigtMixed(phases, dim=dim)
