"""The rank-1 laminate rule of fibergen's heat demo (``mixing_rule``
laminate): the port's ``LaminateMixed`` over scalar conductivities, the
phases in the configuration's order (the matrix first, as fibergen's
front end builds them from the demo's ``materials``), each on the
geometry's fibre fraction (``inside``) or its complement (``outside``),
with the geometry's interface normals."""
from __future__ import annotations


def build(ft, config: dict, geom, dim: int):
    """``LaminateMixed`` over ``scalar`` (``mu``) phases on ``geom``'s
    ``phi`` and ``normals``."""
    phases = [ft.Phase(p["name"], ft.ScalarLinearIsotropic(mu=p["mu"],
                                                           dim=dim),
                       geom.phi if p["region"] == "inside"
                       else 1.0 - geom.phi)
              for p in config["phases"]]
    return ft.LaminateMixed(phases, dim=dim, normals=geom.normals)
