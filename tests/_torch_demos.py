"""The demo projects at the sizes of tests/test_demos.py, run through the
JAX package's FG and the port's FG(device="cpu") in float64, for
tests/test_torch_frontend*.py.

Both run the load cases of calc_effective_properties one after the other
(``batch_load_cases="off"``): the JAX package's batched CG runs one chunk
past the chunk in which it converges, the port's stops there (ROADMAP.md,
Queue 3), so only the sequential solves take the same steps.  Each pair
runs once per process.
"""
import os

import jax.numpy as jnp
import numpy as np

import fibergen_tpu as fg
import fibergen_tpu_torch as ft

DEMO_DIR = os.path.join(os.path.dirname(__file__), "..", "demo")


def _set(**kv):
    def extra(f):
        for k, v in kv.items():
            f.set(k.replace("__", ".."), v)
    return extra


# name -> (project, res, extra settings): test_demos.py's reductions; the
# 2d demo's generator stops after 3000 trials (m) instead of 100000
CASES = {
    "hashin": ("elasticity/hashin", 16, None),
    "laminate": ("elasticity/laminate", None, None),
    "heat": ("heat/heat", 32, _set(n=10)),
    "porous": ("porous/porosity", 32,
               _set(**{"actions.generate_fibers[1]__n": 20})),
    "transverse_isotropy": ("elasticity/transverse_isotropy", 16, None),
    "viscosity_analytical": ("viscosity/viscosity_analytical", 16, None),
    "nunan_keller": ("viscosity/nunan_keller", None,
                     _set(**{"solver__n": 16, "solver.tol": 1e-4})),
    "mixed_bc": ("hyperelasticity/mixed_bc", 8,
                 _set(**{"solver__n": 8, "solver.tol": 1e-8})),
    "primitives": ("geometry/primitives", 16,
                   _set(**{"solver__n": 16, "actions.write_vtk__skip": 1})),
    "2d": ("elasticity/2d", 32, _set(**{"solver.tol": 1e-5, "m": 3000})),
    "sfrp_hexagonal": ("elasticity/sfrp_hexagonal", 16, None),
}
# the nz = 1 demos on which the JAX package runs its 2-D pipeline
DIM2 = ("heat", "porous", "2d")


def load(F, name, sequential=True, **kw):
    path, res, extra = CASES[name]
    f = F(os.path.join(DEMO_DIR, path, "project.xml"), **kw)
    if res is not None and f.project.has("variables.res"):
        f.set("variables.res..value", res)
    if extra:
        extra(f)
    if sequential:
        f.set("solver.batch_load_cases", "off")
    return f


_PAIRS = {}


def pair(name):
    """(JAX FG, port FG) after run(), each returned 0."""
    if name not in _PAIRS:
        a = load(fg.FG, name)
        b = load(ft.FG, name, device="cpu")
        assert a.run() == 0 and b.run() == 0, name
        _PAIRS[name] = (a, b)
    return _PAIRS[name]


def rel(x, y):
    x, y = np.asarray(x, dtype=np.float64), np.asarray(y, dtype=np.float64)
    return float(np.max(np.abs(x - y)) / np.max(np.abs(y)))


GEOMETRY = ("distance", "normals", "orientation", "fiber_id", "material_id",
            "fiber_translation")


def check_geometry(a, b, field_tol=1e-12):
    """The port's get_field of each geometry field against the JAX
    package's fields in float64 (its get_field takes them in float32)."""
    want = a._geometry_fields(a.solver.grid, dtype=jnp.float64)
    for k in GEOMETRY:
        w = np.asarray(want[k])
        np.testing.assert_allclose(b.get_field(k), w if w.ndim == 4 else
                                   w[None], rtol=0, atol=field_tol,
                                   err_msg=k)


def check_pair(name, hist_tol=1e-8, mean_tol=1e-10, field_tol=1e-12):
    """The port's run of demo ``name`` against the JAX package's: the same
    iterations, the residual history within ``hist_tol`` relative or 1e-14
    absolute (an epsilon-estimator entry is a difference of two norms), the
    phase fields (and the geometry fields of the demos that take them)
    within ``field_tol``, the mean stress, the effective property and the
    Nunan-Keller coefficients within ``mean_tol`` relative to their
    largest entry, the same distance evaluations."""
    a, b = pair(name)
    ra, rb = a.get_residuals(), b.get_residuals()
    assert len(ra) == len(rb), (name, len(ra), len(rb))
    if ra:
        np.testing.assert_allclose(rb, ra, rtol=hist_tol, atol=1e-14)
    np.testing.assert_allclose(b.get_field("phi"), np.asarray(a.get_field(
        "phi")), rtol=0, atol=field_tol)
    if b._gfields_cache is not None:
        check_geometry(a, b, field_tol)
    if a.solver.eps is not None:
        assert rel(b.get_mean_stress(), a.get_mean_stress()) <= mean_tol
        assert rel(b.get_mean_strain(), a.get_mean_strain()) <= mean_tol
    if a.get_effective_property() is not None:
        assert rel(b.get_effective_property(),
                   a.get_effective_property()) <= mean_tol
    if hasattr(a, "_nunan_keller"):
        assert rel(b._nunan_keller, a._nunan_keller) <= mean_tol
    assert b.get_distance_evals() == a.get_distance_evals() > 0
    np.testing.assert_array_equal(b.get_A2(), a.get_A2())
    return a, b
