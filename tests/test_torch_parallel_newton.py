"""Newton-Krylov on the x-slabs over the mixing rules and under mixed
boundary conditions, against the JAX package's sharded solver and against
the port's unsharded one, on the CPU.

SVK phases on the partial-volume sphere under the Maximum rule (the port's
slab views of the rule, materials/sharded.py), and on the sharp sphere
under the Voigt rule with F11's stress prescribed (0.1) and the other
components of F held (the mixed_bc demo's kind of load).  The port on four
CPU slabs against the JAX package's ``LSSolver`` on four forced host
devices (``use_pallas="off"``), float64: the same inner and outer
iterations, histories within 1e-9, F within 1e-9, the mean PK1 within
1e-10 of its max; then against the port's unsharded solve at D = 1, 2, 4.
A sharded Newton step on the CPU costs about four times the unsharded one
(the ``torch.func`` tangent per slab and phase), so the grid is (4, 4, 3).
The solves stop at 1e-5: below that the recursive CG residual's rounding
(any two summation orders of the same solve) parts the histories by more
than 1e-9 on the partial-volume sphere, and the next outer step carries
it on.
"""
import pytest

import _torch_slab_cases as cases
from fibergen_tpu.utils.logging import LOG as JLOG
from fibergen_tpu_torch.utils.logging import LOG

SHAPE = (4, 4, 3)
OPT = dict(error_estimator="residual", outer_error_estimator="epsilon",
           tol=1e-5)
# id -> (material, bc)
CASES = {"maximum": ("svk-maximum", None), "mixed-bc": ("svk", "F11")}


@pytest.fixture(autouse=True)
def _quiet():
    old = (JLOG.enabled, LOG.enabled)
    JLOG.enabled = LOG.enabled = False
    yield
    JLOG.enabled, LOG.enabled = old


@pytest.mark.parametrize("case", CASES)
def test_sharded_newton_matches_jax(case):
    name, bc = CASES[case]
    js = cases.jax_solver(name, SHAPE, "hyperelasticity", bc, **OPT)
    ps = cases.port_solver(name, SHAPE, "hyperelasticity", 4, bc, **OPT)
    assert not js.run() and not ps.run()
    cases.same_solve(js, ps)
    if bc is not None:
        assert ps.bc_error() <= ps.opt.bc_tol
        assert abs(ps.calc_mean_stress()[0] - cases.BCS[bc][1][0]) \
            <= ps.opt.bc_tol * cases.BCS[bc][1][0]


@pytest.mark.parametrize("d", [1, 2, 4])
@pytest.mark.parametrize("case", CASES)
def test_sharded_newton_matches_unsharded(case, d):
    """The unsharded solve's outer and inner iterations, histories within
    1e-9, F and the mean PK1 within 1e-12 of their max."""
    name, bc = CASES[case]
    s0 = cases.port_solver(name, SHAPE, "hyperelasticity", None, bc, **OPT)
    s1 = cases.port_solver(name, SHAPE, "hyperelasticity", d, bc, **OPT)
    assert not s0.run() and not s1.run()
    assert s1.newton_iterations == s0.newton_iterations
    cases.same_as_unsharded(s0, s1)
