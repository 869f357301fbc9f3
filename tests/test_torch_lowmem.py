"""The port's low-memory CG (solvers/lowmem.py) against its plain CG and the
JAX package's low_mem CG, in float64 on the CPU: the cases of
tests/test_batched.py:137-260.

``low_mem="on"`` with ``check_every`` > 1 takes the lm6 tuple state (six
separate component tensors for eps, r and p) in elasticity and in the
viscosity Delta scheme, with trivial and mixed BCs, under every
estimator; with ``check_every`` 1, or a material off the isotropic route,
the stacked low-memory step.  Each walks the plain CG's trajectory: the
same iterations, residual histories within 1e-12 relative (or an
absolute floor of float64 rounding, :func:`_histories`), the same means
within 1e-12 of their size; and the JAX
package's low_mem solve's, its lm6 state taken after the port's number of
steps (its chunked driver runs one chunk past convergence).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fibergen_tpu as fg
import fibergen_tpu_torch as ft
from fibergen_tpu.utils.logging import LOG as JLOG
from fibergen_tpu_torch.solvers import lowmem
from fibergen_tpu_torch.utils.logging import LOG

torch.set_num_threads(2)

SHAPE = (11, 7, 5)
M1 = (1.0, 2.0)          # mu, lambda
M2 = (10.0, 5.0)


@pytest.fixture(autouse=True)
def _quiet():
    old = (JLOG.enabled, LOG.enabled)
    JLOG.enabled = LOG.enabled = False
    yield
    JLOG.enabled, LOG.enabled = old


def _sphere(shape):
    ax = [(np.arange(s) + 0.5) / s - 0.5 for s in shape]
    X, Y, Z = np.meshgrid(*ax, indexing="ij")
    return ((X * X + Y * Y + Z * Z) < 0.09).astype(np.float64)


def _smooth(shape):
    """A smooth fluidity weight that varies along every axis (one that
    varies along x alone is solved exactly in a few steps, and the last
    residuals are then rounding)."""
    x, y, z = ((np.arange(n) + 0.5) / n for n in shape)
    return (0.5 + 0.25 * np.sin(2 * np.pi * x)[:, None, None]
            * np.cos(2 * np.pi * y)[None, :, None]
            + 0.1 * np.sin(2 * np.pi * z)[None, None, :])


def _iso_C(mu, lam):
    """The 6x6 matrix of LinearIsotropic under LinearGeneral's weighted
    contraction (the JAX test's iso_C)."""
    C = np.zeros((6, 6))
    C[:3, :3] = lam
    C[np.arange(3), np.arange(3)] += 2.0 * mu
    C[np.arange(3, 6), np.arange(3, 6)] = mu
    return C


def _phases(kind, shape):
    """(name, law kind, moduli, phi) of the problem ``kind``."""
    if kind == "elasticity":
        phi = _sphere(shape)
        return [("incl", "isotropic", M2, phi),
                ("matrix", "isotropic", M1, 1.0 - phi)]
    if kind == "viscosity":
        w = _smooth(shape)
        return [("m", "scalar", (0.5 * 1.0,), 1.0 - w),
                ("f", "scalar", (0.5 * 0.2,), w)]
    if kind == "viscosity-lambda":
        phi = _sphere(shape)
        return [("f", "isotropic", (0.05, 0.01), phi),
                ("m", "isotropic", (0.5, 0.05), 1.0 - phi)]
    phi = _sphere(shape)
    C2 = _iso_C(*M2)
    C2[0, 1] = C2[1, 0] = C2[0, 1] * 1.2       # off isotropy
    return [("a", "general", (_iso_C(*M1),), phi),
            ("b", "general", (C2,), 1.0 - phi)]


def _jax_law(law, moduli, dim):
    if law == "isotropic":
        return fg.LinearIsotropic(*moduli)
    if law == "scalar":
        return fg.ScalarLinearIsotropic(moduli[0], dim=dim)
    from fibergen_tpu.materials import laws
    return laws.LinearGeneral(C=moduli[0], dim=dim)


def _solvers(kind, low_mem, shape=SHAPE, load=None, P=None, S=None,
             drop_phi=False, **opt):
    """(JAX solver, port solver) of ``kind``'s problem, loaded."""
    mode = "viscosity" if kind.startswith("viscosity") else "elasticity"
    phases = _phases(kind, shape)
    jmat = fg.VoigtMixed([fg.Phase(n, _jax_law(law, m, 6), jnp.asarray(phi))
                          for n, law, m, phi in phases], dim=6)
    rows = [(n, (law, *m), phi) if law == "general" else (n, *m, phi)
            for n, law, m, phi in phases]
    pmat = ft.convert.material_from_numpy(
        rows, dim=6, device="cpu",
        law="scalar" if kind == "viscosity" else "isotropic")
    o = dict(dict(mode=mode, gamma_scheme="staggered", dtype="float64",
                  method="cg", tol=1e-9, maxiter=500, low_mem=low_mem), **opt)
    js = fg.LSSolver(fg.Grid(*shape), jmat, fg.SolverOptions(**o))
    ps = ft.LSSolver(ft.Grid(*shape), pmat, ft.SolverOptions(**o),
                     device="cpu")
    if drop_phi:
        jmat._all_iso()
        jmat.drop_phi()
        pmat.drop_phi()
    if load is None:
        load = [1.0, 0, 0, 0.3, 0, 0] if mode == "elasticity" \
            else [0, 0, 0, 0.2, 0, 0.01]
    for s in (js, ps):
        if P is not None:
            s.set_bc_projector(P)
        s.set_strain(load)
        if S is not None:
            s.set_stress(S)
    return js, ps


def _histories(a, b, atol=None):
    """The same iterations, the entries within 1e-12 relative; the
    residual estimator's within 1e-18 absolute too (the float64 rounding
    of the recursive CG residual, which the near-singular trace of the
    lambda viscosity phases amplifies to 1e-10 of the tail in the plain
    route against the JAX package's as well), the other estimators', which
    subtract norms or means of the iterates, within 1e-14 absolute."""
    ra, rb = np.asarray(a.residuals), np.asarray(b.residuals)
    assert len(ra) == len(rb) < a.opt.maxiter
    if atol is None:
        atol = 1e-18 if a.opt.error_estimator == "residual" else 1e-14
    np.testing.assert_allclose(ra, rb, rtol=1e-12, atol=atol)


def _means(a, b, rtol=1e-12):
    for f in ("calc_mean_stress", "calc_mean_strain"):
        x, y = getattr(a, f)(), np.asarray(getattr(b, f)())
        np.testing.assert_allclose(x, y, rtol=0,
                                   atol=rtol * np.max(np.abs(y)))


def _jax_lm6_eps(js, steps):
    """The JAX package's lm6 eps after exactly ``steps`` steps."""
    out = js._lm6_init_chunk_n(steps)(
        js.mat.fields(), jnp.asarray(js._bc_mean(js.E, js.S), js.dtype),
        bca=js._bca(), mu0=js.mu_0, lam0=js.lambda_0,
        visc=js.mode == "viscosity")
    return jnp.stack(out[0])


@pytest.mark.parametrize("estimator", ["residual", "epsilon", "sigma",
                                       "energy"])
def test_lm6_matches_plain_and_jax(estimator):
    """The lm6 tuple path in elasticity (check_every 4) against the port's
    plain CG and the JAX package's lm6 under every estimator."""
    _, plain = _solvers("elasticity", "off", error_estimator=estimator,
                        check_every=4)
    js, ps = _solvers("elasticity", "on", error_estimator=estimator,
                      check_every=4)
    assert js._lm6_capable
    assert not plain.run() and not ps.run() and not js.run()
    assert ps._route == "lm6" and plain._route is None
    assert ps.eps.shape == (6,) + SHAPE and ps._lm6_eps_t is None
    _histories(ps, plain)
    _means(ps, plain)
    assert ps.mu_0 == js.mu_0
    _histories(ps, js)
    steps = math.ceil(len(ps.residuals) / 4) * 4
    S_ref = np.asarray(js.mat.mean_pk1(_jax_lm6_eps(js, steps)))
    np.testing.assert_allclose(ps.calc_mean_stress(), S_ref, rtol=0,
                               atol=1e-10 * np.max(np.abs(S_ref)))


@pytest.mark.parametrize("check_every", [1, 4])
def test_stacked_low_mem_matches_plain_and_jax(check_every):
    """check_every 1 takes the stacked low-memory step (the JAX package's
    cg_step_lowmem); the solve runs with the phase fields dropped."""
    _, plain = _solvers("elasticity", "off", error_estimator="residual",
                        check_every=check_every)
    js, ps = _solvers("elasticity", "on", error_estimator="residual",
                      check_every=check_every, drop_phi=True)
    assert not plain.run() and not ps.run() and not js.run()
    assert ps._route == ("stacked" if check_every == 1 else "lm6")
    _histories(ps, plain)
    _means(ps, plain)
    _histories(ps, js)


def test_generic_material_fallback_matches_plain_and_jax():
    """A material off the isotropic route (general 6x6 phases) takes the
    stacked generic step even with check_every 4."""
    _, plain = _solvers("general", "off", error_estimator="residual",
                        check_every=4)
    js, ps = _solvers("general", "on", error_estimator="residual",
                      check_every=4)
    assert not plain.run() and not ps.run() and not js.run()
    assert ps._route == "stacked" and not ps.mat.iso_route()
    _histories(ps, plain)
    _means(ps, plain)
    _histories(ps, js)


@pytest.mark.parametrize("kind,estimator", [
    ("viscosity", "residual"), ("viscosity", "epsilon"),
    ("viscosity-lambda", "residual")])
def test_lm6_viscosity_matches_plain_and_jax(kind, estimator):
    """lm6 on the viscosity Delta scheme: the fluidity phases (the K1
    tau-sum route's) and phases with lambda (the generic Delta path's),
    a traceless shear loading."""
    _, plain = _solvers(kind, "off", error_estimator=estimator,
                        check_every=4)
    js, ps = _solvers(kind, "on", error_estimator=estimator, check_every=4)
    assert js._lm6_capable
    assert not plain.run() and not ps.run() and not js.run()
    assert ps._route == "lm6"
    _histories(ps, plain)
    _means(ps, plain)
    _histories(ps, js)


@pytest.mark.parametrize("mode", ["elasticity", "viscosity"])
def test_lm6_mixed_bc_matches_plain_and_jax(mode):
    """lm6 under a projector that is not the identity: the mean correction
    from the tau mean in each step, and bc_error from the tuple state's
    means while eps is not formed."""
    P = np.zeros((6, 6))
    if mode == "elasticity":
        P[0, 0] = P[1, 1] = P[2, 2] = 1.0
        E, S = [1.0, 0.5, 0.2, 0, 0, 0], [0, 0, 0, 0.3, 0, 0.1]
    else:
        P[3, 3] = P[5, 5] = 0.5
        P[0, 0] = P[1, 1] = P[2, 2] = 1.0
        E, S = [0, 0, 0, 0.2, 0, 0.05], [0, 0, 0, 0, 0.1, 0]
    kw = dict(P=P, S=S, load=E, error_estimator="residual", check_every=4)
    _, plain = _solvers(mode, "off", **kw)
    js, ps = _solvers(mode, "on", **kw)
    seen = []
    bc_error = type(ps).bc_error

    def spy(self):
        seen.append(self.eps is None and self._lm6_eps_t is not None)
        return bc_error(self)

    ps.bc_error = spy.__get__(ps)
    assert not plain.run() and not ps.run() and not js.run()
    assert ps._route == "lm6" and seen and all(seen)
    _histories(ps, plain)
    _means(ps, plain, rtol=1e-10)
    assert abs(ps.bc_error() - plain.bc_error()) <= 1e-10
    _histories(ps, js)


def test_lm6_cg_reinit_matches_plain():
    """cg_reinit on the lm6 route: the exact residual from the tuple state
    after every third step, as the plain route takes it.  The exact
    residual is formed afresh from eps, its rounding a fixed 1e-16 or so
    of the first residual (tests/test_torch_methods.py's cg_reinit
    tests): the histories agree within 1e-12 relative or 1e-15
    absolute."""
    _, plain = _solvers("elasticity", "off", error_estimator="residual",
                        check_every=4, cg_reinit=3)
    _, ps = _solvers("elasticity", "on", error_estimator="residual",
                     check_every=4, cg_reinit=3)
    assert not plain.run() and not ps.run()
    assert ps._route == "lm6"
    _histories(ps, plain, atol=1e-15)
    _means(ps, plain)


def test_routes():
    """"auto" engages only on a card short of memory; "on" takes no
    low-memory route on the collocated grid, with the multigrid G0 or in
    heat, where the plain step runs."""
    for kw, want in (({"low_mem": "auto"}, None),
                     ({"low_mem": "on"}, "lm6"),
                     ({"low_mem": "on", "gamma_scheme": "collocated"}, None),
                     ({"low_mem": "on", "g0_solver": "multigrid"}, None)):
        _, ps = _solvers("elasticity", error_estimator="residual",
                         check_every=4, **kw)
        assert not ps.run()
        assert ps._route == want, kw
    phi = _sphere(SHAPE)
    mat = ft.convert.material_from_numpy(
        [("a", 10.0, phi), ("b", 1.0, 1.0 - phi)], dim=3, law="scalar",
        device="cpu")
    s = ft.LSSolver(ft.Grid(*SHAPE), mat, ft.SolverOptions(
        mode="heat", low_mem="on", check_every=4), device="cpu")
    s.set_strain([1.0, 0, 0])
    assert not s.run() and s._route is None


def test_peak_reckoning():
    """The reckoned fields per voxel: the plain step 7 * dim beside the
    material, lm6 LM6_FIELDS with the half spectrum's nz // 2 + 1 planes;
    1024 x 1024 x 512 float32 needs more than the card's 80 GB plain and
    less under lm6."""
    g = ft.Grid(1024, 1024, 512)
    assert lowmem.plain_solve_bytes(g, 6, 4) == 42 * 4 * 2 ** 29
    lm6 = lowmem.lm6_solve_bytes(g, 4)
    assert 27 * 4 * 2 ** 29 < lm6 < 27.1 * 4 * 2 ** 29
    assert lowmem.plain_solve_bytes(g, 6, 4) > 80e9 > lm6


def test_drop_phi_frees_the_phase_fields():
    """drop_phi keeps the mixed moduli alone: no reference to the phase
    fields stays (the moduli cache's key held them), and the lm6 solve
    runs on the moduli."""
    import gc
    import weakref
    _, ps = _solvers("elasticity", "on", error_estimator="residual",
                     check_every=4)
    ref = _solvers("elasticity", "on", error_estimator="residual",
                   check_every=4)[1]
    held = [weakref.ref(p.phi) for p in ps.mat.phases]
    ps.mat.drop_phi()
    gc.collect()
    assert all(w() is None for w in held)
    assert not ps.run() and not ref.run()
    assert ps._route == "lm6"
    _histories(ps, ref)
