"""The port's general linear materials against the JAX package's, in float64
on the CPU: the constant conversions (every pair of elastic_constants, its
refusals, the Hashin-Shtrikman bounds), each linear law's stress, energy,
tangent and constant bounds (the transversely isotropic law about a fixed
axis and about a per-voxel orientation field), make_law, and each mixing
rule's responses on smooth two- and three-phase fields with interface and
pure voxels, all within 1e-12; make_mixed's names and refusals.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

import fibergen_tpu as fg
import fibergen_tpu_torch as ft
from fibergen_tpu.materials import convert as jconvert
from fibergen_tpu.materials import laws as jl
from fibergen_tpu.materials import mixing as jmix
from fibergen_tpu_torch.materials import convert, laws, mixing

torch.set_num_threads(2)

SHAPE = (9, 7, 5)
# the tiso demo's fibre (demo/elasticity/transverse_isotropy)
TISO = dict(E=3860.0, nu=0.2, E_a=5390.0, G_a=390.0, nu_a=0.031)


def _close(out, ref, tol=1e-12):
    out = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=tol * max(np.max(np.abs(ref)), 1e-300))


# ------------------------------------------------------------ constants
BASE = convert.elastic_constants(mu=350.0, lam=525.0)


@pytest.mark.parametrize("pair", convert._PAIRS + [("lambda", "mu")])
def test_elastic_constants_match_jax(pair):
    kw = {k: BASE["lam" if k == "lambda" else k] for k in pair}
    out, ref = convert.elastic_constants(**kw), jconvert.elastic_constants(**kw)
    assert set(out) == set(ref) == {"K", "E", "lam", "mu", "nu", "M"}
    for k in ref:
        assert out[k] == pytest.approx(ref[k], rel=1e-12, abs=1e-12)
        assert out[k] == pytest.approx(BASE[k], rel=1e-12)


@pytest.mark.parametrize("kw,match", [
    (dict(E=1.0, mu=0.4, nu=0.3), "exactly 2"),
    (dict(E=1.0), "exactly 2"),
    (dict(E=1.0, lam=0.5), "Unsupported material constant pair"),
    (dict(nu=0.3, M=2.0), "Unsupported material constant pair"),
    (dict(G=1.0, E=2.0), "Unknown material constant")])
def test_elastic_constants_refusals(kw, match):
    for fn in (convert.elastic_constants, jconvert.elastic_constants):
        with pytest.raises(ValueError, match=match):
            fn(**kw)


@pytest.mark.parametrize("args", [(10.0, 5.0, 0.3, 1.0, 1.0, 0.7),
                                  (1.0, 1.0, 0.6, 10.0, 5.0, 0.4),
                                  (350.0, 525.0, 0.5, 1608.3, 1072.2, 0.5)])
def test_hashin_shtrikman_bounds_match_jax(args):
    out = convert.hashin_shtrikman_bounds(*args)
    ref = jconvert.hashin_shtrikman_bounds(*args)
    np.testing.assert_allclose(out, ref, rtol=1e-12)
    assert out[0] <= out[2] and out[1] <= out[3]


# ------------------------------------------------------------ laws
def _orientation(shape, seed=0):
    """Unit vectors normalised from a normal draw."""
    v = np.random.default_rng(seed).standard_normal((3,) + shape)
    return v / np.linalg.norm(v, axis=0, keepdims=True)


def _stiffness(seed=1):
    A = np.random.default_rng(seed).standard_normal((6, 6))
    return 10.0 * (A @ A.T + 6.0 * np.eye(6))


def _conductivity(seed=2):
    A = np.random.default_rng(seed).standard_normal((3, 3))
    return A @ A.T + 3.0 * np.eye(3) + 0.2 * (A - A.T)


def _laws(spec):
    """(JAX law, port law) of one spec (kind, parameters)."""
    kind, p = spec
    if kind == "iso":
        return jl.LinearIsotropic(**p), laws.LinearIsotropic(**p)
    if kind == "scalar":
        return jl.ScalarLinearIsotropic(**p), laws.ScalarLinearIsotropic(**p)
    if kind == "general":
        return jl.LinearGeneral(C=p), laws.LinearGeneral(C=p)
    if kind == "aniso":
        return jl.MatrixLinearAnisotropic(K=p), \
            laws.MatrixLinearAnisotropic(K=p)
    if kind == "tiso":
        return jl.LinearTransverselyIsotropic(a=np.array([1.0, 0.3, -0.2]),
                                              **p), \
            laws.LinearTransverselyIsotropic(a=np.array([1.0, 0.3, -0.2]),
                                             **p)
    o = _orientation(SHAPE)
    return jl.LinearTransverselyIsotropic(orientation=jnp.asarray(o), **p), \
        laws.LinearTransverselyIsotropic(orientation=torch.as_tensor(o), **p)


LAWS = {
    "iso": (("iso", dict(mu=350.0, lam=525.0)), 6),
    "scalar3": (("scalar", dict(mu=2.5, dim=3)), 3),
    "scalar6": (("scalar", dict(mu=0.1, dim=6)), 6),
    "general": (("general", _stiffness()), 6),
    "aniso": (("aniso", _conductivity()), 3),
    "tiso": (("tiso", TISO), 6),
    "tiso-field": (("tiso-field", TISO), 6),
}


@pytest.mark.parametrize("name", list(LAWS))
def test_law_matches_jax(name):
    spec, dim = LAWS[name]
    jlaw, plaw = _laws(spec)
    rng = np.random.default_rng(3)
    F, W = rng.standard_normal((2, dim) + SHAPE)
    Ft, Wt = torch.as_tensor(F), torch.as_tensor(W)
    _close(plaw.pk1(Ft), jlaw.pk1(jnp.asarray(F)))
    _close(plaw.w(Ft), jlaw.w(jnp.asarray(F)))
    _close(plaw.dpk1(Ft, Wt), jlaw.dpk1(jnp.asarray(F), jnp.asarray(W)))
    _close(plaw.cauchy(Ft), jlaw.cauchy(jnp.asarray(F)))
    np.testing.assert_allclose(plaw.eig_range_const(), jlaw.eig_range_const(),
                               rtol=1e-12)
    assert plaw.is_linear and plaw.dim == dim and str(plaw) == str(jlaw)


def test_tiso_takes_the_bounds_about_e_z_whatever_its_axis():
    """Both packages bound a tiso law as if its axis were e_z."""
    ref = laws.LinearTransverselyIsotropic(a=np.array([0.0, 0.0, 1.0]),
                                           **TISO).eig_range_const()
    for a in ([1.0, 0, 0], [0.3, -1.0, 0.2]):
        law = laws.LinearTransverselyIsotropic(a=np.array(a), **TISO)
        assert law.eig_range_const() == ref
    C = laws.LinearTransverselyIsotropic(a=np.array([0.0, 0.0, 1.0]),
                                         **TISO).matrix((0.0, 0.0, 1.0))
    e = np.linalg.eigvalsh(0.5 * (C + C.T))
    assert ref == (e.min(), e.max())


@pytest.mark.parametrize("axis", ["x", "field"])
def test_tiso_reduces_to_the_isotropic_law(axis):
    """E_a = E, G_a = E / (2 (1 + nu)), nu_a = nu: the isotropic law of
    (E, nu), voxel for voxel."""
    E, nu = 910.0, 0.3
    iso = dict(E=E, nu=nu, E_a=E, G_a=E / (2 * (1 + nu)), nu_a=nu)
    kw = dict(a=np.array([1.0, 0, 0])) if axis == "x" else \
        dict(orientation=torch.as_tensor(_orientation(SHAPE)))
    law = laws.LinearTransverselyIsotropic(**iso, **kw)
    c = convert.elastic_constants(E=E, nu=nu)
    ref = laws.LinearIsotropic(mu=c["mu"], lam=c["lam"])
    F = torch.as_tensor(np.random.default_rng(4).standard_normal((6,)
                                                                 + SHAPE))
    _close(law.pk1(F), ref.pk1(F))


def test_linear_laws_have_no_polarization_but_the_isotropic_ones():
    F = torch.ones((6,) + SHAPE, dtype=torch.float64)
    for spec, _ in (LAWS["general"], LAWS["tiso"]):
        jlaw, plaw = _laws(spec)
        name = type(plaw).__name__
        with pytest.raises(NotImplementedError,
                           match=f"{name} has no polarization"):
            plaw.polarization(1.0, F)
        with pytest.raises(NotImplementedError,
                           match=f"{name} has no polarization"):
            jlaw.polarization(1.0, jnp.asarray(F.numpy()))
    laws.LinearIsotropic(mu=1.0, lam=1.0).polarization(1.0, F)


@pytest.mark.parametrize("kind,params", [
    ("iso", dict(E=910.0, nu=0.3)), ("matrix", dict(mu=1.0, lam=2.0)),
    ("", dict(K=3.0, mu=1.0)), ("scalar", dict(mu=2.0)),
    ("general", dict(C=_stiffness())), ("svk", dict(mu=1.0, lam=2.0)),
    ("nh", dict(E=10.0, nu=0.3)), ("neo-hooke", dict(mu=1.0, lam=2.0)),
    ("nh2", dict(mu=1.0, K=5.0))])
def test_make_law_matches_jax(kind, params):
    out = laws.make_law(kind, dim_hint=3, **params)
    ref = jl.make_law(kind, dim_hint=3, **params)
    assert type(out).__name__ == type(ref).__name__
    for f in ("mu", "lam", "K", "dim"):
        if hasattr(ref, f):
            assert getattr(out, f) == pytest.approx(getattr(ref, f),
                                                    rel=1e-14)
    if kind == "general":
        np.testing.assert_array_equal(out.C, ref.C)


def test_make_law_refuses_an_unknown_law():
    for fn in (laws.make_law, jl.make_law):
        with pytest.raises(ValueError, match="Unknown material law"):
            fn("tiso_fancy", mu=1.0)


# ------------------------------------------------------------ mixing
def _phis(n):
    """Smooth phase fields on SHAPE with interface and pure voxels: a
    blurred sphere, and for three phases its complement split along x."""
    ax = [(np.arange(s) + 0.5) / s - 0.5 for s in SHAPE]
    X, Y, Z = np.meshgrid(*ax, indexing="ij")
    a = 1.0 / (1.0 + np.exp(-(0.09 - (X * X + Y * Y + Z * Z)) / 0.02))
    if n == 2:
        return [a, 1.0 - a]
    s = np.clip(0.5 + 4.0 * X, 0.0, 1.0)
    b = (1.0 - a) * s
    return [a, b, 1.0 - a - b]


PHASES = {
    "iso2": ([("iso", dict(mu=10.0, lam=5.0)), ("iso", dict(mu=1.0, lam=1.0))],
             6),
    "scalar2": ([("scalar", dict(mu=10.0, dim=3)),
                 ("scalar", dict(mu=1.0, dim=3))], 3),
    "tiso2": ([("tiso", TISO), ("iso", dict(mu=350.0, lam=525.0))], 6),
    "mixed3": ([("tiso-field", TISO), ("general", _stiffness()),
                ("iso", dict(mu=350.0, lam=525.0))], 6),
    "aniso3": ([("aniso", _conductivity()), ("scalar", dict(mu=1.0, dim=3)),
                ("scalar", dict(mu=4.0, dim=3))], 3),
}
RULE_CASES = [(r, "iso2") for r in ("voigt", "reuss", "maximum", "random",
                                   "fiftyfifty", "split", "iso")] \
    + [(r, "scalar2") for r in ("voigt", "reuss", "maximum")] \
    + [(r, "tiso2") for r in ("voigt", "maximum", "random", "fiftyfifty")] \
    + [(r, "mixed3") for r in ("voigt", "maximum", "random", "fiftyfifty")] \
    + [(r, "aniso3") for r in ("voigt", "maximum", "fiftyfifty")]


def _materials(rule, phases):
    specs, dim = PHASES[phases]
    phis = _phis(len(specs))
    pairs = [_laws(s) for s in specs]
    jmat = jmix.MIXING_RULES[rule]([
        fg.Phase(f"p{i}", j, jnp.asarray(phi))
        for i, ((j, _), phi) in enumerate(zip(pairs, phis))], dim=dim)
    pmat = mixing.make_mixed(rule, [
        mixing.Phase(f"p{i}", p, torch.as_tensor(phi))
        for i, ((_, p), phi) in enumerate(zip(pairs, phis))], dim=dim)
    return jmat, pmat, dim


@pytest.mark.parametrize("rule,phases", RULE_CASES)
def test_mixing_rule_matches_jax(rule, phases):
    jmat, pmat, dim = _materials(rule, phases)
    rng = np.random.default_rng(5)
    F, W = rng.standard_normal((2, dim) + SHAPE)
    Fj, Ft = jnp.asarray(F), torch.as_tensor(F)
    _close(pmat.pk1(Ft), jmat.pk1(Fj))
    _close(pmat.w(Ft), jmat.w(Fj))
    _close(pmat.dpk1(Ft, torch.as_tensor(W)), jmat.dpk1(Fj, jnp.asarray(W)))
    _close(pmat.mean_pk1(Ft), jmat.mean_pk1(Fj))
    for lam0 in (0.0, 0.7):
        _close(pmat.stress_diff(Ft, 2.5, lam0), jmat.stress_diff(Fj, 2.5,
                                                                  lam0))
    for zt in (False, True):
        out = pmat.eig_range(zero_trace=zt)
        ref = jmat.eig_range(Fj, zero_trace=zt)
        np.testing.assert_allclose([float(x) for x in out],
                                   [float(x) for x in ref], rtol=1e-12)
    assert pmat.rule == jmat.rule and str(pmat) == str(jmat)
    route = rule in ("voigt", "reuss") and phases in ("iso2", "scalar2")
    assert pmat.iso_route() == route


def test_random_rule_uses_the_reference_hash():
    """Interface voxels take phase ((i 1103515245 + 12345) >> 16 &
    0x7FFFFFFF) % nph of their flat C-order index i; pure voxels keep
    theirs."""
    _, pmat, _ = _materials("random", "mixed3")
    w = torch.stack(pmat._weights_like(torch.zeros((6,) + SHAPE,
                                                   dtype=torch.float64)))
    phis = np.stack(_phis(3))
    i = np.arange(np.prod(SHAPE)).reshape(SHAPE)
    sel = (((i * 1103515245 + 12345) >> 16) & 0x7FFFFFFF) % 3
    inter = ((phis > 1e-7) & (phis < 1 - 1e-7)).any(axis=0)
    assert inter.any() and not inter.all()
    for p in range(3):
        np.testing.assert_array_equal(
            w[p].numpy(), np.where(inter, (sel == p).astype(float), phis[p]))


def test_make_mixed_names_and_refusals():
    specs, _ = PHASES["tiso2"]
    phases = lambda: [mixing.Phase(f"p{i}", _laws(s)[1], torch.as_tensor(phi))
                      for i, (s, phi) in enumerate(zip(specs, _phis(2)))]
    for name, cls in mixing.MIXING_RULES.items():
        assert mixing.MIXING_RULES[name].rule == name
        assert jmix.MIXING_RULES[name].__name__ == cls.__name__
    for rule in ("voigt", "maximum", "random", "fiftyfifty"):
        assert isinstance(mixing.make_mixed(rule, phases()),
                          mixing.MIXING_RULES[rule])
    # the interface rules are not in MIXING_RULES (nor in the JAX
    # package's dict); make_mixed builds them by name
    fluids = [mixing.Phase(f"f{i}", laws.ScalarLinearIsotropic(mu=m, dim=6),
                           torch.as_tensor(phi))
              for i, (m, phi) in enumerate(zip((0.1, 1.0), _phis(2)))]
    for rule, cls in (("laminate", "LaminateMixed"),
                      ("infinity_laminate", "InfinityLaminateMixed"),
                      ("infinity-laminate", "InfinityLaminateMixed"),
                      ("fluidity", "FluidityMixed")):
        mat = mixing.make_mixed(rule, fluids if rule == "fluidity"
                                else phases())
        assert type(mat).__name__ == cls and not mat.iso_route()
        assert rule not in mixing.MIXING_RULES
        assert rule not in jmix.MIXING_RULES
    for fn in (mixing.make_mixed, jmix.make_mixed):
        with pytest.raises(ValueError, match="Unknown mixing rule"):
            fn("harmonic", phases())
    # Reuss, Split (Reuss on the volumetric part) and Iso need isotropic
    # laws, as in the JAX package
    F = torch.zeros((6,) + SHAPE, dtype=torch.float64)
    for rule, match in (("reuss", "reuss mixing needs isotropic laws"),
                        ("split", "reuss mixing needs isotropic laws"),
                        ("iso", "iso mixing needs isotropic laws")):
        with pytest.raises(NotImplementedError, match=match):
            mixing.make_mixed(rule, phases()).pk1(F)
    with pytest.raises(ValueError, match="exactly 2 phases"):
        mixing.make_mixed("iso", phases() + [mixing.Phase(
            "x", laws.LinearIsotropic(mu=1.0, lam=1.0),
            torch.zeros(SHAPE, dtype=torch.float64))])
    # finite strain: Voigt, Maximum, Random and 50-50 take it; Reuss and
    # Split (Reuss on the volumetric part) need isotropic laws
    svk = lambda: [mixing.Phase("a", laws.SaintVenantKirchhoff(1.0, 1.0),
                                torch.ones(SHAPE, dtype=torch.float64))]
    for rule in ("voigt", "maximum", "random", "fiftyfifty"):
        assert mixing.make_mixed(rule, svk(), dim=9).dim == 9
    for rule in ("reuss", "split"):
        with pytest.raises(NotImplementedError,
                           match="reuss mixing needs isotropic laws"):
            mixing.make_mixed(rule, svk(), dim=9)
