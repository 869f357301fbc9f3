"""Shared problems of the sharded-path parity tests
(test_torch_parallel_paths.py, test_torch_parallel_materials.py): the same
material, loading and options built in the JAX package and in the port,
the JAX solver sharded over four forced host devices (conftest) with
``use_pallas="off"``, the port's over four CPU slabs.

A case is ``(material, mode, options, bc)``: ``material`` a key of
:func:`materials`, ``bc`` None or a key of :data:`BCS` (a Voigt projector
and a prescribed stress).
"""
import numpy as np

import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh, NamedSharding as JSharding
from jax.sharding import PartitionSpec as P

import fibergen_tpu as fg
from fibergen_tpu.materials import dfg as jdfg
from fibergen_tpu.materials import laminate as jlam
from fibergen_tpu.materials import laws as jl
from fibergen_tpu.materials import mixing as jmix
import fibergen_tpu_torch as ft
from fibergen_tpu_torch import parallel
from fibergen_tpu_torch.core import voigt

torch.set_num_threads(2)

TISO = dict(E=3860.0, nu=0.2, E_a=5390.0, G_a=390.0, nu_a=0.031)
AXIS = [1.0, 0.3, -0.2]
JRULES = {"voigt": jmix.VoigtMixed, "reuss": jmix.ReussMixed,
          "maximum": jmix.MaximumMixed, "random": jmix.RandomMixed,
          "fiftyfifty": jmix.FiftyFiftyMixed, "split": jmix.SplitMixed,
          "iso": jmix.IsoMixed, "laminate": jlam.LaminateMixed,
          "infinity_laminate": jlam.InfinityLaminateMixed,
          "fluidity": jlam.FluidityMixed}
LOADS = {"elasticity": [0.01, -0.002, 0.003, 0.004, 0.0, 0.002],
         "heat": [1.0, 0.5, 0.0], "viscosity": [0, 0, 0, 0, 1.0, 0.3],
         "hyperelasticity": [1.02, 1, 1, 0, 0, 0, 0, 0, 0]}


def _bc(dim, k, s):
    Pm = voigt.id4(dim)
    Pm[k, k] = 0.0
    S = np.zeros(dim)
    S[k] = s
    return Pm, S


# stress control on one component, strain control on the others
BCS = {"xx": _bc(6, 0, 2.0), "xz": _bc(6, 4, 0.4), "heat-x": _bc(3, 0, 1.5),
       "F11": _bc(9, 0, 0.1)}


def sphere(shape, smooth=False, ss=4, r2=0.09):
    """phi of a centred sphere, sharp or (``smooth``) its partial volume:
    the share of ss^3 points of each voxel inside it; and its outward unit
    normals."""
    ax = [(np.arange(s) + 0.5) / s - 0.5 for s in shape]
    X = np.stack(np.meshgrid(*ax, indexing="ij"))
    d2 = (X * X).sum(0)
    n = X / np.maximum(np.sqrt(d2), 1e-12)
    if not smooth:
        return (d2 < r2).astype(np.float64), n
    fine = [((np.arange(s * ss) + 0.5) / (s * ss) - 0.5) ** 2 for s in shape]
    inside = (fine[0][:, None, None] + fine[1][None, :, None]
              + fine[2][None, None, :]) < r2
    phi = inside.reshape(shape[0], ss, shape[1], ss, shape[2], ss).mean(
        axis=(1, 3, 5))
    return phi, n


def _orientation(shape):
    v = np.random.default_rng(0).standard_normal((3,) + shape)
    return v / np.linalg.norm(v, axis=0, keepdims=True)


def _laws(name, shape):
    """(dim, rule, [(JAX law, port phase law)] of fibre and matrix, smooth:
    whether the sphere is a partial volume)."""
    iso = [(jl.LinearIsotropic(mu=10.0, lam=5.0), ("isotropic", 10.0, 5.0)),
           (jl.LinearIsotropic(mu=1.0, lam=1.0), ("isotropic", 1.0, 1.0))]
    visc = [(jl.ScalarLinearIsotropic(mu=m, dim=6), ("scalar", m))
            for m in (0.1, 1.0)]
    matrix = (jl.LinearIsotropic(mu=350.0, lam=525.0),
              ("isotropic", 350.0, 525.0))
    if name == "iso":
        return 6, "voigt", iso, None
    if name == "visc":
        return 6, "voigt", visc, None
    if name == "visc-lambda":
        # 2 mu + 3 lam < 4 mu_0 in both phases: regular on the trace
        return 6, "voigt", [
            (jl.LinearIsotropic(mu=m, lam=lm), ("isotropic", m, lm))
            for m, lm in ((0.1, 0.01), (1.0, 0.05))], None
    if name == "visc-maximum":
        return 6, "maximum", visc, None
    if name == "heat":
        return 3, "voigt", [(jl.ScalarLinearIsotropic(mu=m, dim=3),
                             ("scalar", m)) for m in (10.0, 1.0)], None
    if name == "tiso":
        return 6, "voigt", [(jl.LinearTransverselyIsotropic(
            a=np.array(AXIS), **TISO), ("tiso", TISO, AXIS)), matrix], True
    if name == "tiso-field":
        o = _orientation(shape)
        return 6, "voigt", [(jl.LinearTransverselyIsotropic(
            orientation=jnp.asarray(o), **TISO), ("tiso", TISO, o)),
            matrix], True
    if name == "general":
        A = np.random.default_rng(1).standard_normal((6, 6))
        C = 100.0 * (A @ A.T + 6.0 * np.eye(6))
        return 6, "voigt", [(jl.LinearGeneral(C=C), ("general", C)),
                            matrix], True
    if name == "aniso":
        A = np.random.default_rng(2).standard_normal((3, 3))
        K = A @ A.T + 3.0 * np.eye(3) + 0.2 * (A - A.T)
        return 3, "voigt", [(jl.MatrixLinearAnisotropic(K=K), ("aniso", K)),
                            (jl.ScalarLinearIsotropic(mu=1.0, dim=3),
                             ("scalar", 1.0))], True
    if name == "fluidity":
        return 6, "fluidity", visc, True
    if name in ("svk", "svk-maximum", "svk-laminate"):
        rule = {"svk": "voigt", "svk-maximum": "maximum",
                "svk-laminate": "laminate"}[name]
        return 9, rule, [(jl.SaintVenantKirchhoff(mu=m, lam=lm),
                          ("svk", m, lm)) for m, lm in ((10.0, 5.0),
                                                        (1.0, 1.0))], \
            rule != "voigt"
    # a mixing rule over the isotropic phases on the partial-volume sphere
    return 6, "iso" if name == "iso-rule" else name, iso, True


def materials(name, shape, fine=False):
    """(JAX material, port material) of ``name`` on ``shape``; ``fine``
    puts the phases on the doubly-fine grid in a DfgMaterial of each."""
    dim, rule, pl, smooth = _laws(name, shape)
    pshape = tuple(2 * n for n in shape) if fine else shape
    phi, n = sphere(pshape, bool(smooth))
    phis = [phi, 1.0 - phi]
    kw = {}
    if rule in ("laminate", "infinity_laminate", "fluidity"):
        kw = dict(normals=jnp.asarray(n))
    jmat = JRULES[rule]([fg.Phase(f"p{i}", j, jnp.asarray(ph))
                         for i, ((j, _), ph) in enumerate(zip(pl, phis))],
                        dim=dim, **kw)
    pmat = ft.convert.material_from_numpy(
        [(f"p{i}", p, ph) for i, ((_, p), ph) in enumerate(zip(pl, phis))],
        dim=dim, device="cpu", rule=rule,
        normals=n if kw else None)
    if fine:
        jmat, pmat = jdfg.DfgMaterial(jmat), ft.DfgMaterial(pmat)
    return jmat, pmat


def jax_sharding(d=4):
    devs = jax.devices()
    assert len(devs) >= d, "conftest must force 8 virtual CPU devices"
    return JSharding(Mesh(np.array(devs[:d]), axis_names=("x",)),
                     P(None, "x", None, None))


def port_sharding(d):
    return None if d is None else parallel.field_sharding(
        parallel.make_mesh(["cpu"] * d))


def _load(s, mode, bc):
    if bc is not None:
        Pm, S = BCS[bc]
        s.set_bc_projector(Pm)
        s.set_stress(S)
    E = np.asarray(LOADS[mode], dtype=np.float64)
    if bc is not None:
        # the stress-controlled component's strain is free
        E = np.where(np.diag(BCS[bc][0]) == 0.0, 0.0, E)
    s.set_strain(E)


def port_solver(name, shape, mode, d=None, bc=None, fine=False, **opt):
    """The port's solver of the case, sharded over ``d`` CPU slabs (None:
    unsharded)."""
    _, pmat = materials(name, shape, fine)
    s = ft.LSSolver(ft.Grid(*shape), pmat, ft.SolverOptions(
        mode=mode, dtype="float64", maxiter=500, **opt), device="cpu",
        sharding=port_sharding(d))
    _load(s, mode, bc)
    return s


def jax_solver(name, shape, mode, bc=None, fine=False, **opt):
    """The JAX package's sharded solver of the case on four devices."""
    jmat, _ = materials(name, shape, fine)
    s = fg.LSSolver(fg.Grid(*shape), jmat, fg.SolverOptions(
        mode=mode, dtype="float64", maxiter=500, use_pallas="off", **opt),
        sharding=jax_sharding())
    assert s.par is not None
    _load(s, mode, bc)
    return s


def same_solve(js, ps, atol=0.0):
    """The limits of test_torch_parallel.test_sharded_solve_matches_jax:
    the same iterations, histories within 1e-9 (``atol`` for the epsilon
    estimator's differences of norms), the field within 1e-9, the mean
    stress within 1e-10 of its max."""
    assert ps.mu_0 == js.mu_0 or abs(ps.mu_0 - js.mu_0) <= 1e-14 * js.mu_0
    rj, rp = np.asarray(js.residuals), np.asarray(ps.residuals)
    assert len(rp) == len(rj) and 1 < len(rp) < 500
    np.testing.assert_allclose(rp, rj, rtol=1e-9, atol=atol)
    eps = ps.get_field("epsilon")
    assert np.max(np.abs(eps - np.asarray(js.eps))) <= 1e-9
    S_ref = np.asarray(js.calc_mean_stress())
    np.testing.assert_allclose(ps.calc_mean_stress(), S_ref, rtol=0,
                               atol=1e-10 * np.max(np.abs(S_ref)))


def same_as_unsharded(s0, s1):
    """The sharded solve ``s1`` against the unsharded ``s0``: the same
    iterations, histories within 1e-9, fields within 1e-12 of the field's
    max, mean stress within 1e-12 of its max."""
    assert isinstance(s1.eps, list)
    assert len(s1.residuals) == len(s0.residuals)
    np.testing.assert_allclose(s1.residuals, s0.residuals, rtol=1e-9,
                               atol=1e-15)
    e0 = s0.get_field("epsilon")
    assert np.max(np.abs(s1.get_field("epsilon") - e0)) \
        <= 1e-12 * np.max(np.abs(e0))
    S0 = s0.calc_mean_stress()
    np.testing.assert_allclose(s1.calc_mean_stress(), S0, rtol=0,
                               atol=1e-12 * np.max(np.abs(S0)))

