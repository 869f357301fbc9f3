"""The port's x-slab sharded solve against the JAX package's, on the CPU.

A mesh of repeated CPU devices (``parallel.make_mesh(["cpu"] * D)``) runs
the slab code with the plain twins, as the JAX package's tests run its
sharded code on forced host devices (conftest):

* op level: the halo stencils (K1 init and step, K2 with and without the
  dot) against pallas_kernels' ``axis_name`` variants under
  ``jax.shard_map``, and the slab chains (K3, K4, K5 at C = 6 and 3, K6)
  against pallas_chain's ``*_middle_slab``, all in interpret mode on eight
  devices at (16, 16, 128) float32;
* solve level in float64: every sharded path against the JAX package's
  sharded ``LSSolver`` (``use_pallas="off"``) on four devices, iteration
  for iteration, on (16, 8, 9) (kz = 5 does not split over 4) and
  (16, 8, 7) (kz = 4 does); in float32 against its fused sharded Pallas
  path;
* the port's sharded solve against its own unsharded one at D = 1, 2, 4;
* the refusals (the paths still refused on slabs: the multigrid G0 and
  ``sharding_fallback="warn"``).

The sharded hyperelastic and polarization paths are in
test_torch_parallel_hyper.py and test_torch_parallel_hyper_solve.py.

The CUDA kernels of the slab path are held against these twins in
test_torch_cuda.py.
"""
import contextlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh, NamedSharding as JSharding
from jax.sharding import PartitionSpec as P

import fibergen_tpu as fg
from fibergen_tpu.ops import fft as jfft
from fibergen_tpu.ops import green as jgreen
from fibergen_tpu.ops import pallas_chain as pc
from fibergen_tpu.ops import pallas_kernels as pk
from fibergen_tpu.parallel.fft import SlabFFT
from fibergen_tpu.utils.logging import LOG as JLOG
import fibergen_tpu_torch as ft
from fibergen_tpu_torch import parallel
from fibergen_tpu_torch.parallel import comm
from fibergen_tpu_torch.ops import green, spectral_kernels, stencil_kernels
from fibergen_tpu_torch.solvers.ls import SolverError
from fibergen_tpu_torch.utils.logging import LOG

torch.set_num_threads(2)

MU0, LAM0 = 1.7, 0.3
OP_SHAPE = (16, 16, 128)


@pytest.fixture(autouse=True)
def _quiet():
    old = (JLOG.enabled, LOG.enabled)
    JLOG.enabled = LOG.enabled = False
    yield
    JLOG.enabled, LOG.enabled = old


def _jmesh(d):
    devs = jax.devices()
    assert len(devs) >= d, "conftest must force 8 virtual CPU devices"
    return Mesh(np.array(devs[:d]), axis_names=("x",))


def _sharding(d):
    return JSharding(_jmesh(d), P(None, "x", None, None))


def _rel(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return np.max(np.abs(a - ref)) / np.max(np.abs(ref))


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.array(x), dtype=dtype)


@contextlib.contextmanager
def _forced_middle():
    old = (pc.MM_MIDDLE, pc.INTERPRET, pk.INTERPRET, jfft.FFT_BACKEND)
    pc.MM_MIDDLE, pc.INTERPRET, pk.INTERPRET = "on", True, True
    jfft.FFT_BACKEND = "matmul"
    try:
        yield
    finally:
        pc.MM_MIDDLE, pc.INTERPRET, pk.INTERPRET, jfft.FFT_BACKEND = old


# ------------------------------------------------------------- op level
def _op_inputs():
    rng = np.random.default_rng(21)
    shape = OP_SHAPE
    f32 = lambda a: np.asarray(a, np.float32)
    return dict(
        r=f32(rng.standard_normal((6,) + shape)),
        pp=f32(rng.standard_normal((6,) + shape)),
        u=f32(rng.standard_normal((3,) + shape)),
        mu=f32(1.0 + rng.random(shape)), lam=f32(0.5 + rng.random(shape)),
        E=f32(rng.standard_normal(6)), beta=np.float32(0.37))


def test_halo_stencils_match_sharded_pallas_kernels():
    """K1 (init and step) and K2 (with and without the dot) in halo mode
    on eight slabs against pallas_kernels' axis_name variants under
    shard_map (interpret mode): fields within 1e-6 of the reference's max,
    the dot (a psum there, a slab-order sum here) within 1e-6."""
    x = _op_inputs()
    grid = fg.Grid(*OP_SHAPE, dx=1.1, dy=0.8, dz=1.0)
    pgrid = ft.Grid(*OP_SHAPE, dx=1.1, dy=0.8, dz=1.0)
    jm = _jmesh(8)
    fs, ms, rs = P(None, "x", None, None), P("x", None, None), P()
    smap = lambda fn, i, o: jax.shard_map(fn, mesh=jm, in_specs=i,
                                          out_specs=o, check_vma=False)
    jf = lambda a: jnp.asarray(a)
    with _forced_middle():
        f_j, p_j = smap(
            lambda r, pp, b, m, l: pk.stress_div_beta_staggered(
                grid, r, pp, b, m, l, MU0, LAM0, axis_name="x"),
            (fs, fs, rs, ms, ms), (fs, fs))(
            jf(x["r"]), jf(x["pp"]), jf(x["beta"]), jf(x["mu"]),
            jf(x["lam"]))
        fi_j = smap(
            lambda r, m, l: pk.stress_div_staggered(
                grid, r, m, l, MU0, LAM0, axis_name="x"),
            (fs, ms, ms), fs)(jf(x["r"]), jf(x["mu"]), jf(x["lam"]))
        w_j, dot_j = smap(
            lambda u, p, e: pk.eps_from_u_dot_staggered(
                grid, e, u, p, axis_name="x"),
            (fs, fs, rs), (fs, rs))(jf(x["u"]), jf(x["pp"]), jf(x["E"]))
        wn_j = smap(
            lambda u, e: pk.eps_from_u_staggered(grid, e, u, axis_name="x"),
            (fs, rs), fs)(jf(x["u"]), jf(x["E"]))

    mesh = parallel.make_mesh(["cpu"] * 8)
    sh = lambda a: parallel.shard_field(_t(a), mesh)
    r, pp, u, mu, lam = (sh(x[k]) for k in ("r", "pp", "u", "mu", "lam"))
    beta = [_t(x["beta"])] * 8
    E = [_t(x["E"])] * 8
    f, p = stencil_kernels.stress_div_beta_slabs(pgrid, r, pp, beta, mu,
                                                 lam, MU0, LAM0)
    fi, none = stencil_kernels.stress_div_beta_slabs(pgrid, r, None, None,
                                                     mu, lam, MU0, LAM0)
    w, dot = stencil_kernels.eps_from_u_dot_slabs(pgrid, E, u, pp)
    wn, none2 = stencil_kernels.eps_from_u_dot_slabs(pgrid, E, u)
    assert none is None and none2 is None
    g = parallel.gather_field
    for out, ref in ((g(f), f_j), (g(p), p_j), (g(fi), fi_j), (g(w), w_j),
                     (g(wn), wn_j)):
        assert _rel(out, ref) <= 1e-6
    assert len(dot) == 8 and all(torch.equal(d, dot[0]) for d in dot)
    assert abs(float(dot[0]) - float(dot_j)) <= 1e-6 * abs(float(dot_j))


def _middle_cases():
    rng = np.random.default_rng(22)
    shape = OP_SHAPE
    tau6 = rng.standard_normal((6,) + shape)
    tau6[0] = -(tau6[1] + tau6[2])
    return dict(f3=rng.standard_normal((3,) + shape),
                f1=rng.standard_normal((1,) + shape),
                t6=tau6, t3=rng.standard_normal((3,) + shape),
                E6=rng.standard_normal(6))


@pytest.mark.parametrize("kind", ["g0", "g0_heat", "gamma6", "gamma3", "zt"])
def test_slab_chains_match_middle_slab(kind, monkeypatch):
    """Each slab chain's twin on eight x-slabs against the JAX package's
    kz-slab middle (pallas_chain.*_middle_slab, interpret mode) on the same
    x-slab-sharded field, float32, within 1e-6 of the reference's max."""
    x = {k: np.asarray(v, np.float32) for k, v in _middle_cases().items()}
    cell = dict(dx=1.2, dy=0.9, dz=1.0)
    jgrid, pgrid = fg.Grid(*OP_SHAPE, **cell), ft.Grid(*OP_SHAPE, **cell)
    jm = _jmesh(8)
    jpar = SlabFFT(jm, "x")
    spec = JSharding(jm, P(None, "x", None, None))
    mesh = parallel.make_mesh(["cpu"] * 8)
    par = parallel.slab_fft_for(parallel.field_sharding(mesh), pgrid)
    called = []
    for name in ("g0_staggered_middle_slab", "g0_staggered_heat_middle_slab",
                 "gamma_collocated_middle_slab",
                 "gamma_collocated_zt_middle_slab"):
        orig = getattr(pc, name)
        monkeypatch.setattr(pc, name, lambda *a, _o=orig, _n=name, **k: (
            called.append(_n), _o(*a, **k))[1])
    jx = lambda a: jax.device_put(jnp.asarray(a), spec)
    slabs = lambda a: parallel.shard_field(_t(a), mesh)
    E6, beta = x["E6"], 0.3
    A6, B6 = green.collocated_constants(MU0, LAM0)
    Az, Bz = green.collocated_constants(-MU0, float("inf"))
    c10, c20 = green.g0_constants(MU0, LAM0)
    with _forced_middle():
        if kind == "g0":
            ref = pc.g0_staggered_middle_slab(jpar, jgrid, jx(x["f3"]), c10,
                                              c20)
            out = spectral_kernels.g0_staggered_chain_slab(
                par, pgrid, slabs(x["f3"]), c10, c20)
        elif kind == "g0_heat":
            ref = pc.g0_staggered_heat_middle_slab(jpar, jgrid, jx(x["f1"]),
                                                   0.65)
            out = spectral_kernels.g0_staggered_heat_chain_slab(
                par, pgrid, slabs(x["f1"]), 0.65)
        elif kind == "gamma6":
            ref = jgreen.gamma_collocated_fused(jgrid, E6, MU0, LAM0,
                                                jx(x["t6"]), -1.0, beta,
                                                par=jpar)
            out = spectral_kernels.gamma_collocated_chain_slab(
                par, pgrid, slabs(x["t6"]), A6, B6, E6, beta)
        elif kind == "gamma3":
            ref = jgreen.gamma_collocated_heat_fused(
                jgrid, E6[:3], MU0, LAM0, jx(x["t3"]), -1.0, beta, par=jpar)
            out = spectral_kernels.gamma_collocated_chain_slab(
                par, pgrid, slabs(x["t3"]), 1.0 / (-2.0 * MU0), 0.0, E6[:3],
                beta)
        else:
            ref = jgreen.gamma_collocated_zt_fused(
                jgrid, E6, -MU0, float("inf"), jx(x["t6"]), -1.0, -0.5 / MU0,
                par=jpar)
            out = spectral_kernels.gamma_collocated_zt_chain_slab(
                par, pgrid, slabs(x["t6"]), Az, Bz, E6, -0.5 / MU0)
    assert len(called) == 1 and called[0].endswith("_middle_slab")
    assert _rel(parallel.gather_field(out), ref) <= 1e-6


# ------------------------------------------------------------ solve level
def _sphere(shape):
    ax = [(np.arange(s) + 0.5) / s - 0.5 for s in shape]
    X, Y, Z = np.meshgrid(*ax, indexing="ij")
    return ((X * X + Y * Y + Z * Z) < 0.09).astype(np.float64)


# mode -> (dim, port law, phases (fibre, matrix) moduli, load)
MODES = {
    "elasticity": (6, "isotropic", ((10.0, 5.0), (1.0, 1.0)),
                   [1.0, 0, 0, 0, 0, 0]),
    "heat": (3, "scalar", ((10.0,), (1.0,)), [1.0, 0, 0]),
    "porous": (3, "scalar", ((10.0,), (1.0,)), [0, 1.0, 0]),
    "viscosity": (6, "scalar", ((0.1,), (1.0,)), [0, 0, 0, 0, 1.0, 0]),
}


def _jax_solver(shape, mode, sharding, dtype="float64", **opt):
    dim, law, (mf, mm), _ = MODES[mode]
    phi = jnp.asarray(_sphere(shape).astype(dtype))
    if sharding is not None:
        phi = jax.device_put(phi, JSharding(sharding.mesh,
                                            P("x", None, None)))
    mk = (lambda m: fg.LinearIsotropic(mu=m[0], lam=m[1])) \
        if law == "isotropic" else \
        (lambda m: fg.ScalarLinearIsotropic(mu=m[0], dim=dim))
    mat = fg.VoigtMixed([fg.Phase("fiber", mk(mf), phi),
                         fg.Phase("matrix", mk(mm), 1.0 - phi)], dim=dim)
    s = fg.LSSolver(fg.Grid(*shape), mat, fg.SolverOptions(
        mode=mode, dtype=dtype, **opt), sharding=sharding)
    s.set_strain(MODES[mode][3])
    return s


def _port_solver(shape, mode, d=None, dtype="float64", **opt):
    dim, law, (mf, mm), load = MODES[mode]
    phi = _sphere(shape)
    mat = ft.convert.material_from_numpy(
        [("fiber", *mf, phi), ("matrix", *mm, 1.0 - phi)], dim=dim, law=law,
        device="cpu")
    sharding = None if d is None else parallel.field_sharding(
        parallel.make_mesh(["cpu"] * d))
    s = ft.LSSolver(ft.Grid(*shape), mat, ft.SolverOptions(
        mode=mode, dtype=dtype, **opt), device="cpu", sharding=sharding)
    s.set_strain(load)
    return s


def _jax_eps_after(s, n_steps):
    """The JAX solver's CG field after exactly ``n_steps`` steps (its host
    loop runs one chunk past the one where it detects convergence, the
    port's none)."""
    mf = s.mat.fields()
    E = jnp.asarray(s.E, s.dtype)
    eps, r, p, gamma, gamma_prev, _ = s._k_cg_init(
        mf, E, None, mu0=s.mu_0, lam0=s.lambda_0)
    for _ in range(n_steps):
        eps, r, p, gamma, gamma_prev, _ = s._k_cg_step(
            mf, eps, r, p, gamma, gamma_prev, None, mu0=s.mu_0,
            lam0=s.lambda_0)
    return np.asarray(eps)


# (mode, scheme, method, estimator): every path of the sharded slice with
# CG under both estimators and with basic, on the uneven kz split (16, 8, 9)
# and the even one (16, 8, 7)
SOLVES = [((16, 8, 9), c) for c in (
    ("elasticity", "staggered", "cg", "residual"),
    ("elasticity", "staggered", "basic", "epsilon"),
    ("heat", "staggered", "cg", "epsilon"),
    ("porous", "staggered", "basic", "epsilon"),
    ("elasticity", "collocated", "cg", "epsilon"),
    ("heat", "collocated", "basic", "epsilon"),
    ("porous", "collocated", "cg", "residual"),
    ("viscosity", "collocated", "cg", "residual"),
    ("viscosity", "collocated", "basic", "epsilon"))] + [
    ((16, 8, 7), c) for c in (
        ("elasticity", "staggered", "cg", "epsilon"),
        ("heat", "staggered", "cg", "residual"),
        ("elasticity", "collocated", "cg", "residual"),
        ("elasticity", "collocated", "basic", "epsilon"),
        ("viscosity", "collocated", "cg", "epsilon"))]


@pytest.mark.parametrize("shape,case", SOLVES)
def test_sharded_solve_matches_jax(shape, case):
    """The port's sharded solve on four CPU slabs against the JAX package's
    sharded solve on four devices (slab FFT, use_pallas="off"), float64:
    the same iterations, histories within 1e-9 (epsilon entries, a
    difference of two norms, or 1e-14 absolute), fields within 1e-9, mean
    stress within 1e-10 of its max."""
    mode, scheme, method, est = case
    opt = dict(gamma_scheme=scheme, method=method, error_estimator=est,
               tol=1e-8, maxiter=400)
    js = _jax_solver(shape, mode, _sharding(4), use_pallas="off", **opt)
    assert js.par is not None
    ps = _port_solver(shape, mode, 4, **opt)
    assert ps.par is not None and ps.par.n_devices == 4
    assert not js.run() and not ps.run()
    assert ps.mu_0 == js.mu_0
    rj, rp = np.asarray(js.residuals), np.asarray(ps.residuals)
    assert len(rp) == len(rj)
    np.testing.assert_allclose(rp, rj, rtol=1e-9,
                               atol=1e-14 if est == "epsilon" else 0.0)
    eps = ps.get_field("epsilon")
    eps_ref = _jax_eps_after(js, len(rp)) if method == "cg" \
        else np.asarray(js.eps)
    assert eps.shape == eps_ref.shape
    assert np.max(np.abs(eps - eps_ref)) <= 1e-9
    S_ref = np.asarray(js.mat.mean_pk1(jnp.asarray(eps_ref)))
    np.testing.assert_allclose(ps.calc_mean_stress(), S_ref, rtol=0,
                               atol=1e-10 * np.max(np.abs(S_ref)))


def test_sharded_float32_matches_jax_fused_pallas_path():
    """float32 on (16, 16, 128): the port's sharded staggered elasticity
    solve (halo stencils around the slab chain) against the JAX package's
    fused sharded Pallas path with the kz-slab middle (interpret mode) on
    eight devices: iterations within one, mean stress within 5e-4."""
    opt = dict(tol=1e-5, maxiter=400, error_estimator="residual")
    with _forced_middle():
        js = _jax_solver(OP_SHAPE, "elasticity", _sharding(8), "float32",
                         use_pallas="on", **opt)
        assert js._pallas_active and js.par is not None
        assert not js.run()
    ps = _port_solver(OP_SHAPE, "elasticity", 8, "float32", **opt)
    assert not ps.run()
    assert abs(len(ps.residuals) - len(js.residuals)) <= 1
    np.testing.assert_allclose(ps.calc_mean_stress(),
                               np.asarray(js.calc_mean_stress()), rtol=5e-4,
                               atol=1e-5)


@pytest.mark.parametrize("d", [1, 2, 4])
@pytest.mark.parametrize("mode,scheme", [
    ("elasticity", "staggered"), ("heat", "staggered"),
    ("elasticity", "collocated"), ("viscosity", "collocated")])
def test_sharded_matches_unsharded(d, mode, scheme):
    """The port against itself: sharded over D slabs (D = 1: one slab that
    wraps its own halo) and unsharded, float64, (16, 8, 9): the same
    iterations, histories within 1e-9, fields within 1e-12."""
    opt = dict(gamma_scheme=scheme, error_estimator="residual", tol=1e-8,
               maxiter=400)
    s0 = _port_solver((16, 8, 9), mode, None, **opt)
    s1 = _port_solver((16, 8, 9), mode, d, **opt)
    assert not s0.run() and not s1.run()
    assert isinstance(s1.eps, list) and len(s1.eps) == d
    assert len(s1.residuals) == len(s0.residuals)
    np.testing.assert_allclose(s1.residuals, s0.residuals, rtol=1e-9)
    assert np.max(np.abs(s1.get_field("epsilon")
                         - s0.get_field("epsilon"))) <= 1e-12
    np.testing.assert_allclose(s1.calc_mean_strain(), s0.calc_mean_strain(),
                               rtol=0, atol=1e-13)


# ----------------------------------------------------------- the pieces
def test_mesh_and_layout():
    mesh = parallel.make_mesh(["cpu"] * 4)
    assert mesh.size == 4 and all(d.type == "cpu" for d in mesh.devices)
    x = torch.arange(2 * 8 * 3 * 5, dtype=torch.float64).reshape(2, 8, 3, 5)
    slabs = parallel.shard_field(x, mesh)
    assert [tuple(s.shape) for s in slabs] == [(2, 2, 3, 5)] * 4
    assert all(s.is_contiguous() for s in slabs)
    assert torch.equal(parallel.gather_field(slabs), x)
    slabs[0].zero_()                        # slabs own their storage
    assert x[0, 0, 0, 1] == 1
    minus, plus = comm.halo_x(parallel.shard_field(x, mesh))
    assert torch.equal(minus[0], x[:, 7:8]) and torch.equal(plus[3],
                                                            x[:, 0:1])
    assert torch.equal(minus[2], x[:, 3:4]) and torch.equal(plus[1],
                                                            x[:, 4:5])
    par = parallel.SlabPar(mesh)
    assert par.kz_split(5) == [(0, 2), (2, 1), (3, 1), (4, 1)]
    assert par.kz_split(3) == [(0, 1), (1, 1), (2, 1), (3, 0)]
    assert par.kz_split(8) == [(0, 2), (2, 2), (4, 2), (6, 2)]
    total = comm.psum([torch.tensor(float(i)) for i in range(4)])
    assert [float(t) for t in total] == [6.0] * 4
    assert parallel.good_slab_size(16, 4) and not parallel.good_slab_size(
        12, 8)
    with pytest.raises(ValueError, match="not both"):
        parallel.make_mesh(["cpu", "cuda:0"])
    with pytest.raises(ValueError, match="equal"):
        parallel.shard_field(torch.zeros(3, 6, 2, 2), mesh)


def test_make_mesh_needs_a_card_without_a_list(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        parallel.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        parallel.make_mesh(["cuda:0"] * 2)


def test_uneven_kz_splits_hold_the_dc_and_nyquist_planes():
    """kz = 3 over eight slabs: five slabs hold no kz column, and the one
    holding kz = 0 alone sets the DC bin; the collocated chain still
    matches the unsharded twin, Hermitian planes included."""
    shape = (8, 4, 4)
    g = ft.Grid(*shape, dx=1.3)
    rng = np.random.default_rng(23)
    tau = torch.as_tensor(rng.standard_normal((6,) + shape))
    E = rng.standard_normal(6)
    mesh = parallel.make_mesh(["cpu"] * 8)
    par = parallel.SlabPar(mesh)
    assert sum(w == 0 for _, w in par.kz_split(g.nzc)) == 5
    out = spectral_kernels.gamma_collocated_chain_slab(
        par, g, parallel.shard_field(tau, mesh), 0.7, -0.2, E, 0.1)
    ref = spectral_kernels.gamma_collocated_chain_plain(g, tau, 0.7, -0.2, E,
                                                        0.1)
    assert _rel(parallel.gather_field(out), ref) <= 1e-13
    np.testing.assert_allclose(
        parallel.gather_field(out).mean(dim=(-3, -2, -1)).numpy(), E,
        atol=1e-13)


# ----------------------------------------------------------- refusals
def test_refusals_match_the_jax_package():
    """A grid whose nx or ny does not divide the mesh, and a split of a
    non-x axis, raise SolverError with the JAX package's reasons."""
    phi = np.full((12, 8, 8), 0.5)
    mat = ft.convert.material_from_numpy(
        [("a", 1.0, 1.0, phi), ("b", 5.0, 2.0, 1.0 - phi)], device="cpu")
    mesh = parallel.make_mesh(["cpu"] * 8)
    with pytest.raises(SolverError, match="not divisible"):
        ft.LSSolver(ft.Grid(12, 8, 8), mat, ft.SolverOptions(),
                    sharding=parallel.field_sharding(mesh))
    phi = np.full((16, 8, 8), 0.5)
    mat = ft.convert.material_from_numpy(
        [("a", 1.0, 1.0, phi), ("b", 5.0, 2.0, 1.0 - phi)], device="cpu")
    bad = parallel.NamedSharding(mesh, (None, None, "x", None))
    with pytest.raises(SolverError, match="slab"):
        ft.LSSolver(ft.Grid(16, 8, 8), mat, ft.SolverOptions(), sharding=bad)
    # a replicated sharding solves unsharded on the mesh's first device
    s = ft.LSSolver(ft.Grid(16, 8, 8), mat, ft.SolverOptions(),
                    sharding=parallel.NamedSharding(mesh, (None,) * 4))
    assert s.par is None
    # the same reasons as the JAX package's
    from fibergen_tpu.parallel.fft import slab_reject_reason as jreason
    for spec in ((None, "x", None, None), (None, None, "x", None),
                 (None, None, None, None)):
        for shape in ((12, 8, 8), (16, 8, 8), (16, 12, 8)):
            assert parallel.slab_reject_reason(
                parallel.NamedSharding(mesh, spec), ft.Grid(*shape)) == \
                jreason(JSharding(_jmesh(8), P(*spec)), fg.Grid(*shape))


@pytest.mark.parametrize("kw,shape,exc,match", [
    # the multigrid G0 on slabs and the whole-device fallback now solve
    (dict(g0_solver="multigrid"), (16, 8, 8), None, None),
    (dict(sharding_fallback="warn"), (18, 8, 8), None, None),
    # the sharded Newton path refuses a grid the slabs cannot split, as
    # the linear paths do
    (dict(mode="hyperelasticity"), (18, 8, 8), SolverError, "not divisible"),
])
def test_unported_sharded_paths_raise(kw, shape, exc, match):
    """What a four-slab CPU mesh still refuses raises; the multigrid G0
    (on the slabs) and ``sharding_fallback="warn"`` (whole, 18 % 4 != 0)
    solve to the unsharded port's mean stress within 1e-12."""
    mode = kw.get("mode", "elasticity")
    phi = np.full(shape, 0.5)
    if mode == "hyperelasticity":
        mat = ft.convert.material_from_numpy(
            [("a", 1.0, 1.0, phi), ("b", 2.0, 1.0, 1.0 - phi)], dim=9,
            law="svk", device="cpu")
    elif mode == "viscosity":
        mat = ft.convert.material_from_numpy(
            [("a", 1.0, phi), ("b", 0.1, 1.0 - phi)], dim=6, law="scalar",
            device="cpu")
    else:
        phi[: shape[0] // 3] = 0.9
        mat = ft.convert.material_from_numpy(
            [("a", 1.0, 1.0, phi), ("b", 5.0, 2.0, 1.0 - phi)], device="cpu")
    sharding = parallel.field_sharding(parallel.make_mesh(["cpu"] * 4))
    if exc is not None:
        with pytest.raises(exc, match=match):
            ft.LSSolver(ft.Grid(*shape), mat, ft.SolverOptions(**kw),
                        sharding=sharding)
        return
    opt = ft.SolverOptions(tol=1e-8, **kw)
    s = ft.LSSolver(ft.Grid(*shape), mat, opt, sharding=sharding)
    assert (s.par is None) == ("sharding_fallback" in kw)
    ref = ft.LSSolver(ft.Grid(*shape), mat, opt, device="cpu")
    for x in (s, ref):
        x.set_strain([0.01, 0, 0, 0, 0.002, 0])
        assert not x.run()
    assert len(s.residuals) == len(ref.residuals)
    np.testing.assert_allclose(s.calc_mean_stress(), ref.calc_mean_stress(),
                               rtol=0, atol=1e-12)


def test_device_must_agree_with_the_mesh():
    phi = np.full((8, 4, 4), 0.5)
    mat = ft.convert.material_from_numpy(
        [("a", 1.0, 1.0, phi), ("b", 5.0, 2.0, 1.0 - phi)], device="cpu")
    sharding = parallel.field_sharding(parallel.make_mesh(["cpu"] * 2))
    with pytest.raises(ValueError, match="disagrees"):
        ft.LSSolver(ft.Grid(8, 4, 4), mat, device="cuda", sharding=sharding)
    s = ft.LSSolver(ft.Grid(8, 4, 4), mat, device="cpu", sharding=sharding)
    assert s.device.type == "cpu" and s.par.n_devices == 2
