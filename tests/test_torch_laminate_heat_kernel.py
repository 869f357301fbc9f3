"""The dim-3 laminate's stress difference (``ops/material_kernels.py``,
``csrc/laminate_heat.cu``) and the material's route to it
(``LaminateMixed._heat_route``).

On the CPU: the wrapper takes the plain twin, which gives the sequence the
laminate ran before the kernel bitwise (interface thresholds, vanishing,
non-unit and flipped normals, both rules, B = 1, 3 and 9), and counts no
launch; the batched entry, pk1, dpk1, the route's reach and a heat
``run_batched`` against the material's generic path.  On the card
(skipped without one): the kernel against its twin, its launch count and
its refusals, and a heat ``run_batched`` against the CPU.  The module
imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_laminate_heat_kernel.py -q
"""
import numpy as np
import pytest
import torch

import fibergen_tpu_torch as ft
from fibergen_tpu_torch.materials import laminate
from fibergen_tpu_torch.materials.sharded import for_slabs
from fibergen_tpu_torch.ops import material_kernels as mk
from fibergen_tpu_torch.parallel import make_mesh, shard_field
from fibergen_tpu_torch.utils.logging import LOG

torch.set_num_threads(2)

RULES = ["laminate", "infinity_laminate"]
MU = (0.5, 5.0)                 # the phases' laws: k = 2 iso mu = mu
MU0 = 2.75


@pytest.fixture(autouse=True)
def _quiet():
    old = LOG.enabled
    LOG.enabled = False
    yield
    LOG.enabled = old


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _fields(shape, dtype, B, device="cpu", seed=7):
    """phi1, phi2 with voxels at and below the interface threshold in
    either phase, normals of random length and sign with vanishing ones
    among them, and B strain fields."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    phi1 = rng.random(n)
    phi2 = 1.0 - phi1
    k = max(n // 8, 1)
    at = rng.choice(n, 4 * k, replace=False)
    phi1[at[:k]] = 1e-7                              # at the threshold
    phi1[at[k:2 * k]] = 3e-8                         # below it
    phi2[at[:2 * k]] = 1.0 - phi1[at[:2 * k]]
    phi2[at[2 * k:3 * k]] = 1e-7
    phi2[at[3 * k:]] = 0.0
    phi1[at[2 * k:]] = 1.0 - phi2[at[2 * k:]]
    nrm = rng.standard_normal((3, n)) * rng.uniform(0.2, 3.0, n)
    nrm *= np.where(rng.random(n) < 0.5, -1.0, 1.0)
    nrm[:, rng.choice(n, k, replace=False)] = 0.0     # -> e_x
    nrm[:, rng.choice(n, k, replace=False)] = 1e-7    # |n|^2 below 1e-12
    t = lambda a, s: torch.as_tensor(a.reshape(s), dtype=dtype,
                                     device=device)
    xs = [t(rng.standard_normal((3, n)), (3,) + shape) for _ in range(B)]
    return t(phi1, shape), t(phi2, shape), t(nrm, (3,) + shape), xs


def _before(phi1, phi2, normals, F, mu0, rule):
    """The laminate's stress difference as the material formed it before
    the kernel: ``_phase_strains``' dim-3 branch, the phases' pk1 and
    ``MixedMaterial.stress_diff``'s P - 2 mu0 F (pk1 alone with mu0
    None)."""
    law1, law2 = (ft.ScalarLinearIsotropic(mu=m, dim=3) for m in MU)
    c1, c2 = phi1, phi2
    mask = (c1 > 1e-7) & (c2 > 1e-7)
    nn2 = (normals * normals).sum(0, keepdim=True)
    ex = torch.zeros_like(normals)
    ex[0] = 1.0
    n = torch.where(nn2 > 1e-12, normals, ex)
    if rule == "laminate":
        a1, a2 = c2, c1
    else:
        a1 = a2 = torch.full_like(c1, 0.5)
    k1 = 2.0 * law1.iso_moduli()[0]
    k2 = 2.0 * law2.iso_moduli()[0]
    ng = (n * F).sum(0)
    s = (c1 * a1 * k1 - c2 * a2 * k2) * ng / (
        c1 * a1 * a1 * k1 + c2 * a2 * a2 * k2)
    s = torch.where(mask, s, torch.zeros_like(s))
    F1, F2 = F - (a1 * s)[None] * n, F + (a2 * s)[None] * n
    P = c1[None] * law1.pk1(F1) + c2[None] * law2.pk1(F2)
    return P if mu0 is None else P - 2.0 * mu0 * F


def _material(rule, phi1, phi2, normals, dim=3, law=None):
    law = law or (lambda m: ft.ScalarLinearIsotropic(mu=m, dim=dim))
    cls = (ft.LaminateMixed if rule == "laminate"
           else laminate.InfinityLaminateMixed)
    return cls([ft.Phase("a", law(MU[0]), phi1),
                ft.Phase("b", law(MU[1]), phi2)], dim=dim, normals=normals)


# ----------------------------------------------------------------- CPU

@pytest.mark.parametrize("B", [1, 3, 9])
@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mu0", [MU0, 0.0])
def test_twin_is_the_old_path_bitwise(B, rule, dtype, mu0):
    phi1, phi2, n, xs = _fields((11, 7, 5), dtype, B)
    out = torch.empty((B, 3, 11, 7, 5), dtype=dtype)
    before = dict(mk.launches)
    got = mk.laminate_heat(phi1, phi2, n, xs, out, MU[0], MU[1], mu0, rule)
    assert got is out and mk.launches == before
    for b, F in enumerate(xs):
        ref = _before(phi1, phi2, n, F, None if mu0 == 0.0 else mu0, rule)
        assert torch.equal(out[b], ref), b


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_material_is_the_old_path_bitwise(rule, dtype):
    """stress_diff, stress_diffs and pk1 of the material, which reads phi
    and the normals in the field's type."""
    phi1, phi2, n, xs = _fields((9, 6, 4), dtype, 3)
    mat = _material(rule, phi1.double(), phi2.double(), n.double())
    out = torch.empty((3,) + tuple(xs[0].shape), dtype=dtype)
    assert mat.stress_diffs(xs, MU0, 0.0, out) is out
    for b, F in enumerate(xs):
        ref = _before(phi1, phi2, n, F, MU0, rule)
        assert torch.equal(mat.stress_diff(F, MU0, 0.0), ref)
        assert torch.equal(out[b], ref)
        assert torch.equal(mat.pk1(F), _before(phi1, phi2, n, F, None, rule))


@pytest.mark.parametrize("rule", RULES)
def test_stress_diffs_is_the_stacked_stress_diff(rule):
    phi1, phi2, n, xs = _fields((8, 8, 3), torch.float64, 4, seed=2)
    mat = _material(rule, phi1, phi2, n)
    out = mat.stress_diffs(xs, MU0, 0.0, torch.empty((4, 3, 8, 8, 3),
                                                     dtype=torch.float64))
    assert torch.equal(out, torch.stack([mat.stress_diff(x, MU0, 0.0)
                                         for x in xs]))


def test_default_stress_diffs_is_the_stacked_stress_diff():
    """A material off the route (Voigt, dim 6) fills the batch case by
    case."""
    phi1, phi2, _, _ = _fields((6, 5, 4), torch.float64, 1, seed=3)
    mat = ft.VoigtMixed([
        ft.Phase("a", ft.LinearIsotropic(mu=1.0, lam=2.0), phi1),
        ft.Phase("b", ft.LinearIsotropic(mu=3.0, lam=0.5), phi2)], dim=6)
    xs = [torch.randn((6, 6, 5, 4), dtype=torch.float64) for _ in range(3)]
    out = mat.stress_diffs(xs, 0.7, 0.2, torch.empty((3, 6, 6, 5, 4),
                                                     dtype=torch.float64))
    assert torch.equal(out, torch.stack([mat.stress_diff(x, 0.7, 0.2)
                                         for x in xs]))


@pytest.mark.parametrize("rule", RULES)
def test_pk1_is_stress_diff_at_mu0_zero(rule):
    phi1, phi2, n, xs = _fields((7, 7, 7), torch.float32, 1, seed=4)
    mat = _material(rule, phi1, phi2, n)
    assert torch.equal(mat.pk1(xs[0]), mat.stress_diff(xs[0], 0.0, 0.0))


@pytest.mark.parametrize("rule", RULES)
def test_dpk1_is_pk1_of_w(rule):
    """For linear laws the tangent is the response itself; the jvp through
    the plain twin agrees."""
    phi1, phi2, n, xs = _fields((6, 5, 4), torch.float64, 2, seed=5)
    mat = _material(rule, phi1, phi2, n)
    F, W = xs
    got = mat.dpk1(F, W)
    assert torch.equal(got, mat.pk1(W))
    jvp = torch.func.jvp(lambda f: _before(phi1, phi2, n, f, None, rule),
                         (F,), (W,))[1]
    assert torch.allclose(got, jvp, rtol=0.0, atol=1e-13)


def _count_routes(monkeypatch):
    calls = []
    orig = mk.laminate_heat
    monkeypatch.setattr(mk, "laminate_heat",
                        lambda *a: calls.append(len(a[3])) or orig(*a))
    return calls


@pytest.mark.parametrize("case", ["dim 3", "infinity dim 3", "dim 6",
                                  "dim 9", "three phases", "x-slabs",
                                  "lambda"])
def test_the_route_is_taken_where_it_applies(monkeypatch, case):
    calls = _count_routes(monkeypatch)
    shape = (8, 6, 4)
    phi1, phi2, n, xs = _fields(shape, torch.float64, 2, seed=6)
    rule = "infinity_laminate" if case == "infinity dim 3" else "laminate"
    F = xs[0]
    if case in ("dim 3", "infinity dim 3"):
        mat = _material(rule, phi1, phi2, n)
    elif case == "dim 6":
        mat = _material(rule, phi1, phi2, n, dim=6,
                        law=lambda m: ft.LinearIsotropic(mu=m, lam=0.0))
        F = torch.cat([F, F])
    elif case == "dim 9":
        mat = _material(rule, phi1, phi2, n, dim=9,
                        law=lambda m: ft.SaintVenantKirchhoff(mu=m, lam=1.0))
        F = torch.cat([F, F, F]) * 0.01
        F[0:3] += 1.0
    elif case == "three phases":
        third = 0.25 * phi1
        mat = ft.LaminateMixed([
            ft.Phase("a", ft.ScalarLinearIsotropic(mu=1.0, dim=3),
                     0.75 * phi1),
            ft.Phase("b", ft.ScalarLinearIsotropic(mu=2.0, dim=3), phi2),
            ft.Phase("c", ft.ScalarLinearIsotropic(mu=4.0, dim=3), third)],
            dim=3, normals=n)
    elif case == "lambda":
        mat = _material(rule, phi1, phi2, n,
                        law=lambda m: ft.LinearIsotropic(mu=m, lam=1.0,
                                                         dim=3))
    else:
        mesh = make_mesh(["cpu"] * 2)
        mat = for_slabs(_material(rule, phi1, phi2, n))
        F = shard_field(F, mesh)
    if case == "x-slabs":
        # each slab's view takes the route on its slab, one call a slab
        want = [[1, 1], [1, 1, 1, 1], [1] * 8]
        out = [None, None]
        G = [f.clone() for f in F]
    else:
        taken = case in ("dim 3", "infinity dim 3")
        want = [[1], [1, 1], [1, 1, 2]] if taken else [[], [], []]
        out = torch.empty((2,) + tuple(F.shape), dtype=F.dtype)
        G = F.clone()
    mat.stress_diff(F, 0.5, 0.0)
    assert calls == want[0]
    mat.pk1(F)
    assert calls == want[1]
    mat.stress_diffs([F, G], 0.5, 0.0, out)
    assert calls == want[2]
    if case == "x-slabs":
        whole = _material(rule, phi1, phi2, n).stress_diff(xs[0], 0.5, 0.0)
        assert torch.equal(torch.cat(out[0], 1), whole)


def _heat_laminate(shape, device, dtype="float64"):
    """A layered heat laminate with tilted normals, the solver and I3."""
    x = (np.arange(shape[0]) + 0.5) / shape[0]
    y = (np.arange(shape[1]) + 0.5) / shape[1]
    X, Y = np.meshgrid(x, y, indexing="ij")
    phi = np.clip(2.0 * np.abs(((X + 0.3 * Y) % 1.0) - 0.5) * 4 - 1.0, 0, 1)
    phi = np.broadcast_to(phi[:, :, None], shape).copy()
    nrm = np.zeros((3,) + shape)
    nrm[0], nrm[1] = 1.0, 0.3
    mat = ft.convert.material_from_numpy(
        [("matrix", 1.0, 1.0 - phi), ("fiber", 10.0, phi)], dim=3,
        law="scalar", rule="laminate", normals=nrm, device=device)
    return ft.LSSolver(ft.Grid(*shape), mat, ft.SolverOptions(
        mode="heat", tol=1e-8, dtype=dtype), device=device)


def test_run_batched_heat_laminate_is_the_generic_path(monkeypatch):
    """The route gives the generic path's iterations and mean flux, to the
    bit, in run_batched and run()."""
    got = {}
    for route in (True, False):
        if not route:
            monkeypatch.setattr(laminate.LaminateMixed, "_heat_route",
                                lambda self, F: None)
        calls = _count_routes(monkeypatch)
        s = _heat_laminate((16, 12, 1), "cpu")
        assert not s.run_batched(np.eye(3))
        res = (list(s.residuals), np.asarray(s.calc_mean_stress_batched()))
        s.set_strain([1.0, 0.2, 0.0])
        assert not s.run()
        got[route] = res + (list(s.residuals), s.calc_mean_stress())
        assert bool(calls) == route
        monkeypatch.undo()
    for a, b in zip(got[True], got[False]):
        assert np.array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------- card

def _rel(out, ref):
    return float((out - ref).abs().max()) / float(ref.abs().max())


@pytest.mark.parametrize("shape,B", [((64, 64, 64), 3), ((4096, 4096, 1), 3),
                                     ((33, 17, 29), 2)])
@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_kernel_matches_twin(cuda, shape, B, rule, dtype):
    """Within 1e-6 (float32) or 1e-12 (float64) of the twin's max |tau|;
    one launch for B <= 8; repeatable to the bit."""
    if dtype == torch.float64 and shape == (4096, 4096, 1):
        shape = (1024, 1024, 1)
    phi1, phi2, n, xs = _fields(shape, dtype, B, cuda)
    out = torch.empty((B, 3) + shape, dtype=dtype, device=cuda)
    ref = torch.empty_like(out)
    before = mk.launches["laminate_heat"]
    mk.laminate_heat(phi1, phi2, n, xs, out, MU[0], MU[1], MU0, rule)
    assert mk.launches["laminate_heat"] == before + 1
    mk.laminate_heat_plain(phi1, phi2, n, xs, ref, MU[0], MU[1], MU0, rule)
    again = torch.empty_like(out)
    mk.laminate_heat(phi1, phi2, n, xs, again, MU[0], MU[1], MU0, rule)
    torch.cuda.synchronize()
    tol = 1e-6 if dtype == torch.float32 else 1e-12
    assert _rel(out, ref) <= tol
    assert torch.equal(again, out)


def test_cuda_kernel_takes_nine_cases_in_two_launches(cuda):
    """B = 9 in chunks of 8 and 1, into the rows of a batch and a list."""
    phi1, phi2, n, xs = _fields((32, 16, 8), torch.float32, 9, cuda)
    out = torch.empty((9, 3, 32, 16, 8), device=cuda)
    ref = torch.empty_like(out)
    before = mk.launches["laminate_heat"]
    mk.laminate_heat(phi1, phi2, n, xs, out, MU[0], MU[1], MU0, "laminate")
    assert mk.launches["laminate_heat"] == before + 2
    rows = [torch.empty_like(x) for x in xs]
    mk.laminate_heat(phi1, phi2, n, xs, rows, MU[0], MU[1], MU0, "laminate")
    mk.laminate_heat_plain(phi1, phi2, n, xs, ref, MU[0], MU[1], MU0,
                           "laminate")
    torch.cuda.synchronize()
    assert _rel(out, ref) <= 1e-6
    assert torch.equal(torch.stack(rows), out)


def test_cuda_kernel_refuses_what_it_does_not_take(cuda):
    phi1, phi2, n, xs = _fields((8, 8, 8), torch.float32, 1, cuda)
    out = torch.empty((1, 3, 8, 8, 8), device=cuda)
    go = lambda *a, rule="laminate": mk.laminate_heat(
        *a, MU[0], MU[1], MU0, rule)
    with pytest.raises(ValueError, match="contiguous"):
        go(phi1, phi2, n, [xs[0].transpose(1, 2)], out)
    with pytest.raises(ValueError, match="shape"):
        go(phi1[:4], phi2, n, xs, out)
    with pytest.raises(TypeError, match="float32/float64"):
        go(phi1.half(), phi2.half(), n.half(), [xs[0].half()], out.half())
    with pytest.raises(TypeError, match="dtype"):
        go(phi1, phi2.double(), n, xs, out)
    with pytest.raises(ValueError, match="rules"):
        go(phi1, phi2, n, xs, out, rule="fluidity")
    with pytest.raises(ValueError, match=r"\(3, nx, ny, nz\)"):
        go(phi1, phi2, n, [torch.cat([xs[0], xs[0]])], out)


def test_cuda_slab_views_launch_once_a_slab(cuda):
    """On four x-slabs of the card each slab's view launches the kernel
    once on its slab, to the bit the whole field's stress difference (a
    per-voxel map)."""
    phi1, phi2, n, xs = _fields((32, 16, 8), torch.float32, 1, cuda)
    mat = _material("laminate", phi1, phi2, n)
    whole = mat.stress_diff(xs[0], MU0, 0.0)
    F = shard_field(xs[0], make_mesh(["cuda:0"] * 4))
    before = mk.launches["laminate_heat"]
    got = for_slabs(mat).stress_diff(F, MU0, 0.0)
    torch.cuda.synchronize()
    assert mk.launches["laminate_heat"] == before + 4
    assert torch.equal(torch.cat(got, 1), whole)


def test_cuda_run_batched_heat_laminate_matches_cpu(cuda):
    """64 x 64 x 1: the kernel's iterations and mean flux against the
    twin's on the CPU; one launch a batched application."""
    got = {}
    for dev in ("cpu", "cuda"):
        s = _heat_laminate((64, 64, 1), dev)
        before = mk.launches["laminate_heat"]
        assert not s.run_batched(np.eye(3))
        got[dev] = (len(s.residuals),
                    np.asarray(s.calc_mean_stress_batched()))
        launched = mk.launches["laminate_heat"] - before
        # the init, each step and the three cases' mean flux
        assert launched == (len(s.residuals) + 1 + 3 if dev == "cuda"
                            else 0)
    assert got["cuda"][0] == got["cpu"][0]
    ref = got["cpu"][1]
    assert np.max(np.abs(got["cuda"][1] - ref)) <= 1e-10 * np.max(np.abs(ref))
