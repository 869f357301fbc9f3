"""The CG's vector update (``ops/vector_kernels.py``).

On the CPU: the wrapper takes the plain twin, which gives the sequence the
solver ran before the kernel (alpha, two ``addcmul_``, ``inner_l2`` plus
tiny) bitwise, whole and on x-slabs, and counts no launch.  On the card
(skipped without one): the kernel against its twin, repeatable to the
bit, w left as it was, the wrapper's checks, and whole solves against the
CPU.  The module imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_cg_update.py -q
"""
import math

import numpy as np
import pytest
import torch

import fibergen_tpu_torch as ft
from fibergen_tpu_torch.core import fields
from fibergen_tpu_torch.ops import vector_kernels
from fibergen_tpu_torch.parallel import slabs

torch.set_num_threads(2)

SHAPES = [(16, 16, 16), (32, 32, 32), (17, 9, 5)]
TINY = {torch.float32: float(np.finfo(np.float32).tiny),
        torch.float64: float(np.finfo(np.float64).tiny)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _state(C, shape, dtype, device="cpu", seed=3):
    """eps, r, p, w and the 0-d gamma and denom of one step."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    eps, r, p, w = (t(rng.standard_normal((C,) + shape)) for _ in range(4))
    return eps, r, p, w, t(0.83 + rng.random()), t(1.7 + rng.random())


def _before(eps, r, p, w, gamma, denom, tiny):
    """The solver's update as it ran before the kernel (any layout)."""
    alpha = slabs.smap(lambda g, d: g / (d + tiny), gamma, denom)
    slabs.smap(torch.Tensor.addcmul_, eps, p, alpha)
    slabs.smap(lambda r, w, p, a: r.addcmul_(w.sub_(p), a), r, w, p, alpha)
    return slabs.smap(lambda d: d + tiny, fields.inner_l2(r, r))


def _copies(state):
    return [x.clone() for x in state]


def _split(x, d):
    """A field's x-slabs, or a 0-d value on every slab."""
    if x.dim() == 0:
        return [x.clone() for _ in range(d)]
    return [s.contiguous() for s in x.chunk(d, dim=1)]


# ----------------------------------------------------------------- CPU

@pytest.mark.parametrize("C", [3, 6])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(5, 4, 3), (17, 9, 5)])
def test_twin_is_the_old_update_bitwise(C, dtype, shape):
    state = _state(C, shape, dtype)
    old, new = _copies(state), _copies(state)
    w0 = new[3].clone()
    before = dict(vector_kernels.launches)
    d_old = _before(*old, TINY[dtype])
    d_new = vector_kernels.cg_update(*new, TINY[dtype])
    assert vector_kernels.launches == before
    assert d_new.shape == () and d_new.dtype == dtype
    assert torch.equal(d_new, d_old)
    assert torch.equal(new[0], old[0]) and torch.equal(new[1], old[1])
    assert torch.equal(new[3], w0)                  # w is read, not used up


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_twin_on_slabs_is_the_old_update_bitwise(dtype):
    """Four x-slabs: the slabs' means added in slab order, then tiny, as
    ``fields.inner_l2`` takes it on slabs."""
    state = _state(6, (8, 6, 5), dtype)
    old = [_split(x, 4) for x in state]
    new = [_split(x, 4) for x in state]
    d_old = _before(*old, TINY[dtype])
    d_new = vector_kernels.cg_update_slabs(*new, TINY[dtype])
    assert len(d_new) == 4
    for a, b in zip(d_new, d_old):
        assert torch.equal(a, b)
    for i in (0, 1):
        assert all(torch.equal(a, b) for a, b in zip(new[i], old[i]))


def test_every_linear_step_goes_through_the_wrapper(monkeypatch):
    """A staggered elasticity run() at 8^3 calls the wrapper once a step,
    run_batched once a case and step."""
    calls = []
    orig = vector_kernels.cg_update
    monkeypatch.setattr(vector_kernels, "cg_update",
                        lambda *a: calls.append(1) or orig(*a))
    phi = np.zeros((8, 8, 8))
    phi[2:6, 2:6, 2:6] = 1.0
    mat = ft.convert.material_from_numpy(
        [("fiber", 10.0, 5.0, phi), ("matrix", 1.0, 1.0, 1.0 - phi)],
        device="cpu")
    s = ft.LSSolver(ft.Grid(8, 8, 8), mat, ft.SolverOptions(
        tol=1e-6, error_estimator="residual", check_every=4), device="cpu")
    s.set_strain([1.0, 0, 0, 0, 0, 0])
    assert not s.run()
    steps = 4 * math.ceil(len(s.residuals) / 4)
    assert len(calls) == steps
    calls.clear()
    assert not s.run_batched(np.eye(6)[:2])
    assert len(calls) == 2 * 4 * math.ceil(len(s.residuals) / 4)


# ---------------------------------------------------------------- card

def _ulps(out, ref):
    """The largest distance of ``out`` from ``ref`` in units of the last
    place of ``ref``."""
    spacing = torch.nextafter(ref.abs(), torch.full_like(ref, math.inf)) \
        - ref.abs()
    return float(((out - ref).abs() / spacing).max())


def _close(out, ref):
    """eps or r: within 4 ulps in float32, 1e-14 of the largest value in
    float64."""
    if out.dtype == torch.float32:
        return _ulps(out, ref) <= 4
    return float((out - ref).abs().max()) <= 1e-14 * float(ref.abs().max())


def _delta_close(out, ref64):
    rel = 1e-6 if out.dtype == torch.float32 else 1e-13
    return abs(float(out) - float(ref64)) <= rel * abs(float(ref64))


def _against_twin(state):
    """The kernel and the twin on copies of ``state``, and the twin in
    float64: (the kernel's fields, its delta), the twin's fields, the
    float64 twin's delta."""
    dtype = state[0].dtype
    tiny, tiny64 = TINY[dtype], TINY[torch.float64]
    k, t = _copies(state), _copies(state)
    d_k = vector_kernels.cg_update(*k, tiny)
    vector_kernels.cg_update_plain(*t, tiny, tiny)
    d_64 = vector_kernels.cg_update_plain(
        *(x.to(torch.float64, copy=True) for x in state), tiny64, tiny64)
    torch.cuda.synchronize()
    return (k, d_k), t, d_64


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("C", [3, 6])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_cg_update_matches_twin(cuda, shape, C, dtype):
    """eps and r within 4 ulps (float32) or 1e-14 (float64) of the twin;
    delta within 1e-6 (float32) or 1e-13 (float64) of the twin in float64;
    two calls give the same bits; w untouched; one launch a call."""
    state = _state(C, shape, dtype, cuda)
    w0 = state[3].clone()
    before = vector_kernels.launches["cg_update"]
    (k, d_k), t, d_64 = _against_twin(state)
    assert vector_kernels.launches["cg_update"] == before + 1
    assert d_k.shape == () and d_k.dtype == dtype and d_k.is_cuda
    assert _close(k[0], t[0]) and _close(k[1], t[1])
    assert torch.equal(k[3], w0) and torch.equal(k[2], state[2])
    assert _delta_close(d_k, d_64)
    again = vector_kernels.cg_update(*_copies(state), TINY[dtype])
    assert torch.equal(again, d_k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_cg_update_on_a_row_of_a_batch(cuda, dtype):
    """Row b of a (B, 6, ...) batch, as run_batched passes its cases: the
    other rows untouched."""
    B, shape = 3, (16, 16, 16)
    batch = [torch.stack([_state(6, shape, dtype, cuda, seed=b)[i]
                          for b in range(B)]) for i in range(4)]
    gamma, denom = _state(6, shape, dtype, cuda, seed=1)[4:]
    full = [x.clone() for x in batch]
    row = [x[1] for x in full]
    assert all(x.is_contiguous() for x in row)
    d_k = vector_kernels.cg_update(*row, gamma, denom, TINY[dtype])
    ref = [x[1].clone() for x in batch]
    vector_kernels.cg_update_plain(*ref, gamma, denom, TINY[dtype],
                                   TINY[dtype])
    t64 = [x[1].to(torch.float64, copy=True) for x in batch]
    tiny64 = TINY[torch.float64]
    d_64 = vector_kernels.cg_update_plain(*t64, gamma.double(),
                                          denom.double(), tiny64, tiny64)
    torch.cuda.synchronize()
    assert _close(row[0], ref[0]) and _close(row[1], ref[1])
    for i in (0, 1):
        for b in (0, 2):
            assert torch.equal(full[i][b], batch[i][b])
    assert _delta_close(d_k, d_64)


def test_cuda_cg_update_on_slabs(cuda):
    """Four x-slabs of one card: one launch a slab, delta the slabs' mean
    within 1e-13 of the twin's in float64."""
    state = _state(6, (16, 12, 10), torch.float64, cuda)
    k = [_split(x, 4) for x in state]
    t = [_split(x, 4) for x in state]
    before = vector_kernels.launches["cg_update"]
    d_k = vector_kernels.cg_update_slabs(*k, TINY[torch.float64])
    d_t = _before(*t, TINY[torch.float64])
    assert vector_kernels.launches["cg_update"] == before + 4
    assert len(d_k) == 4
    for a, b in zip(d_k, d_t):
        assert abs(float(a) - float(b)) <= 1e-13 * abs(float(b))


def test_cuda_cg_update_refuses_what_it_does_not_take(cuda):
    eps, r, p, w, g, d = _state(6, (8, 8, 8), torch.float32, cuda)
    tiny = TINY[torch.float32]
    with pytest.raises(ValueError, match="contiguous"):
        vector_kernels.cg_update(eps.transpose(1, 2), r, p, w, g, d, tiny)
    with pytest.raises(ValueError, match="shape"):
        vector_kernels.cg_update(eps, r[:, :4], p, w, g, d, tiny)
    with pytest.raises(ValueError, match="shape"):
        vector_kernels.cg_update(eps, r, p, w, g.reshape(1), d, tiny)
    with pytest.raises(TypeError, match="float32/float64"):
        vector_kernels.cg_update(*(x.half() for x in (eps, r, p, w, g, d)),
                                 tiny)
    with pytest.raises(TypeError, match="dtype"):
        vector_kernels.cg_update(eps, r, p, w.double(), g, d, tiny)
    with pytest.raises(ValueError, match="3 or 6"):
        vector_kernels.cg_update(eps[:5], r[:5], p[:5], w[:5], g, d, tiny)


def _sphere_solver(dev, n=32):
    a = ((np.arange(n) + 0.5) / n - 0.5) ** 2
    phi = ((a[:, None, None] + a[None, :, None] + a[None, None, :])
           < 0.09).astype(np.float64)
    mat = ft.convert.material_from_numpy(
        [("fiber", 10.0, 5.0, phi), ("matrix", 1.0, 1.0, 1.0 - phi)],
        device=dev)
    return ft.LSSolver(ft.Grid(n, n, n), mat, ft.SolverOptions(
        tol=1e-6, error_estimator="residual", check_every=8,
        dtype="float64"), device=dev)


def test_cuda_solves_give_the_twins_stiffness(cuda):
    """A 32^3 staggered elasticity run() per unit strain and a B = 6
    run_batched on the card (the kernel) against the CPU (the twin): the
    effective stiffness within 1e-6; one launch a case step."""
    C = {}
    for dev in ("cpu", "cuda"):
        s = _sphere_solver(dev)
        cols = []
        before = vector_kernels.launches["cg_update"]
        steps = 0
        for e in np.eye(6):
            s.set_strain(list(e))
            assert not s.run()
            steps += 8 * math.ceil(len(s.residuals) / 8)
            cols.append(s.calc_mean_stress())
        launched = vector_kernels.launches["cg_update"] - before
        assert launched == (steps if dev == "cuda" else 0)
        before = vector_kernels.launches["cg_update"]
        assert not s.run_batched(np.eye(6))
        launched = vector_kernels.launches["cg_update"] - before
        steps = 8 * math.ceil(len(s.residuals) / 8)
        assert launched == (6 * steps if dev == "cuda" else 0)
        C[dev] = (np.stack(cols, axis=1),
                  np.asarray(s.calc_mean_stress_batched()))
    for got, ref in zip(C["cuda"], C["cpu"]):
        assert np.max(np.abs(got - ref)) <= 1e-6 * np.max(np.abs(ref))
