"""The spans around the material's stress difference and the plain heat
stencils (``fg.material.stress_diff``, ``fg.stencil.heat.div`` and
``fg.stencil.heat.grad``) on the CPU, and the benchmark's readers of the
device time under them (``fgbench/harness/launches.py``,
``material_ms_per_step``, ``heat_stencil_ms_per_step``) on made-up
profiles."""
import collections
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import fibergen_tpu_torch as ft
from fgbench.harness import launches, manifest
from fgbench.harness import trace as tr
from fibergen_tpu_torch.utils import logging as fglog

NEW = ("fg.material.stress_diff", "fg.stencil.heat.div",
       "fg.stencil.heat.grad")


@pytest.fixture(autouse=True)
def _quiet():
    old = fglog.LOG.enabled
    fglog.LOG.enabled = False
    yield
    fglog.LOG.enabled = old


def _counts(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return collections.Counter(e.name() for e in
                               prof.profiler.kineto_results.events()
                               if e.name().startswith("fg."))


def _laminate_heat(shape=(16, 12, 1)):
    x = (np.arange(shape[0]) + 0.5) / shape[0]
    phi = np.broadcast_to(np.clip((x - 0.3) * shape[0], 0, 1)[:, None, None],
                          shape).copy()
    n = np.zeros((3,) + shape)
    n[0] = 1.0
    mat = ft.LaminateMixed([
        ft.Phase("matrix", ft.ScalarLinearIsotropic(mu=1.0, dim=3),
                 torch.as_tensor(1 - phi)),
        ft.Phase("fiber", ft.ScalarLinearIsotropic(mu=10.0, dim=3),
                 torch.as_tensor(phi))], dim=3, normals=torch.as_tensor(n))
    return ft.LSSolver(ft.Grid(*shape), mat, ft.SolverOptions(
        mode="heat", tol=1e-8, dtype="float64"), device="cpu")


@pytest.mark.parametrize("entry", ["run_batched", "run"])
def test_laminate_heat_opens_one_span_a_case_and_application(entry):
    """One divergence and one gradient a case and operator application (the
    CG's init and each of its steps); one stress difference, with the
    laminate's plain twin inside, a case of run() and a batch of
    run_batched."""
    s = _laminate_heat()
    if entry == "run":
        s.set_strain([1.0, 0.3, 0.0])
        got = _counts(s.run)
        cases = 1
    else:
        got = _counts(lambda: s.run_batched(np.eye(3)))
        cases = 3
    steps = len(s.residuals)
    assert steps > 1 and got["fg.cg.step"] == steps
    for name in NEW[1:]:
        assert got[name] == cases * (steps + 1), (name, got)
    for name in (NEW[0], "fg.material.laminate.plain"):
        assert got[name] == steps + 1, (name, got)
    assert got["fg.material.laminate.kernel"] == 0


def test_nothing_is_opened_without_a_profiler(monkeypatch):
    made = []
    real = fglog._RecordFunctionFast
    monkeypatch.setattr(fglog, "_RecordFunctionFast",
                        lambda name: made.append(name) or real(name))
    s = _laminate_heat()
    s.run_batched(np.eye(3))
    assert made == []


def test_elastic_k1_route_opens_none():
    n = 12
    x = (np.arange(n) + 0.5) / n
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    phi = torch.as_tensor(((X - .5) ** 2 + (Y - .5) ** 2 + (Z - .5) ** 2
                           < 0.09).astype(np.float64))
    mat = ft.VoigtMixed([
        ft.Phase("fiber", ft.LinearIsotropic(mu=10.0, lam=5.0), phi),
        ft.Phase("matrix", ft.LinearIsotropic(mu=1.0, lam=1.0), 1 - phi)],
        dim=6)
    s = ft.LSSolver(ft.Grid(n, n, n), mat, ft.SolverOptions(
        tol=1e-6, error_estimator="residual", check_every=8,
        dtype="float64"), device="cpu")
    assert s._k1_route

    def both():
        s.run_batched(np.eye(6))
        s.set_strain([1.0, 0, 0, 0, 0, 0])
        s.run()
    got = _counts(both)
    assert got["fg.cg.step"] > 0
    assert not any(got[name] for name in NEW)


# ------------------------------------------------- the readers, made up
US = 1_000
LAUNCH = "cudaLaunchKernel"
HOST = [(tr.WINDOW, 0, 1000), ("fg.run_batched", 10, 900),
        ("fg.material.stress_diff", 100, 200), (LAUNCH, 110, 112),
        (LAUNCH, 150, 152),
        ("fg.stencil.heat.div", 200, 260), (LAUNCH, 210, 212),
        (LAUNCH, 300, 302),                 # the chain, in no span
        ("fg.stencil.heat.grad", 400, 450), (LAUNCH, 420, 422),
        ("fg.material.stress_diff", 500, 600), (LAUNCH, 590, 592)]
# the kernels in launch order, each later than its launch
DEVICE = [("k_where", 120, 180), ("k_mul", 180, 190), ("k_roll", 215, 240),
          ("z_fwd", 305, 395), ("k_add", 425, 445), ("k_div", 600, 610)]


class Ev:
    def __init__(self, name, t0, t1, dev):
        self._n, self._t0, self._t1, self._dev = name, t0, t1, dev

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType.CUDA" if self._dev else "DeviceType.CPU"

    def start_ns(self):
        return self._t0

    def duration_ns(self):
        return self._t1 - self._t0


def _run(host, device, steps=2):
    t = tr.Trace([Ev(n, a * US, b * US, False) for n, a, b in host]
                 + [Ev(n, a * US, b * US, True) for n, a, b in device])
    return types.SimpleNamespace(trace=t, calls={("g0_heat", 1): steps})


def _read(metric, run):
    return manifest.plugin("metrics", metric).read(run)


def test_readers_charge_each_kernel_to_the_span_of_its_launch():
    run = _run(HOST, DEVICE)
    # stress differences: 60 + 10 + 10 us of kernels, over two steps
    assert _read("material_ms_per_step", run) == pytest.approx(0.04)
    # stencils: 25 + 20 us
    assert _read("heat_stencil_ms_per_step", run) == pytest.approx(0.0225)
    assert launches.kernel_seconds_under(run.trace, "fg.") == \
        pytest.approx(215e-6)


@pytest.mark.parametrize("case", ["a launch the trace lacks",
                                  "a kernel the trace lacks",
                                  "no span of the layer", "no trace",
                                  "no device operation"])
def test_readers_read_nothing(case):
    host, device = HOST, DEVICE
    if case == "a launch the trace lacks":
        host = [h for h in HOST if h[1:] != (300, 302)]
    elif case == "a kernel the trace lacks":
        device = DEVICE[:-1]
    elif case == "no span of the layer":
        host = [h for h in HOST if not h[0].startswith("fg.material")]
    elif case == "no device operation":
        host = [h for h in HOST if h[0] != LAUNCH]
        device = []
    run = _run(host, device)
    if case == "no trace":
        run.trace = None
    assert _read("material_ms_per_step", run) is None
    if case != "no span of the layer":
        assert _read("heat_stencil_ms_per_step", run) is None
