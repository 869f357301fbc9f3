"""The port's spans (``utils.logging.span``) on the CPU at 16^3: nothing is
constructed without a profiler; under one, each span of the solver's table
(``solvers/ls.py``) is a host-scope event on the profiler's clock, nested
inside its caller's span, and the step and sync spans count the call
sites the solve passes through."""
import collections
import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import fibergen_tpu_torch as ft
from fibergen_tpu_torch import parallel
from fibergen_tpu_torch.utils import logging as fglog

N = 16
TABLE = ("fg.run", "fg.run_batched", "fg.mean_stress", "fg.cg.init",
         "fg.cg.step", "fg.cg.update.plain", "fg.cg.test",
         "fg.sync.residuals", "fg.sync.gamma0",
         "fg.sync.metric0", "fg.sync.upload", "fg.sync.end",
         "fg.sync.mean_stress", "fg.sync.bc_error")
EYE = np.eye(6)


@pytest.fixture(autouse=True)
def _quiet():
    old = fglog.LOG.enabled
    fglog.LOG.enabled = False
    yield
    fglog.LOG.enabled = old


def _solver(sharding=None, **opt):
    """The benchmark's sphere (radius 0.3, mu/lam 10/5 in 1/1) at 16^3,
    staggered elasticity CG, residual estimator, tol 1e-6, check_every 8;
    on the x-slabs of ``sharding`` when given."""
    x = (np.arange(N) + 0.5) / N
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    phi = torch.as_tensor(((X - .5) ** 2 + (Y - .5) ** 2 + (Z - .5) ** 2
                           < 0.09).astype(np.float64))
    mat = ft.VoigtMixed([
        ft.Phase("fiber", ft.LinearIsotropic(mu=10.0, lam=5.0), phi),
        ft.Phase("matrix", ft.LinearIsotropic(mu=1.0, lam=1.0), 1 - phi)],
        dim=6)
    kw = dict(mode="elasticity", method="cg", gamma_scheme="staggered",
              error_estimator="residual", tol=1e-6, check_every=8,
              dtype="float64")
    kw.update(opt)
    return ft.LSSolver(ft.Grid(N, N, N), mat, ft.SolverOptions(**kw),
                       device="cpu", sharding=sharding)


def _run(s, strain=(1, 0, 0, 0, 0, 0)):
    s.set_strain(list(strain))
    s.run()
    s.calc_mean_stress()


def _batch(s):
    s.run_batched(EYE)
    s.calc_mean_stress_batched()


def _mixed(s):
    s.set_bc_projector(np.diag([1.0, 0, 0, 0, 0, 0]))     # uniaxial stress
    _run(s, (0.01, 0, 0, 0, 0, 0))


def _traced(fn):
    """The program's events (name, start, end, the event) of ``fn()``
    under a CPU profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e)
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith("fg.")]


def _names(events):
    return collections.Counter(n for n, *_ in events)


def test_no_span_is_constructed_without_a_profiler(monkeypatch):
    made = []

    class Counted:
        def __init__(self, name):
            made.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(fglog, "_RecordFunctionFast", Counted)
    s = _solver()
    _run(s)
    _batch(s)
    with fglog.timer("idle"):
        pass
    assert made == []
    with profile(activities=[ProfilerActivity.CPU]):   # the patch is live
        _run(s)
    assert "fg.run" in made and "fg.cg.step" in made


def test_every_span_of_the_table_appears():
    names = set()
    s = _solver()
    names |= set(_names(_traced(lambda: (_run(s), _batch(s)))))
    names |= set(_names(_traced(
        lambda: _run(_solver(error_estimator="epsilon")))))
    names |= set(_names(_traced(lambda: _mixed(_solver()))))
    assert set(TABLE) <= names, set(TABLE) - names


def test_spans_are_host_scope_events():
    s = _solver()
    events = _traced(lambda: (_run(s), _batch(s)))
    assert events
    for name, _, _, e in events:
        assert str(e.device_type()).endswith("CPU"), name
        assert e.scope() == 0, name                 # RecordScope.FUNCTION
        assert not e.is_user_annotation(), name


def test_spans_nest_inside_the_callers_span():
    s = _solver()

    def call():
        with torch.profiler.record_function("caller"):
            _run(s)
            _batch(s)

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call()
    ev = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
          for e in prof.profiler.kineto_results.events()
          if e.name() == "caller" or e.name().startswith("fg.")]
    (c0, c1), = [(a, b) for n, a, b in ev if n == "caller"]
    ours = [(n, a, b) for n, a, b in ev if n.startswith("fg.")]
    assert all(c0 <= a <= b <= c1 for _, a, b in ours)
    entries = [(a, b) for n, a, b in ours
               if n in ("fg.run", "fg.run_batched", "fg.mean_stress")]
    assert len(entries) == 4
    for n, a, b in ours:           # every other span inside an entry's
        if (a, b) not in entries:
            assert any(e0 <= a <= b <= e1 for e0, e1 in entries), n
    runs = [(a, b) for n, a, b in ours if n in ("fg.run", "fg.run_batched")]
    for n, a, b in ours:
        if n.startswith("fg.cg."):
            assert any(r0 <= a <= b <= r1 for r0, r1 in runs), n


def _chunks(s):
    return math.ceil(len(s.residuals) / s.opt.check_every)


@pytest.mark.parametrize("case", ["run", "run K=1", "batched chain",
                                  "per-case loop (willot)"])
def test_step_spans_are_whole_chunks(case):
    opt = {"run K=1": dict(check_every=1),
           "per-case loop (willot)": dict(gamma_scheme="willot")}.get(case,
                                                                      {})
    s = _solver(**opt)
    fn = _run if case.startswith("run") else _batch
    steps = _names(_traced(lambda: fn(s)))["fg.cg.step"]
    if fn is _batch:
        assert s._batched_chain() == (case == "batched chain")
    assert steps == s.opt.check_every * _chunks(s) > 0


@pytest.mark.parametrize("case", ["run", "batched chain",
                                  "per-case loop (willot)", "sharded run"])
def test_update_spans_one_a_case_step(case):
    """On the CPU each case's vector update takes the plain twin, inside
    its step's span: one ``fg.cg.update.plain`` a case and step (a slab
    and step when sharded), no ``fg.cg.update.kernel``."""
    opt = {"per-case loop (willot)": dict(gamma_scheme="willot"),
           "sharded run": dict(sharding=parallel.field_sharding(
               parallel.make_mesh(["cpu"] * 2)))}.get(case, {})
    s = _solver(**opt)
    fn = _run if case in ("run", "sharded run") else _batch
    events = _traced(lambda: fn(s))
    names = _names(events)
    per_step = {"run": 1, "sharded run": 2}.get(case, 6)
    assert names["fg.cg.update.plain"] == per_step * names["fg.cg.step"] > 0
    assert names["fg.cg.update.kernel"] == 0
    steps = [(a, b) for n, a, b, _ in events if n == "fg.cg.step"]
    for n, a, b, _ in events:
        if n == "fg.cg.update.plain":
            assert any(s0 <= a <= b <= s1 for s0, s1 in steps)


def _expected(case, s, steps, chunks):
    """fg.sync.<why> counts of one request, by the call sites it passes
    (a solver's second request: its reference medium is memoized)."""
    up_run = 3          # the seed, E and the zero vector (_vector)
    if case == "run":
        return {"upload": up_run + 1 + steps,  # <r, r>'s weights: init, steps
                "gamma0": 1, "residuals": chunks, "end": 1,
                "mean_stress": 1}
    if case == "run, epsilon estimator":
        return {"upload": up_run + 1 + steps, "gamma0": 1, "metric0": 1,
                "residuals": 2 * chunks, "end": 1, "mean_stress": 1}
    if case == "run, lm6":          # the tuple state forms no weights
        return {"upload": up_run, "gamma0": 1, "residuals": chunks,
                "end": 1, "mean_stress": 1}
    if case == "run, uniaxial stress":     # each converged test reads twice
        below = sum(r <= s.opt.tol for r in s.residuals)
        return {"upload": up_run + 1 + steps, "gamma0": 1,
                "residuals": chunks, "end": 1, "mean_stress": 1,
                "bc_error": 2 * below}
    up_batch = 6 + 1 + 6   # the six E, the zero vector, the inits' <r, r>
    if case == "batched chain":
        return {"upload": up_batch + 6 * steps, "gamma0": 1,
                "residuals": chunks, "end": 1, "mean_stress": 1}
    # the per-case loop: <p, p - w> and <r, r> of each case each step
    return {"upload": up_batch + 12 * steps, "gamma0": 1,
            "residuals": chunks, "end": 1, "mean_stress": 1}


@pytest.mark.parametrize("case", ["run", "run, epsilon estimator",
                                  "run, lm6", "run, uniaxial stress",
                                  "batched chain", "per-case loop (willot)"])
def test_sync_spans_count_the_call_sites(case):
    opt = {"run, epsilon estimator": dict(error_estimator="epsilon"),
           "run, lm6": dict(low_mem="on"),
           "per-case loop (willot)": dict(gamma_scheme="willot")}.get(case,
                                                                      {})
    s = _solver(**opt)
    fn = {"run, uniaxial stress": _mixed, "batched chain": _batch,
          "per-case loop (willot)": _batch}.get(case, _run)
    first = _names(_traced(lambda: fn(s)))
    assert first["fg.sync.ref_material"] == 1    # the bounds, read once
    names = _names(_traced(lambda: fn(s)))
    if case == "run, lm6":
        assert s._route == "lm6"
    got = {n[len("fg.sync."):]: c for n, c in names.items()
           if n.startswith("fg.sync.")}
    assert got == _expected(case, s, names["fg.cg.step"], _chunks(s))


def test_timer_opens_a_span():
    def timed():
        with fglog.timer("phase initialization"):
            torch.ones(3).sum()

    fglog.TIMINGS.reset()
    names = _names(_traced(timed))
    assert names["fg.phase initialization"] == 1
    assert fglog.TIMINGS.stats["phase initialization"][0] == 1
    fglog.TIMINGS.reset()
