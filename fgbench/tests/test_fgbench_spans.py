"""The readers of the port's spans (``harness/spans.py``,
``host_syncs_per_case``, ``cg_step_useful_share``,
``solver_idle_ms_per_case``): on a made-up profile, and in a CPU run of
each cell at 16^3."""
import math
import types

import pytest

from _cpu import run_cpu
from fgbench.harness import manifest, spans
from fgbench.harness import trace as tr
from test_fgbench_trace import Ev

US = 1_000


def _profile():
    """A window of 1 ms: the device busy over [0, 210], [360, 700], [710,
    715] and [850, 1000] us, one request's spans around it."""
    host = [(tr.WINDOW, 0, 1000), (f"{tr.REQUEST} run (0,)", 10, 990),
            ("fg.sync.upload", -60, -50),        # before the window
            ("fg.run", 100, 800),
            ("fg.sync.upload", 120, 130),
            ("fg.cg.step", 150, 190),
            ("fg.sync.residuals", 200, 300),
            ("fg.cg.test", 300, 350),
            ("fg.cg.step", 350, 700),
            ("fg.mean_stress", 805, 830),
            ("fg.sync.mean_stress", 810, 830),
            ("aten::copy_", 815, 825)]
    dev = [("void z_fwd_reg<float>(float const*)", 0, 210),
           ("void stress_div_beta_kernel<float, true, false>(float*)",
            360, 700),
           ("void at::vectorized_elementwise_kernel<4>(int)", 710, 715),
           ("Memcpy DtoH (Device -> Pageable)", 850, 1000)]
    return tr.Trace([Ev(n, a * US, b * US, False) for n, a, b in host]
                    + [Ev(n, a * US, b * US, True) for n, a, b in dev])


def _run(trace, iterations=(2,), cases=1):
    reqs = [types.SimpleNamespace(iterations=i, cases=(0,) * cases)
            for i in iterations]
    return types.SimpleNamespace(trace=trace, requests=reqs,
                                 cases_done=cases * len(reqs))


def _read(name, run):
    return manifest.plugin("metrics", name).read(run)


def test_idle_is_split_by_the_innermost_span():
    t = _profile()
    got = {n: v / US for n, v in spans.idle_under_spans(t).items()}
    # the gap [210, 360] across three spans; [700, 710] under 20 us is
    # left out; of [715, 850] the part in fg.run and in fg.mean_stress,
    # not the part after fg.run ended outside any entry span
    assert got == pytest.approx({"fg.sync.residuals": 90, "fg.cg.test": 50,
                                 "fg.cg.step": 10, "fg.run": 85,
                                 "fg.mean_stress": 5,
                                 "fg.sync.mean_stress": 20})
    assert _read("solver_idle_ms_per_case", _run(t)) == pytest.approx(0.26)
    assert _read("solver_idle_ms_per_case", _run(t, cases=2)) == \
        pytest.approx(0.13)


def test_spans_outside_an_entry_are_not_the_solvers_idle():
    t = tr.Trace([Ev(tr.WINDOW, 0, 1000 * US, False),
                  Ev("fg.sync.upload", 100 * US, 900 * US, False),
                  Ev("void k(float*)", 0, 50 * US, True)])
    assert spans.idle_under_spans(t) == {}
    assert _read("solver_idle_ms_per_case", _run(t)) is None


def test_counts_of_syncs_and_steps():
    t = _profile()
    # the three sync spans that begin in the window
    assert _read("host_syncs_per_case", _run(t)) == 3
    # one step of the two read by the test (2 iterations: entries 0, 1)
    assert _read("cg_step_useful_share", _run(t)) == pytest.approx(50.0)


def test_a_program_without_spans_reads_nothing():
    t = tr.Trace([Ev(tr.WINDOW, 0, 1000 * US, False),
                  Ev("aten::item", 100 * US, 200 * US, False),
                  Ev("void k(float*)", 0, 50 * US, True)])
    for name in ("host_syncs_per_case", "cg_step_useful_share",
                 "solver_idle_ms_per_case"):
        assert _read(name, _run(t)) is None
        assert _read(name, _run(None)) is None


@pytest.mark.parametrize("workload", ["elastic-cases", "elastic-tensor"])
def test_a_cpu_run_reports_the_span_counts(workload):
    """The counts of tests/test_torch_trace.py per request: the uploads
    (the seed, E, the zero vector and each case's <r, r> weights at the
    init and every step), the first gamma, a residual read a chunk, the
    closing synchronize and the mean stress; no device, so no idle."""
    rc, res, _, _ = run_cpu(workload, trace=True)
    m = {k: v["value"] for k, v in res["metrics"].items()}
    it = m["cg_iterations_per_case"]
    assert it == int(it)
    chunks = math.ceil(it / 8)
    steps = 8 * chunks
    if workload == "elastic-cases":
        per_case = 3 + 1 + steps + 1 + chunks + 1 + 1
    else:
        per_case = (6 + 1 + 6 + 6 * steps + 1 + chunks + 1 + 1) / 6
    assert m["host_syncs_per_case"] == pytest.approx(per_case)
    assert m["cg_step_useful_share"] == pytest.approx(100 * (it - 1) / steps)
    assert "solver_idle_ms_per_case" not in m
