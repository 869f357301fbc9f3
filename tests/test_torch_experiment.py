"""The port's sweep harness (fibergen_tpu_torch/experiment.py) against the
JAX package's, on the CPU in float64: the same rows, cache keys and cached
data, the same results file and ``.dat`` bytes; and the ``step_mode`` and
``print_detF`` solver options, which a project solves with when stdin is
not a terminal (step_mode pauses for ENTER at each convergence check only
at a terminal).
"""
import io
import json
import os

import numpy as np
import pytest
import torch

import fibergen_tpu as fg
import fibergen_tpu_torch as ft
from fibergen_tpu import experiment as jex
from fibergen_tpu.utils.logging import LOG as JLOG
from fibergen_tpu_torch import experiment as pex
from fibergen_tpu_torch.utils.logging import LOG

torch.set_num_threads(2)

XML = """<settings>
  <solver n="7">
    <materials><matrix mu="1" lambda="1" /><fiber mu="5" lambda="2" /></materials>
    <mode>elasticity</mode><tol>1e-4</tol>
  </solver>
  <actions>
    <select_material name="fiber" />
    <place_fiber R="0.3" />
    <run_load_case e11="0.01" />
  </actions>
</settings>"""


@pytest.fixture(autouse=True)
def _quiet():
    old = (JLOG.enabled, LOG.enabled)
    JLOG.enabled = LOG.enabled = False
    yield
    JLOG.enabled, LOG.enabled = old


def _k(f):
    """A rounded result both packages give to the same digits."""
    return round(float(f.get_mean_stress()[0]), 8)


def _sweep(mod, tmp, tag, **kw):
    proj = tmp / f"{tag}.xml"
    proj.write_text(XML)
    ex = mod.Experiment(str(proj), results_dat=str(tmp / f"{tag}.json"),
                        cache_dir=str(tmp / f"cache_{tag}"), **kw)
    ex.add_info("study", "tol sweep")
    ex.add_param("solver.tol", [1e-3, 1e-5, 1e-7])
    ex.add_param("solver..n", [7], record=False)
    ex.add_result("num_iterations")
    ex.add_result("k", _k)
    return ex


def _no_solve(monkeypatch, module):
    def refuse(self):
        raise AssertionError("a cached run solved")
    monkeypatch.setattr(module.FG, "run", refuse)


def test_sweep_matches_jax(tmp_path, monkeypatch):
    """Three points of a tol sweep: the same rows, the same cache files
    with the same data, the same results file byte for byte, and the same
    .dat bytes; then each package's cache serves the other's sweep without
    a solve."""
    rows_j = _sweep(jex, tmp_path, "jax").run()
    rows_p = _sweep(pex, tmp_path, "port", device="cpu").run()
    assert rows_p == rows_j and len(rows_p) == 3
    assert rows_p[2]["num_iterations"] > rows_p[0]["num_iterations"]
    cj, cp = (sorted(os.listdir(tmp_path / f"cache_{t}"))
              for t in ("jax", "port"))
    assert cp == cj and len(cp) == 3
    for name in cp:
        assert json.loads((tmp_path / "cache_port" / name).read_text()) == \
            json.loads((tmp_path / "cache_jax" / name).read_text())
    assert (tmp_path / "port.json").read_bytes() == \
        (tmp_path / "jax.json").read_bytes()
    jex.write_dat(str(tmp_path / "jax.dat"), rows_j)
    pex.write_dat(str(tmp_path / "port.dat"), rows_p)
    assert (tmp_path / "port.dat").read_bytes() == \
        (tmp_path / "jax.dat").read_bytes()
    # each cache serves the other package's sweep
    _no_solve(monkeypatch, pex)
    ex = _sweep(pex, tmp_path, "port", device="cpu")
    ex.cache_dir = str(tmp_path / "cache_jax")
    assert ex.run() == rows_j
    _no_solve(monkeypatch, jex)
    ex = _sweep(jex, tmp_path, "jax")
    ex.cache_dir = str(tmp_path / "cache_port")
    assert ex.run() == rows_p


def test_float_results_match_jax(tmp_path):
    """The standard getters' values (unrounded) within 1e-10 of the JAX
    package's."""
    out = {}
    for mod, kw in ((jex, {}), (pex, dict(device="cpu"))):
        ex = mod.Experiment(XML, **kw)
        ex.add_param("solver.tol", [1e-6])
        ex.add_results(["mean_stress", "mean_strain", "mean_energy",
                        "residuals", "error"])
        out[mod] = ex.run()[0]
    j, p = out[jex], out[pex]
    assert p["error"] == j["error"] is False
    assert len(p["residuals"]) == len(j["residuals"])
    for key in ("mean_stress", "mean_strain", "residuals"):
        np.testing.assert_allclose(p[key], j[key], rtol=1e-9, atol=1e-15)
    assert abs(p["mean_energy"] - j["mean_energy"]) <= \
        1e-10 * abs(j["mean_energy"])


def test_dry_cache_only_and_run_experiment(tmp_path):
    ex = pex.Experiment(XML, device="cpu")
    ex.add_param("solver.tol", [1e-3, 1e-4])
    rows = ex.run(dry=True)
    assert rows == [{"solver.tol": 1e-3}, {"solver.tol": 1e-4}]
    with pytest.raises(ValueError, match="Unknown result key"):
        ex.add_result("no_such_key")

    def build(ex):
        ex.add_param("solver.tol", [1e-3])
        ex.add_result("num_iterations")

    cache = str(tmp_path / "c")
    rows = pex.run_experiment(build, XML, cache_dir=cache, device="cpu")
    again = pex.run_experiment(build, XML, cache_dir=cache,
                               cache_only=True, device="cpu")
    assert rows == again and rows[0]["num_iterations"] >= 1


def test_helpers_match_jax(tmp_path):
    for key, data, mode in (("mean_stress", [1, 2, 3, 4, 5, 6], "viscosity"),
                            ("mean_strain", [1, 2, 3], "elasticity"),
                            ("mean_stress", np.arange(9.0),
                             "hyperelasticity"),
                            ("mean_energy", 2.5, "elasticity")):
        assert pex.expand_voigt(key, data, mode) == \
            jex.expand_voigt(key, data, mode)
    assert [pex.voigt_index_key("s", i) for i in range(9)] == \
        [jex.voigt_index_key("s", i) for i in range(9)]
    for n, seed in ((1, 0), (12, 1), (30, 4)):
        np.testing.assert_array_equal(pex.iso_sphere_points(n, seed=seed),
                                      jex.iso_sphere_points(n, seed=seed))
    rows = [{"n": 16, "sigma": np.array([1.0, 2.0]), "note": None},
            {"n": 32, "sigma": np.array([3.0, 4.0]), "extra": "x"}]
    pex.write_dat(str(tmp_path / "p.dat"), rows)
    jex.write_dat(str(tmp_path / "j.dat"), rows)
    assert (tmp_path / "p.dat").read_bytes() == \
        (tmp_path / "j.dat").read_bytes()
    lines = (tmp_path / "p.dat").read_text().strip().split("\n")
    assert lines[0].split("\t") == ["n", "sigma_0", "sigma_1", "note",
                                    "extra"]
    assert lines[2].split("\t") == ["32", "3.0", "4.0", "nan", "x"]


class _Terminal(io.StringIO):
    """A stdin that says it is a terminal and counts the lines read."""

    def __init__(self):
        super().__init__("\n" * 1000)
        self.reads = 0

    def isatty(self):
        return True

    def readline(self, *a):
        self.reads += 1
        return super().readline(*a)


STEP_XML = XML.replace("<tol>1e-4</tol>",
                       "<tol>1e-6</tol><step_mode>1</step_mode>"
                       "<print_detF>1</print_detF>")


def test_step_mode_and_print_detf_solve_without_a_terminal(monkeypatch):
    """A project with <step_mode>1 and <print_detF>1 solves when stdin is
    not a terminal, as the same project without them; at a terminal
    step_mode reads one line at each convergence check."""
    monkeypatch.setattr("sys.stdin", io.StringIO(""))
    f = ft.FG(device="cpu")
    f.set_xml(STEP_XML)
    assert f.run() == 0
    assert f.solver.opt.step_mode and f.solver.opt.print_detF
    g = ft.FG(device="cpu")
    g.set_xml(XML.replace("<tol>1e-4</tol>", "<tol>1e-6</tol>"))
    assert g.run() == 0
    assert f.get_residuals() == g.get_residuals()
    assert f.get_mean_stress() == g.get_mean_stress()
    j = fg.FG()
    j.set_xml(STEP_XML)
    assert j.run() == 0
    np.testing.assert_allclose(f.get_mean_stress(), j.get_mean_stress(),
                               rtol=1e-9, atol=1e-15)
    tty = _Terminal()
    monkeypatch.setattr("sys.stdin", tty)
    h = ft.FG(device="cpu")
    h.set_xml(STEP_XML)
    assert h.run() == 0
    assert tty.reads == len(h.get_residuals()) > 0
