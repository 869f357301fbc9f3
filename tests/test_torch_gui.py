"""The port's GUI layer headless on the CPU (the port's plain path): the
cases of tests/test_gui.py on ``fibergen_tpu_torch.gui``, the viewed slice
against the JAX package's GUI on the same project, and the headless run's
imports (no matplotlib)."""
import os
import subprocess
import sys

import matplotlib
matplotlib.use("Agg")

import numpy as np

import fibergen_tpu as fg
import fibergen_tpu_torch as ft
from fibergen_tpu.gui.viewer import SliceViewer as JSliceViewer
from fibergen_tpu.utils.logging import LOG as JLOG
from fibergen_tpu_torch.gui.viewer import SliceViewer, list_demos
from fibergen_tpu_torch.utils.logging import LOG

LOG.enabled = False
JLOG.enabled = False

ROOT = os.path.join(os.path.dirname(__file__), "..")

XML = """
<settings>
  <solver n="8">
    <tol>1e-6</tol>
    <materials>
      <matrix mu="1" lambda="1" />
      <fiber mu="5" lambda="2" />
    </materials>
  </solver>
  <actions>
    <select_material name="fiber" />
    <place_fiber R="0.25" />
    <run_load_case e11="1" />
  </actions>
</settings>
"""


def test_slice_viewer(tmp_path):
    f = ft.FG(device="cpu")
    f.set_xml(XML)
    assert f.run() == 0
    v = SliceViewer.from_fg(f)
    assert "epsilon" in v.fields
    sl = v.current_slice()
    assert sl.shape == (8, 8)
    v.alpha = 0.02
    lo, hi = v.bounds(sl)
    assert lo < hi
    png = tmp_path / "slice.png"
    v.save_png(str(png))
    assert png.stat().st_size > 500
    vtk = tmp_path / "slice.vtk"
    v.save_vtk(str(vtk))
    assert vtk.read_bytes().startswith(b"# vtk")
    v.field = "sigma"
    v.component = 3
    v.slice_dim = "x"
    v.slice_index = 0.0
    assert v.current_slice().shape == (8, 8)


def test_demo_browser():
    cats = list_demos(os.path.join(ROOT, "demo"))
    names = {c["name"] for c in cats}
    assert {"elasticity", "heat", "viscosity", "porous",
            "hyperelasticity"} <= names
    el = next(c for c in cats if c["name"] == "elasticity")
    assert any(p["name"] == "hashin" for p in el["projects"])


def test_gui_main_headless(capsys):
    from fibergen_tpu_torch.gui.app import main
    assert main(["app", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "usage" in out and "--device" in out
    assert "[" in out and "project.xml" in out      # the demo listing


VIEW_XML = """<settings>
  <solver n="8">
    <materials><matrix mu="1" lambda="1" /><fiber mu="5" lambda="2" /></materials>
    <mode>elasticity</mode><tol>1e-4</tol>
  </solver>
  <actions>
    <select_material name="fiber" />
    <place_fiber R="0.3" />
    <run_load_case e11="0.01" />
  </actions>
  <view>
    <field>sigma1</field>
    <slice_dim>y</slice_dim>
    <slice_index>0.25</slice_index>
    <custom_bounds>1</custom_bounds>
    <vmin>-1</vmin>
    <vmax>1</vmax>
    <extra_fields>distance,normals</extra_fields>
  </view>
</settings>"""


def test_viewer_honors_view_settings(tmp_path):
    p = tmp_path / "project.xml"
    p.write_text(VIEW_XML)
    f = ft.FG(device="cpu")
    f.load_xml(str(p))
    assert f.run() == 0
    v = SliceViewer.from_fg(f)
    assert v.field == "sigma" and v.component == 1
    assert v.slice_dim == "y" and abs(v.slice_index - 0.25) < 1e-12
    assert v.custom_bounds == (-1.0, 1.0)
    assert "distance" in v.fields and "normals" in v.fields
    assert v.current_slice().shape == (8, 8)


def test_schema_lookup_and_render():
    from fibergen_tpu_torch.gui.help import Schema, _schema_path
    assert os.path.samefile(_schema_path(),
                            os.path.join(ROOT, "doc", "fileformat.xml"))
    s = Schema()
    e = s.lookup("solver.mixing_rule")
    assert e is not None
    assert "laminate" in e.values and "fluidity" in e.values
    assert e.default == "voigt"
    txt = s.help_for("solver.mixing_rule")
    assert "interface" in txt and "voigt" in txt
    a = s.lookup("actions.place_fiber.R")
    assert a is not None and "radius" in a.help
    txt2 = s.help_for("actions.place_fiber")
    assert "attributes:" in txt2 and "cx" in txt2
    assert s.lookup("solver.nonexistent_thing") is None


def test_cursor_element_path():
    from fibergen_tpu_torch.gui.help import element_path_at, help_at
    doc = """<settings>
  <solver n="16">
    <tol>1e-6</tol>
    <materials>
      <matrix mu="1" />
    </materials>
  </solver>
  <actions>
    <place_fiber R="0.3" />
  </actions>
</settings>"""
    assert element_path_at(doc, doc.index("1e-6")) == "settings.solver.tol"
    pos = doc.index('R="0.3"')
    assert element_path_at(doc, pos) == "settings.actions.place_fiber"
    pos = doc.index("</materials>") + len("</materials>") + 1
    assert element_path_at(doc, pos) == "settings.solver"
    assert "place_fiber" in help_at(doc, doc.index('R="0.3"'))


def test_schema_defaults_match_solver_options():
    """The schema's <solver> defaults agree with the port's SolverOptions,
    so the help never lies about them.  No default differs: the port keeps
    the JAX package's option names and defaults, the TPU-only ones
    (use_pallas, use_sweep) included, which it accepts at their
    defaults."""
    from fibergen_tpu_torch.gui.help import Schema
    from fibergen_tpu_torch.solvers.ls import SolverOptions
    s = Schema()
    opt = SolverOptions()
    checks = {
        "mode": opt.mode, "method": opt.method,
        "tol": repr(opt.tol).replace("0.0001", "1e-4"),
        "maxiter": str(opt.maxiter),
        "error_estimator": opt.error_estimator,
        "update_ref": opt.update_ref,
        "loadstep_extrapolation_method": opt.loadstep_extrapolation_method,
        "cg_inner_product": opt.cg_inner_product,
        "nl_cg_beta_scheme": opt.nl_cg_beta_scheme,
        "G0_solver": opt.g0_solver,
        "check_every": str(opt.check_every),
        "use_pallas": opt.use_pallas,
        "use_sweep": opt.use_sweep,
        "sharding_fallback": opt.sharding_fallback,
    }
    for key, expect in checks.items():
        e = s.lookup(f"solver.{key}")
        assert e is not None, f"schema missing solver.{key}"
        assert str(e.default) == str(expect), (key, e.default, expect)


def test_schema_covers_action_vocabulary():
    """Every _action_* handler of the port's FG has a schema entry."""
    from fibergen_tpu_torch import api
    from fibergen_tpu_torch.gui.help import Schema
    documented = set(Schema().lookup("actions").children)
    handlers = [n[len("_action_"):] for n in dir(api.FG)
                if n.startswith("_action_")]
    missing = [h for h in handlers if h not in documented and h != "group"]
    assert handlers and not missing, f"schema missing actions: {missing}"


PARITY_XML = """<settings>
  <solver nx="9" ny="7" nz="5">
    <materials><matrix mu="1" lambda="1" /><fiber mu="5" lambda="2" /></materials>
    <tol>1e-10</tol>
  </solver>
  <actions>
    <select_material name="fiber" />
    <place_fiber R="0.3" />
    <run_load_case e11="0.01" e23="0.004" />
  </actions>
  <view>
    <field>sigma{comp}</field>
    <slice_dim>{dim}</slice_dim>
    <slice_index>0.5</slice_index>
  </view>
</settings>"""


def test_viewed_slice_matches_jax():
    """SliceViewer.from_fg of both packages' FG on one project: the same
    view, the viewed slice within 1e-10 of its largest value, for two
    fields and slice axes."""
    for comp, dim, field in ((0, "z", "sigma"), (3, "x", "epsilon")):
        xml = PARITY_XML.format(comp=comp, dim=dim).replace(
            "<field>sigma", f"<field>{field}")
        f, jf = ft.FG(device="cpu"), fg.FG()
        for x in (f, jf):
            x.set_xml(xml)
            assert x.run() == 0
        v, jv = SliceViewer.from_fg(f), JSliceViewer.from_fg(jf)
        assert (v.field, v.component, v.slice_dim) == \
            (jv.field, jv.component, jv.slice_dim) == (field, comp, dim)
        sl, jsl = v.current_slice(), jv.current_slice()
        assert sl.shape == jsl.shape
        np.testing.assert_allclose(sl, jsl, rtol=0,
                                   atol=1e-10 * np.abs(jsl).max())


def test_headless_run_imports_no_matplotlib(tmp_path):
    """run_project_and_view(..., show=False), SliceViewer.current_slice and
    list_demos import no matplotlib (the card's machine has none): checked
    in a fresh interpreter."""
    p = tmp_path / "project.xml"
    p.write_text(XML)
    code = f"""
import sys
from fibergen_tpu_torch.gui.app import run_project_and_view
from fibergen_tpu_torch.gui.viewer import list_demos
from fibergen_tpu_torch.utils.logging import LOG
LOG.enabled = False
fg, v = run_project_and_view({str(p)!r}, show=False, device="cpu")
assert v.current_slice().shape == (8, 8)
assert list_demos({os.path.join(ROOT, "demo")!r})
bad = sorted(m for m in sys.modules if m.split(".")[0] == "matplotlib")
print("BAD", bad)
assert not bad
"""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=str(tmp_path))
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    assert "BAD []" in out.stdout
