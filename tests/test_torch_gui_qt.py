"""The port's MainWindow/dialog logic executed headless against its
qt_stub, on the CPU: the eleven flows of tests/test_gui_qt.py (demo
browser, cursor help, run, result tabs with contrast/bounds controls,
preferences, VTK export, help browser, open, run errors, depth mode, Embed
and TeX export) through fibergen_tpu_torch.gui, every run on the port's FG
with ``device="cpu"``."""
import os

# Default: force the deterministic headless stub.  test_torch_gui_qt_real.py
# re-runs this exact module under real PyQt5 (offscreen) wherever that
# binding exists by setting FIBERGEN_TPU_GUI_REAL=1 in a subprocess (the
# same variables as the JAX package's GUI tests).
if not os.environ.get("FIBERGEN_TPU_GUI_REAL"):
    os.environ["FIBERGEN_TPU_FORCE_QT_STUB"] = "1"

import matplotlib
matplotlib.use("Agg")

import numpy as np
import pytest

from fibergen_tpu_torch.gui import qt_compat
from fibergen_tpu_torch.gui.qt_compat import QtCore, QtWidgets
from fibergen_tpu_torch.utils.logging import LOG

LOG.enabled = False

if os.environ.get("FIBERGEN_TPU_GUI_REAL") and not qt_compat.HAS_QT:
    pytestmark = pytest.mark.skip(
        reason="FIBERGEN_TPU_GUI_REAL set but PyQt5 is not importable")

XML = """
<settings>
  <solver n="8">
    <tol>1e-4</tol>
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


def _patch_save(path):
    """Point the (stub) save-file dialog at `path`; the stub class is only
    ever used by these tests, so patching the staticmethod is contained."""
    QtWidgets.QFileDialog.getSaveFileName = staticmethod(
        lambda *a, **k: (path, ""))


@pytest.fixture
def win():
    from fibergen_tpu_torch.gui.app import MainWindow
    app = QtWidgets.QApplication([])
    app.settings = QtCore.QSettings("fibergen_tpu_torch", "test")
    if hasattr(QtCore.QSettings, "_stores"):  # stub-only state reset
        QtCore.QSettings._stores.clear()
    w = MainWindow(device="cpu")
    assert w.device.type == "cpu"
    app.window = w
    return w


def test_mainwindow_demo_browser(win):
    assert win.demos.topLevelItemCount() >= 5
    cats = [win.demos.topLevelItem(i).text(0)
            for i in range(win.demos.topLevelItemCount())]
    assert any("lasticity" in c for c in cats)
    # double-clicking a demo loads its XML into the editor
    top = win.demos.topLevelItem(0)
    assert top.childCount() > 0
    item = top.child(0)
    win.demos.itemDoubleClicked.emit(item, 0)
    assert "<settings" in win.editor.toPlainText()


def test_editor_cursor_context_help(win):
    win.editor.setPlainText(XML)
    pos = XML.index("1e-4")
    win.editor.set_cursor_position(pos)
    assert "tol" in win.help_pane.toPlainText()


def test_xml_highlighter_spans(win):
    win.editor.setPlainText('<solver n="8"><!-- c --></solver>')
    spans = win._highlighter.spans
    assert spans and spans[0]
    # at least a tag span and a comment span on the first line
    fmts = [f for (_s, _l, f) in spans[0]]
    assert any(f.weight == qt_compat.QtGui.QFont.Bold for f in fmts)
    assert any(f.italic for f in fmts)


def test_run_view_results_and_controls(win, tmp_path):
    win.editor.setPlainText(XML)
    win.buttons["Run"].click()
    assert "done" in win.output.toPlainText()
    win.buttons["View results"].click()
    assert win.tabs.count() == 2
    tab = win.tabs.currentWidget()
    v = tab.viewer
    # drive the controls; each emits and triggers redraw on the viewer
    tab.controls["alpha"].setValue(0.05)
    assert v.alpha == pytest.approx(0.05)
    tab.controls["bounds"].setChecked(True)
    tab.controls["vmin"].setText("-0.5")
    tab.controls["vmax"].setText("0.5")
    assert v.custom_bounds == (-0.5, 0.5)
    tab.controls["bounds"].setChecked(False)
    assert v.custom_bounds is None
    tab.controls["slider"].setValue(25)
    assert v.slice_index == pytest.approx(0.25)
    tab.controls["dim"].setCurrentText("x")
    assert v.slice_dim == "x"
    # PNG export through the dialog hook
    png = tmp_path / "out.png"
    _patch_save(str(png))
    tab.controls["png"].click()
    assert png.stat().st_size > 500
    # closing the result tab
    win.tabs.tabCloseRequested.emit(1)
    assert win.tabs.count() == 1


def test_preferences_dialog_persists(win):
    win.buttons["Preferences..."].click()
    dlg = win._pref_dialog
    dlg.font_size.setValue(14)
    dlg.tab_width.setValue(4)
    dlg.save()
    assert win.editor.font().pointSize() == 14
    assert win.editor.tabStopWidth() == 4
    assert win.settings.value("fontPointSize", type=int) == 14
    # a fresh editor picks the saved values up
    ed2 = QtWidgets.QPlainTextEdit()
    from fibergen_tpu_torch.gui.app import PreferencesDialog
    PreferencesDialog.apply_saved(ed2, win.settings)
    assert ed2.font().pointSize() == 14
    assert ed2.tabStopWidth() == 4


def test_write_vtk_dialog(win, tmp_path):
    win.editor.setPlainText(XML)
    win.buttons["Run"].click()
    vtk = tmp_path / "out.vtk"
    _patch_save(str(vtk))
    win.buttons["Write VTK..."].click()
    dlg = win._vtk_dialog
    assert set(dlg.checks) >= {"epsilon", "sigma", "phi"}
    dlg.checks["phi"].setChecked(False)
    dlg.write()
    data = vtk.read_bytes()
    assert data.startswith(b"# vtk")
    assert b"epsilon" in data and b"phi" not in data


def test_write_vtk_dialog_no_fields_warns(win, tmp_path):
    win.editor.setPlainText(XML)
    win.buttons["Run"].click()
    vtk = tmp_path / "none.vtk"
    _patch_save(str(vtk))
    win.buttons["Write VTK..."].click()
    dlg = win._vtk_dialog
    for cb in dlg.checks.values():
        cb.setChecked(False)
    dlg.write()
    assert not vtk.exists()


def test_help_browser_tab(win):
    win.buttons["Help"].click()
    assert win.tabs.tabText(win.tabs.count() - 1) == "Help"
    html = win.tabs.currentWidget().toHtml()
    assert "place_fiber" in html and "mixing_rule" in html


def test_open_project_dialog(win, tmp_path):
    p = tmp_path / "p.xml"
    p.write_text(XML)
    QtWidgets.QFileDialog.getOpenFileName = staticmethod(
        lambda *a, **k: (str(p), ""))
    try:
        win.buttons["Open..."].click()
    finally:
        QtWidgets.QFileDialog.getOpenFileName = staticmethod(
            lambda *a, **k: ("", ""))
    assert win.editor.toPlainText() == XML


def test_run_error_reported(win):
    win.editor.setPlainText(
        "<settings><solver n='8'><materials><m mu='1' lambda='1'/>"
        "</materials></solver>"
        "<actions><no_such_action /></actions></settings>")
    win.buttons["Run"].click()
    assert "ERROR" in win.output.toPlainText()


def test_depth_mode_embed_and_tex_export(win, tmp_path):
    """Round-4 GUI deltas: depth mode compositing, Embed-view XML round
    trip (fibergen_gui.py:716-732, 825-828, 986-1102), full colormap list
    and the PNG+TeX export with the serialized colormap."""
    win.editor.setPlainText(XML)
    win.buttons["Run"].click()
    win.buttons["View results"].click()
    tab = win.tabs.currentWidget()
    v = tab.viewer

    # full matplotlib colormap registry in the combo (not a short list)
    assert tab.controls["cmap"].count() > 50

    # depth mode: phi composites over depth; other fields are unaffected
    tab.controls["field"].setCurrentText("phi")
    tab.controls["depth"].setChecked(True)
    assert v.depth_view
    v.slice_dim = "z"
    v.slice_index = 0.0
    composite = v.current_slice()
    v.depth_view = False
    plain = v.current_slice()
    assert composite.shape == plain.shape
    assert np.all(composite >= plain - 1e-12)   # max over attenuated depth
    assert composite.max() > 0
    v.depth_view = True

    # Embed: serialize the view into the editor XML, then read it back
    tab.controls["cmap"].setCurrentText("viridis")
    tab.controls["alpha"].setValue(0.02)
    tab.embed_view()
    xml2 = win.editor.toPlainText()
    assert "<view>" in xml2 and "<depth_view>1</depth_view>" in xml2
    assert "<colormap>viridis</colormap>" in xml2

    # round trip: a fresh viewer built from the embedded XML reproduces
    # the exact view state
    import fibergen_tpu_torch as ft
    from fibergen_tpu_torch.gui.viewer import SliceViewer
    f2 = ft.FG(device="cpu")
    f2.set_xml(xml2)
    assert f2.run() == 0
    v2 = SliceViewer.from_fg(f2)
    assert v2.field == v.field and v2.component == v.component
    assert v2.depth_view and v2.colormap == "viridis"
    assert v2.alpha == pytest.approx(v.alpha)
    assert v2.slice_dim == v.slice_dim
    assert v2.slice_index == pytest.approx(v.slice_index)

    # idempotent re-embed: the <view> block is replaced, not duplicated
    tab.embed_view()
    assert win.editor.toPlainText().count("<view>") == 1

    # PNG + TeX export with the embedded 256-entry colormap
    tex = tmp_path / "plot.tex"
    _patch_save(str(tex))
    tab.controls["tex"].click()
    assert (tmp_path / "plot.png").stat().st_size > 200
    body = tex.read_text()
    assert body.count("rgb255=") == 256 and "pgfplots" in body
