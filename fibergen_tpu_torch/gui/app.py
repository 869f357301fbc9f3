"""GUI application entry.

A compact IDE in the spirit of the reference GUI (lib/fibergen_gui.py):
XML editor with syntax highlighting and cursor context help, demo browser,
run button with live convergence output, per-run result tabs with
field/slice/colormap/contrast controls, preferences and VTK-export dialogs,
and an offline help browser driven by doc/fileformat.xml.

All Qt access goes through `qt_compat`: with PyQt5 installed this is a real
windowed application; without it (headless GPU hosts, CI) the same
MainWindow/dialog logic runs against the `qt_stub` widget objects, which is
how the test suite exercises every flow below without a display.

Every solve runs through the port's :class:`~fibergen_tpu_torch.api.FG` on
the card unless the caller asks for the CPU: :func:`run_project_and_view`
and :class:`MainWindow` take ``device`` (``None`` is ``cuda``, through
``core.device.resolve_device``) and :func:`main` reads ``--device
cpu|cuda``.  matplotlib is imported only where a slice is drawn, so a
headless run (``run_project_and_view(..., show=False)``) imports none.

    python -m fibergen_tpu_torch.gui.app [--device cpu|cuda] [project.xml]
"""
from __future__ import annotations

import os
import sys

from ..api import FG
from ..core.device import resolve_device
from ..utils.logging import LOG
from .qt_compat import HAS_QT, QtCore, QtGui, QtWidgets
from .viewer import SliceViewer, list_demos


def run_project_and_view(path: str, show: bool = True, device=None):
    """Run a project on ``device`` (the card by default) and open the slice
    viewer.  Honors the project's <view> block, including
    <record_loadstep>: per-loadstep snapshots of the viewed field are
    captured through the loadstep callback exactly like the reference GUI
    (lib/fibergen_gui.py runProject <view> support).  ``show=False``
    returns (fg, viewer) without drawing."""
    fg = FG(device=device)
    fg.load_xml(path)
    record = None
    try:
        view = fg.project.root.find("view")
        e = view.find("record_loadstep") if view is not None else None
        if e is not None and (e.text or "").strip() not in ("", "0", "false"):
            record = (e.text or "epsilon").strip()
            if record in ("1", "true"):
                fld = view.find("field")
                record = (fld.text.strip().rstrip("0123456789")
                          if fld is not None and fld.text else "epsilon")
    except Exception:  # noqa: BLE001 - malformed <view> is non-fatal
        record = None
    snapshots = []
    if record:
        def _snap():
            try:
                snapshots.append(fg.get_field(record).copy())
            except Exception:  # noqa: BLE001
                pass
            return False
        fg.set_loadstep_callback(_snap)
    fg.run()
    viewer = SliceViewer.from_fg(fg)
    viewer.loadsteps = snapshots
    if show:
        viewer.show()
    return fg, viewer


def make_xml_highlighter(document):
    """XML syntax highlighter for the editor (the reference's
    XMLHighlighter, fibergen_gui.py:1617-1772): tags, attribute names,
    quoted values, and comments get distinct colors."""
    rules = []

    def fmt(color, bold=False, italic=False):
        f = QtGui.QTextCharFormat()
        f.setForeground(QtGui.QColor(color))
        if bold:
            f.setFontWeight(QtGui.QFont.Bold)
        if italic:
            f.setFontItalic(True)
        return f

    rules.append((QtCore.QRegExp(r"<[/!?]?\b[A-Za-z_][\w.-]*"),
                  fmt("#000080", bold=True)))
    rules.append((QtCore.QRegExp(r"/?>"), fmt("#000080", bold=True)))
    rules.append((QtCore.QRegExp(r"\b[A-Za-z_][\w.-]*(?==)"),
                  fmt("#806000")))
    rules.append((QtCore.QRegExp(r'"[^"]*"'), fmt("#008000")))
    comment_fmt = fmt("#808080", italic=True)

    class XMLHighlighter(QtGui.QSyntaxHighlighter):
        def highlightBlock(self, text):
            for rx, f in rules:
                i = rx.indexIn(text, 0)
                while i >= 0:
                    n = rx.matchedLength()
                    self.setFormat(i, n, f)
                    i = rx.indexIn(text, i + n)
            # multi-line comments via block state
            start_rx = QtCore.QRegExp(r"<!--")
            end_rx = QtCore.QRegExp(r"-->")
            self.setCurrentBlockState(0)
            start = 0 if self.previousBlockState() == 1 else start_rx.indexIn(text)
            while start >= 0:
                end = end_rx.indexIn(text, start)
                if end == -1:
                    self.setCurrentBlockState(1)
                    length = len(text) - start
                else:
                    length = end - start + 3
                self.setFormat(start, length, comment_fmt)
                start = start_rx.indexIn(text, start + length)

    return XMLHighlighter(document)


def _make_canvas(fig):
    """A draw-able canvas for `fig`: the Qt canvas when PyQt5 is present,
    the Agg canvas otherwise (same draw_idle API, renders off-screen)."""
    if HAS_QT:
        from matplotlib.backends.backend_qt5agg import FigureCanvasQTAgg
        return FigureCanvasQTAgg(fig)
    from matplotlib.backends.backend_agg import FigureCanvasAgg
    return FigureCanvasAgg(fig)


class PreferencesDialog(QtWidgets.QDialog):
    """Editor preferences: font family/size and tab width, persisted via
    QSettings (the reference's PreferencesWidget, fibergen_gui.py:59-134)."""

    def __init__(self, editor, settings, parent=None):
        super().__init__(parent)
        self.setWindowTitle("Preferences")
        self._editor = editor
        self._settings = settings

        grid = QtWidgets.QGridLayout()

        self.font_combo = QtWidgets.QFontComboBox()
        self.font_combo.setCurrentText(editor.font().family())
        grid.addWidget(QtWidgets.QLabel("Font:"), 0, 0)
        grid.addWidget(self.font_combo, 0, 1)

        self.font_size = QtWidgets.QSpinBox()
        self.font_size.setRange(1, 100)
        self.font_size.setValue(editor.font().pointSize())
        grid.addWidget(QtWidgets.QLabel("Font size:"), 1, 0)
        grid.addWidget(self.font_size, 1, 1)

        self.tab_width = QtWidgets.QSpinBox()
        self.tab_width.setRange(1, 1000)
        self.tab_width.setValue(editor.tabStopWidth())
        grid.addWidget(QtWidgets.QLabel("Tab width:"), 2, 0)
        grid.addWidget(self.tab_width, 2, 1)

        hbox = QtWidgets.QHBoxLayout()
        ok = QtWidgets.QPushButton("Save")
        ok.clicked.connect(self.save)
        cancel = QtWidgets.QPushButton("Cancel")
        cancel.clicked.connect(self.reject)
        hbox.addStretch(1)
        hbox.addWidget(cancel)
        hbox.addWidget(ok)
        grid.addLayout(hbox, 3, 0, 1, 2)
        self.setLayout(grid)

    def save(self):
        font = self.font_combo.currentFont()
        font.setPointSize(self.font_size.value())
        self._editor.setFont(font)
        self._editor.setTabStopWidth(self.tab_width.value())
        self._settings.setValue("fontFamily", font.family())
        self._settings.setValue("fontPointSize", font.pointSize())
        self._settings.setValue("tabStopWidth", self.tab_width.value())
        self.accept()

    @staticmethod
    def apply_saved(editor, settings):
        """Restore persisted preferences onto an editor at startup."""
        font = editor.font()
        fam = settings.value("fontFamily")
        if fam:
            font.setFamily(fam)
        size = settings.value("fontPointSize", type=int)
        if size:
            font.setPointSize(size)
        editor.setFont(font)
        tw = settings.value("tabStopWidth", type=int)
        if tw:
            editor.setTabStopWidth(tw)


class WriteVTKDialog(QtWidgets.QDialog):
    """Export selected solution fields to a legacy VTK file (the
    reference's WriteVTKWidget, fibergen_gui.py:135-307): one checkbox per
    field, written through io.vtk (binary STRUCTURED_POINTS cell data with
    the same SCALARS/VECTORS/TENSORS classification)."""

    def __init__(self, filename, viewer, parent=None):
        super().__init__(parent)
        self.setWindowTitle("Write VTK")
        self.filename = filename
        self._viewer = viewer

        vbox = QtWidgets.QVBoxLayout()
        vbox.addWidget(QtWidgets.QLabel("Fields to export:"))
        self.checks = {}
        row = QtWidgets.QHBoxLayout()
        for name in viewer.fields:
            cb = QtWidgets.QCheckBox(name)
            cb.setChecked(True)
            self.checks[name] = cb
            row.addWidget(cb)
        row.addStretch(1)
        vbox.addLayout(row)

        hline = QtWidgets.QFrame()
        hline.setFrameShape(QtWidgets.QFrame.HLine)
        hline.setFrameShadow(QtWidgets.QFrame.Sunken)
        vbox.addWidget(hline)

        self.open_paraview = QtWidgets.QCheckBox("Open with ParaView after save")
        vbox.addWidget(self.open_paraview)

        hbox = QtWidgets.QHBoxLayout()
        ok = QtWidgets.QPushButton("Save")
        ok.clicked.connect(self.write)
        cancel = QtWidgets.QPushButton("Cancel")
        cancel.clicked.connect(self.reject)
        hbox.addStretch(1)
        hbox.addWidget(cancel)
        hbox.addWidget(ok)
        vbox.addLayout(hbox)
        self.setLayout(vbox)

    def write(self):
        from ..io.vtk import write_vtk
        fields = {k: v for k, v in self._viewer.fields.items()
                  if self.checks[k].isChecked()}
        if not fields:
            QtWidgets.QMessageBox.warning(self, "Write VTK",
                                          "no fields selected")
            return
        write_vtk(self.filename, self._viewer.grid, fields)
        self.accept()
        if self.open_paraview.isChecked():
            import subprocess
            try:
                subprocess.Popen(["paraview", self.filename],
                                 cwd=os.path.dirname(self.filename) or ".")
            except OSError as e:
                LOG.warn(f"could not launch paraview: {e}")


def _help_index_html():
    """Offline help: an HTML rendering of doc/fileformat.xml (the
    reference's help browser, fibergen_gui.py:419-524 + HelpWidget, which
    renders the same schema; this framework has no web service, so the
    offline path is the only one)."""
    from . import help as helpmod
    sch = helpmod.schema()
    parts = ["<h1>fibergen_tpu_torch project file reference</h1>"]

    def walk(entry, path):
        name = path.split(".")[-1]
        parts.append(f'<h2 id="{path}">&lt;{name}&gt;</h2>')
        if entry.help:
            parts.append(f"<p>{entry.help}</p>")
        if entry.attribs:
            parts.append("<ul>")
            for aname, a in entry.attribs.items():
                parts.append(f"<li><b>{aname}</b>: {a.help}</li>")
            parts.append("</ul>")
        for cname, child in entry.children.items():
            walk(child, f"{path}.{cname}")

    root = sch.root
    walk(root, "settings")
    return "\n".join(parts)


class MainWindow(QtWidgets.QMainWindow):
    """The IDE main window (reference: MainWindow, fibergen_gui.py:2690+);
    its runs solve on ``device`` (the card by default)."""

    def __init__(self, device=None):
        super().__init__()
        self.device = resolve_device(device)
        self.setWindowTitle("fibergen_tpu_torch")
        app = QtWidgets.QApplication.instance()
        self.settings = getattr(app, "settings", None) or QtCore.QSettings(
            "fibergen_tpu_torch", "gui")

        self.editor = QtWidgets.QPlainTextEdit()
        self._highlighter = make_xml_highlighter(self.editor.document())
        self.editor.cursorPositionChanged.connect(self.update_help)
        PreferencesDialog.apply_saved(self.editor, self.settings)
        self.output = QtWidgets.QPlainTextEdit()
        self.output.setReadOnly(True)
        # context-help pane driven by doc/fileformat.xml
        # (the reference's HelpWidget, fibergen_gui.py:1945-2318)
        self.help_pane = QtWidgets.QPlainTextEdit()
        self.help_pane.setReadOnly(True)
        # demo browser (fibergen_gui.py:2381-2682)
        self.demos = QtWidgets.QTreeWidget()
        self.demos.setHeaderLabels(["Demos"])
        self.demos.itemDoubleClicked.connect(self.open_demo)
        self._fill_demos()

        buttons = (("Open...", self.open_project),
                   ("Run", self.run_project),
                   ("View results", self.view_results),
                   ("Write VTK...", self.export_vtk),
                   ("Help", self.show_help),
                   ("Preferences...", self.show_preferences))
        bar = QtWidgets.QHBoxLayout()
        self.buttons = {}
        for label, slot in buttons:
            b = QtWidgets.QPushButton(label)
            b.clicked.connect(slot)
            self.buttons[label] = b
            bar.addWidget(b)

        lay = QtWidgets.QVBoxLayout()
        lay.addLayout(bar)
        right = QtWidgets.QSplitter()
        right.setOrientation(QtCore.Qt.Vertical)
        right.addWidget(self.help_pane)
        right.addWidget(self.output)
        split = QtWidgets.QSplitter()
        split.addWidget(self.demos)
        split.addWidget(self.editor)
        split.addWidget(right)
        split.setSizes([150, 500, 300])
        lay.addWidget(split)
        w = QtWidgets.QWidget()
        w.setLayout(lay)
        # project + result tabs (the reference IDE keeps one result tab
        # per run, fibergen_gui.py:3047-3246)
        self.tabs = QtWidgets.QTabWidget()
        self.tabs.setTabsClosable(True)
        self.tabs.tabCloseRequested.connect(self._close_tab)
        self.tabs.addTab(w, "Project")
        self.setCentralWidget(self.tabs)
        self.fg = None
        self._results = 0

    def _close_tab(self, i):
        if i > 0:
            self.tabs.removeTab(i)

    def _fill_demos(self):
        demo_dir = os.path.join(os.path.dirname(__file__), "..", "..",
                                "demo")
        if not os.path.isdir(demo_dir):
            return
        self.demos.setIconSize(QtCore.QSize(48, 48))
        for cat in list_demos(demo_dir):
            top = QtWidgets.QTreeWidgetItem([cat["title"]])
            self.demos.addTopLevelItem(top)
            for p in cat["projects"]:
                item = QtWidgets.QTreeWidgetItem([p["title"]])
                item.setData(0, QtCore.Qt.UserRole, p["path"])
                thumb = os.path.join(os.path.dirname(p["path"]),
                                     "thumbnail.png")
                if os.path.isfile(thumb):
                    item.setIcon(0, QtGui.QIcon(thumb))
                top.addChild(item)
        self.demos.expandAll()

    def open_demo(self, item, _col):
        path = item.data(0, QtCore.Qt.UserRole)
        if path:
            with open(path) as f:
                self.editor.setPlainText(f.read())

    def update_help(self):
        from . import help as helpmod
        text = self.editor.toPlainText()
        pos = self.editor.textCursor().position()
        try:
            self.help_pane.setPlainText(helpmod.help_at(text, pos))
        except Exception as e:  # noqa: BLE001 - help must never crash
            self.help_pane.setPlainText(f"(help unavailable: {e})")

    def open_project(self):
        path, _ = QtWidgets.QFileDialog.getOpenFileName(
            self, "Open project", "", "Project files (*.xml *.py)")
        if path:
            with open(path) as f:
                self.editor.setPlainText(f.read())

    def run_project(self):
        self.fg = FG(device=self.device)
        self.fg.set_xml(self.editor.toPlainText())

        def conv_cb():
            QtWidgets.QApplication.processEvents()
            return False

        self.fg.set_convergence_callback(conv_cb)
        try:
            self.fg.run()
            self.output.appendPlainText("done; residuals: "
                                        + str(len(self.fg.get_residuals())))
        except Exception as e:  # noqa: BLE001
            self.output.appendPlainText(f"ERROR: {e}")

    def _viewer(self):
        if self.fg is None:
            return None
        try:
            return SliceViewer.from_fg(self.fg)
        except ValueError as e:
            self.output.appendPlainText(str(e))
            return None

    def view_results(self):
        viewer = self._viewer()
        if viewer is None:
            return
        self._results += 1
        tab = make_plot_tab(viewer, editor=self.editor)
        self.tabs.addTab(tab, f"Results {self._results}")
        self.tabs.setCurrentWidget(tab)

    def export_vtk(self):
        viewer = self._viewer()
        if viewer is None:
            return
        path, _ = QtWidgets.QFileDialog.getSaveFileName(
            self, "Write VTK", "", "VTK files (*.vtk)")
        if not path:
            return
        self._vtk_dialog = WriteVTKDialog(path, viewer, self)
        self._vtk_dialog.exec_()

    def show_help(self):
        browser = QtWidgets.QTextBrowser()
        browser.setHtml(_help_index_html())
        self.tabs.addTab(browser, "Help")
        self.tabs.setCurrentWidget(browser)

    def show_preferences(self):
        self._pref_dialog = PreferencesDialog(self.editor, self.settings, self)
        self._pref_dialog.exec_()


def make_plot_tab(viewer, editor=None):
    """Embedded matplotlib slice-viewer tab (the reference's PlotWidget,
    fibergen_gui.py:525-1616): field/component/slice selectors, the full
    matplotlib colormap list, contrast alpha, custom bounds, interpolation,
    depth mode, PNG/VTK/TeX export, Embed-view-into-XML, live redraw on an
    embedded canvas.  ``editor`` (the MainWindow XML editor) enables the
    Embed action (fibergen_gui.py:825-828)."""
    import matplotlib
    from matplotlib.figure import Figure

    w = QtWidgets.QWidget()
    fig = Figure(figsize=(5, 4))
    canvas = _make_canvas(fig)

    field_box = QtWidgets.QComboBox()
    field_box.addItems(list(viewer.fields))
    comp_box = QtWidgets.QSpinBox()
    comp_box.setRange(0, 8)
    dim_box = QtWidgets.QComboBox()
    dim_box.addItems(["x", "y", "z"])
    dim_box.setCurrentText(viewer.slice_dim)
    slider = QtWidgets.QSlider(QtCore.Qt.Horizontal)
    slider.setRange(0, 100)
    slider.setValue(int(viewer.slice_index * 100))
    cmap_box = QtWidgets.QComboBox()
    # the full registry, case-insensitively sorted like the reference's
    # sorted(mcmap.datad) combo (fibergen_gui.py:693-698)
    cmap_box.addItems(sorted(matplotlib.colormaps, key=str.lower))
    cmap_box.setCurrentText(viewer.colormap)
    interp = QtWidgets.QCheckBox("interpolate")
    depth_chk = QtWidgets.QCheckBox("depth mode")
    depth_chk.setChecked(viewer.depth_view)
    # contrast alpha: quantile clipping of the color range (PlotWidget's
    # alpha spin box)
    alpha_box = QtWidgets.QDoubleSpinBox()
    alpha_box.setRange(0.0, 0.49)
    alpha_box.setSingleStep(0.01)
    alpha_box.setDecimals(3)
    alpha_box.setValue(viewer.alpha)
    # custom color bounds (PlotWidget's vmin/vmax fields)
    bounds_chk = QtWidgets.QCheckBox("custom bounds")
    vmin_edit = QtWidgets.QLineEdit("0.0")
    vmax_edit = QtWidgets.QLineEdit("1.0")
    if viewer.custom_bounds is not None:
        bounds_chk.setChecked(True)
        vmin_edit.setText(str(viewer.custom_bounds[0]))
        vmax_edit.setText(str(viewer.custom_bounds[1]))

    def redraw(*_a):
        viewer.field = field_box.currentText()
        ncomp = viewer.fields[viewer.field].shape[0]
        comp_box.setMaximum(max(0, ncomp - 1))
        viewer.component = min(comp_box.value(), ncomp - 1)
        viewer.slice_dim = dim_box.currentText()
        viewer.slice_index = slider.value() / 100.0
        viewer.colormap = cmap_box.currentText()
        viewer.interpolate = interp.isChecked()
        viewer.depth_view = depth_chk.isChecked()
        viewer.alpha = alpha_box.value()
        if bounds_chk.isChecked():
            try:
                viewer.custom_bounds = (float(vmin_edit.text()),
                                        float(vmax_edit.text()))
            except ValueError:
                viewer.custom_bounds = None
        else:
            viewer.custom_bounds = None
        fig.clf()
        viewer.render(fig.add_subplot(111))
        canvas.draw_idle()

    def save_png(*_a):
        path, _ = QtWidgets.QFileDialog.getSaveFileName(
            w, "Save PNG", "", "PNG images (*.png)")
        if path:
            viewer.save_png(path)

    def write_vtk(*_a):
        path, _ = QtWidgets.QFileDialog.getSaveFileName(
            w, "Write VTK", "", "VTK files (*.vtk)")
        if path:
            WriteVTKDialog(path, viewer, w).exec_()

    def export_tex(*_a):
        path, _ = QtWidgets.QFileDialog.getSaveFileName(
            w, "Export PNG + TeX", "", "LaTeX files (*.tex)")
        if path:
            viewer.save_plot_export(path)

    def embed_view(*_a):
        """Serialize the current view into the project XML in the editor
        (the reference's Embed toolbar action, fibergen_gui.py:825-828)."""
        if editor is None:
            return
        from .viewer import embed_view_xml
        editor.setPlainText(
            embed_view_xml(editor.toPlainText(), viewer.view_xml()))

    png_btn = QtWidgets.QPushButton("Save PNG...")
    png_btn.clicked.connect(save_png)
    vtk_btn = QtWidgets.QPushButton("Write VTK...")
    vtk_btn.clicked.connect(write_vtk)
    tex_btn = QtWidgets.QPushButton("Export PNG+TeX...")
    tex_btn.clicked.connect(export_tex)
    embed_btn = QtWidgets.QPushButton("Embed")
    embed_btn.setToolTip("Embed view into XML document")
    embed_btn.clicked.connect(embed_view)
    embed_btn.setEnabled(editor is not None)

    for wd, sig in ((field_box, "currentIndexChanged"),
                    (comp_box, "valueChanged"),
                    (dim_box, "currentIndexChanged"),
                    (slider, "valueChanged"),
                    (cmap_box, "currentIndexChanged"),
                    (interp, "stateChanged"),
                    (depth_chk, "stateChanged"),
                    (alpha_box, "valueChanged"),
                    (bounds_chk, "stateChanged"),
                    (vmin_edit, "textChanged"),
                    (vmax_edit, "textChanged")):
        getattr(wd, sig).connect(redraw)

    bar = QtWidgets.QHBoxLayout()
    for wd in (field_box, comp_box, dim_box, slider, cmap_box, interp,
               depth_chk):
        bar.addWidget(wd)
    bar2 = QtWidgets.QHBoxLayout()
    bar2.addWidget(QtWidgets.QLabel("alpha:"))
    bar2.addWidget(alpha_box)
    bar2.addWidget(bounds_chk)
    bar2.addWidget(vmin_edit)
    bar2.addWidget(vmax_edit)
    bar2.addStretch(1)
    bar2.addWidget(png_btn)
    bar2.addWidget(vtk_btn)
    bar2.addWidget(tex_btn)
    bar2.addWidget(embed_btn)
    lay = QtWidgets.QVBoxLayout()
    lay.addLayout(bar)
    lay.addLayout(bar2)
    lay.addWidget(canvas if HAS_QT else QtWidgets.QWidget())
    w.setLayout(lay)
    w.viewer = viewer
    w.redraw = redraw
    w.embed_view = embed_view
    w.controls = {"field": field_box, "comp": comp_box, "dim": dim_box,
                  "slider": slider, "cmap": cmap_box, "interp": interp,
                  "depth": depth_chk, "alpha": alpha_box,
                  "bounds": bounds_chk, "vmin": vmin_edit,
                  "vmax": vmax_edit, "png": png_btn, "vtk": vtk_btn,
                  "tex": tex_btn, "embed": embed_btn}
    redraw()
    return w


def _qt_app(argv, device):
    app = QtWidgets.QApplication(argv)
    app.settings = QtCore.QSettings("fibergen_tpu_torch", "gui")
    win = MainWindow(device)
    app.window = win
    if len(argv) > 1:
        with open(argv[1]) as f:
            win.editor.setPlainText(f.read())
    win.show()
    return app.exec_()


def _split_device(argv):
    """(argv without ``--device X`` / ``--device=X``, X or None)."""
    out, device, it = [], None, iter(argv)
    for a in it:
        if a == "--device":
            device = next(it, None)
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
        else:
            out.append(a)
    return out, device


def main(argv=None):
    """``argv[0]`` is the program's name, as in ``sys.argv``."""
    argv, device = _split_device(list(sys.argv if argv is None else argv))
    if HAS_QT:
        return _qt_app(argv, device)

    LOG.info("PyQt5 not available: using the matplotlib viewer")
    if len(argv) > 1:
        run_project_and_view(argv[1], device=device)
        return 0
    # no project: print the demo browser listing
    demo_dir = os.path.join(os.path.dirname(__file__), "..", "..", "demo")
    if os.path.isdir(demo_dir):
        for cat in list_demos(demo_dir):
            print(f"[{cat['title']}]")
            for p in cat["projects"]:
                print(f"  {p['title']}: {p['path']}")
    print("usage: python -m fibergen_tpu_torch.gui.app [--device cpu|cuda] "
          "<project.xml>")
    return 0


if __name__ == "__main__":
    sys.exit(main())
