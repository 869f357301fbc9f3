"""Real-Qt twin of test_torch_gui_qt.py.

The port's GUI targets the PyQt5 API; the default suite proves its logic
against its qt_stub.  Wherever real PyQt5 is importable, this gate re-runs
the same test module under the real binding with Qt's offscreen platform,
catching stub-vs-Qt drift (signal timing, dialog modality, widget
defaults).  Without PyQt5 it skips, as tests/test_gui_qt_real.py does.
"""
import os
import subprocess
import sys

import pytest


def test_gui_flows_under_real_qt():
    pytest.importorskip("PyQt5")
    env = dict(os.environ)
    env.pop("FIBERGEN_TPU_FORCE_QT_STUB", None)
    env["FIBERGEN_TPU_GUI_REAL"] = "1"
    env.setdefault("QT_QPA_PLATFORM", "offscreen")
    here = os.path.dirname(os.path.abspath(__file__))
    # subprocess: qt_compat picks its binding once per process, so the
    # stub run (this process) and the real-Qt run must not share one
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q",
         os.path.join(here, "test_torch_gui_qt.py")],
        env=env, capture_output=True, text=True, timeout=1800)
    assert proc.returncode == 0, (
        f"real-Qt GUI flows failed:\n{proc.stdout[-4000:]}\n"
        f"{proc.stderr[-2000:]}")
