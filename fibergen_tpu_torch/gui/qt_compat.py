"""Qt binding shim: real PyQt5 when installed, headless stub otherwise.

The GUI targets the PyQt5 API (like the reference IDE, lib/fibergen_gui.py);
on display-less GPU hosts PyQt5 is typically absent, so this module swaps in
`qt_stub`, which implements the same API subset as plain Python objects.
All GUI modules import Qt through here — which is also what lets the test
suite execute the full MainWindow/dialog logic headless.

Set ``FIBERGEN_TPU_FORCE_QT_STUB=1`` to use the stub even when PyQt5 is
importable (used by tests to get deterministic behavior); the variable is
the JAX package's GUI's too, so one setting drives both GUIs.
"""
from __future__ import annotations

import os

HAS_QT = False
if not os.environ.get("FIBERGEN_TPU_FORCE_QT_STUB"):
    try:
        from PyQt5 import QtCore, QtGui, QtWidgets  # noqa: F401

        HAS_QT = True
    except ImportError:
        pass

if not HAS_QT:
    from .qt_stub import QtCore, QtGui, QtWidgets  # noqa: F401
