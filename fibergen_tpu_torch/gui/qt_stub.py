"""Headless stand-in for the PyQt5 API subset the GUI uses.

The reference IDE (lib/fibergen_gui.py) is a Qt application; this package's
GUI (`gui/app.py`) targets the same API but must also run — and be TESTED —
in environments without any Qt binding (a GPU server has no display
stack).  This module implements the small
PyQt5 surface the GUI touches as plain Python objects: signals are callback
lists, widgets are state holders, layouts are containers.  `gui/qt_compat`
exposes these under the ``QtCore/QtGui/QtWidgets`` names when PyQt5 is
absent, so the full MainWindow/dialog logic executes headless in CI.

This is NOT a rendering engine: nothing is painted.  It exists so that the
GUI's *logic* (demo browser population, context help, run/plot/preferences/
VTK-export flows) is exercised by the test suite rather than shipped dark.
"""
from __future__ import annotations

import re


class Signal:
    """Qt signal: a list of slots; ``emit`` calls them in order."""

    def __init__(self):
        self._slots = []

    def connect(self, fn):
        self._slots.append(fn)

    def disconnect(self, fn=None):
        if fn is None:
            self._slots.clear()
        elif fn in self._slots:
            self._slots.remove(fn)

    def emit(self, *args):
        for fn in list(self._slots):
            try:
                fn(*args)
            except TypeError:
                fn(*args[: fn.__code__.co_argcount])


# --------------------------------------------------------------------- QtCore
class _Qt:
    Horizontal = 0x1
    Vertical = 0x2
    UserRole = 0x0100
    WindowContextHelpButtonHint = 0x00010000
    Checked = 2
    Unchecked = 0


class QSize:
    def __init__(self, w=0, h=0):
        self._w, self._h = w, h

    def width(self):
        return self._w

    def height(self):
        return self._h


class QRegExp:
    """Regex wrapper with Qt's indexIn/matchedLength protocol."""

    def __init__(self, pattern):
        self._rx = re.compile(pattern)
        self._len = -1

    def indexIn(self, text, pos=0):
        m = self._rx.search(text, pos)
        if m is None or m.end() == m.start():
            self._len = -1
            return -1
        self._len = m.end() - m.start()
        return m.start()

    def matchedLength(self):
        return self._len


class QSettings:
    """In-memory settings store (per organization/application key)."""

    _stores: dict = {}

    def __init__(self, org="fibergen_tpu_torch", app="gui"):
        self._d = QSettings._stores.setdefault((org, app), {})

    def setValue(self, key, value):
        self._d[key] = value

    def value(self, key, default=None, type=None):  # noqa: A002
        v = self._d.get(key, default)
        if type is not None and v is not None:
            v = type(v)
        return v

    def contains(self, key):
        return key in self._d


class QtCore:
    Qt = _Qt
    QSize = QSize
    QRegExp = QRegExp
    QSettings = QSettings


# ---------------------------------------------------------------------- QtGui
class QColor:
    def __init__(self, name=""):
        self.name_ = name

    def name(self):
        return self.name_


class QFont:
    Bold = 75
    Normal = 50

    def __init__(self, family="monospace", pointSize=10):
        self._family, self._size = family, pointSize

    def family(self):
        return self._family

    def setFamily(self, f):
        self._family = f

    def pointSize(self):
        return self._size

    def setPointSize(self, s):
        self._size = int(s)


class QTextCharFormat:
    def __init__(self):
        self.foreground = None
        self.weight = QFont.Normal
        self.italic = False

    def setForeground(self, color):
        self.foreground = color

    def setFontWeight(self, w):
        self.weight = w

    def setFontItalic(self, it):
        self.italic = it


class QIcon:
    def __init__(self, path=""):
        self.path = path


class QTextDocument:
    def __init__(self, owner=None):
        self._owner = owner
        self.highlighter = None

    def text(self):
        return self._owner.toPlainText() if self._owner else ""


class QSyntaxHighlighter:
    """Highlighter base: `rehighlight` runs highlightBlock per line and
    records the (start, length, fmt) spans for inspection."""

    def __init__(self, document):
        self._doc = document
        if document is not None:
            document.highlighter = self
        self._prev_state = -1
        self._cur_state = -1
        self.spans = []          # list per block of (start, len, fmt)
        self._block_spans = []

    def setFormat(self, start, length, fmt):
        self._block_spans.append((start, length, fmt))

    def setCurrentBlockState(self, s):
        self._cur_state = s

    def currentBlockState(self):
        return self._cur_state

    def previousBlockState(self):
        return self._prev_state

    def rehighlight(self):
        self.spans = []
        self._prev_state = -1
        for line in self._doc.text().split("\n"):
            self._block_spans = []
            self._cur_state = -1
            self.highlightBlock(line)
            self.spans.append(list(self._block_spans))
            self._prev_state = self._cur_state

    def highlightBlock(self, text):  # pragma: no cover - overridden
        raise NotImplementedError


class QTextCursor:
    def __init__(self, pos=0):
        self._pos = pos

    def position(self):
        return self._pos


class QtGui:
    QColor = QColor
    QFont = QFont
    QTextCharFormat = QTextCharFormat
    QIcon = QIcon
    QSyntaxHighlighter = QSyntaxHighlighter
    QTextCursor = QTextCursor
    QTextDocument = QTextDocument


# ------------------------------------------------------------------ QtWidgets
class QWidget:
    def __init__(self, parent=None):
        self.parent_ = parent
        self._layout = None
        self._title = ""
        self._visible = False
        self._tooltip = ""
        self._flags = 0
        self._font = QFont()

    def setLayout(self, lay):
        self._layout = lay

    def layout(self):
        return self._layout

    def setWindowTitle(self, t):
        self._title = t

    def windowTitle(self):
        return self._title

    def show(self):
        self._visible = True

    def close(self):
        self._visible = False
        return True

    def isVisible(self):
        return self._visible

    def setToolTip(self, t):
        self._tooltip = t

    def toolTip(self):
        return self._tooltip

    def windowFlags(self):
        return self._flags

    def setWindowFlags(self, f):
        self._flags = f

    def font(self):
        return self._font

    def setFont(self, f):
        self._font = f

    def setMinimumWidth(self, w):
        pass

    def setMinimumHeight(self, h):
        pass

    def setEnabled(self, e):
        self._enabled = e


class QDialog(QWidget):
    Accepted, Rejected = 1, 0

    def __init__(self, parent=None):
        super().__init__(parent)
        self._result = QDialog.Rejected

    def exec_(self):
        # headless: the dialog's logic is driven programmatically by tests
        self.show()
        return self._result

    exec = exec_

    def accept(self):
        self._result = QDialog.Accepted
        self.close()

    def reject(self):
        self._result = QDialog.Rejected
        self.close()


class QLabel(QWidget):
    def __init__(self, text="", parent=None):
        super().__init__(parent)
        self._text = text

    def setText(self, t):
        self._text = t

    def text(self):
        return self._text


class QFrame(QWidget):
    HLine = 4
    VLine = 5
    Sunken = 0x30

    def setFrameShape(self, s):
        self._shape = s

    def setFrameShadow(self, s):
        self._shadow = s


class QPushButton(QWidget):
    def __init__(self, text="", parent=None):
        super().__init__(parent)
        self._text = text
        self.clicked = Signal()

    def click(self):
        self.clicked.emit()

    def text(self):
        return self._text


class QCheckBox(QWidget):
    def __init__(self, text="", parent=None):
        super().__init__(parent)
        self._text = text
        self._checked = False
        self.stateChanged = Signal()
        self.toggled = Signal()

    def setChecked(self, v):
        changed = bool(v) != self._checked
        self._checked = bool(v)
        if changed:
            self.stateChanged.emit(_Qt.Checked if v else _Qt.Unchecked)
            self.toggled.emit(self._checked)

    def isChecked(self):
        return self._checked


class QLineEdit(QWidget):
    def __init__(self, text="", parent=None):
        super().__init__(parent)
        self._text = str(text)
        self.textChanged = Signal()
        self.editingFinished = Signal()

    def setText(self, t):
        self._text = str(t)
        self.textChanged.emit(self._text)

    def text(self):
        return self._text


class QComboBox(QWidget):
    def __init__(self, parent=None):
        super().__init__(parent)
        self._items = []
        self._idx = -1
        self.currentIndexChanged = Signal()
        self.currentTextChanged = Signal()

    def addItem(self, t):
        self._items.append(t)
        if self._idx < 0:
            self._idx = 0

    def addItems(self, items):
        for t in items:
            self.addItem(t)

    def count(self):
        return len(self._items)

    def itemText(self, i):
        return self._items[i]

    def currentIndex(self):
        return self._idx

    def setCurrentIndex(self, i):
        if 0 <= i < len(self._items) and i != self._idx:
            self._idx = i
            self.currentIndexChanged.emit(i)
            self.currentTextChanged.emit(self._items[i])

    def currentText(self):
        return self._items[self._idx] if 0 <= self._idx < len(self._items) else ""

    def setCurrentText(self, t):
        if t not in self._items:
            self.addItem(t)
        self.setCurrentIndex(self._items.index(t))


class QFontComboBox(QComboBox):
    def __init__(self, parent=None):
        super().__init__(parent)
        self.addItems(["monospace", "sans-serif", "serif"])

    def currentFont(self):
        return QFont(self.currentText() or "monospace")


class QSpinBox(QWidget):
    def __init__(self, parent=None):
        super().__init__(parent)
        self._min, self._max, self._val = 0, 99, 0
        self.valueChanged = Signal()

    def setRange(self, lo, hi):
        self._min, self._max = lo, hi

    def setMinimum(self, lo):
        self._min = lo

    def setMaximum(self, hi):
        self._max = hi
        self._val = min(self._val, hi)

    def maximum(self):
        return self._max

    def setValue(self, v):
        v = min(max(self._cast(v), self._min), self._max)
        if v != self._val:
            self._val = v
            self.valueChanged.emit(v)

    def value(self):
        return self._val

    def setSingleStep(self, s):
        self._step = s

    _cast = staticmethod(int)


class QDoubleSpinBox(QSpinBox):
    _cast = staticmethod(float)

    def __init__(self, parent=None):
        super().__init__(parent)
        self._min, self._max, self._val = 0.0, 99.0, 0.0

    def setDecimals(self, d):
        self._decimals = d


class QSlider(QWidget):
    def __init__(self, orientation=0x1, parent=None):
        super().__init__(parent)
        self._min, self._max, self._val = 0, 99, 0
        self.valueChanged = Signal()

    def setRange(self, lo, hi):
        self._min, self._max = lo, hi

    def setValue(self, v):
        v = min(max(int(v), self._min), self._max)
        if v != self._val:
            self._val = v
            self.valueChanged.emit(v)

    def value(self):
        return self._val


class QPlainTextEdit(QWidget):
    def __init__(self, parent=None):
        super().__init__(parent)
        self._text = ""
        self._readonly = False
        self._cursor = 0
        self._tab_width = 80
        self._doc = QTextDocument(self)
        self.textChanged = Signal()
        self.cursorPositionChanged = Signal()

    def setPlainText(self, t):
        self._text = t
        self._cursor = min(self._cursor, len(t))
        self.textChanged.emit()
        if self._doc.highlighter is not None:
            self._doc.highlighter.rehighlight()

    def toPlainText(self):
        return self._text

    def appendPlainText(self, t):
        self._text += ("\n" if self._text else "") + t
        self.textChanged.emit()

    def setReadOnly(self, ro):
        self._readonly = ro

    def document(self):
        return self._doc

    def textCursor(self):
        return QTextCursor(self._cursor)

    def set_cursor_position(self, pos):
        """Test hook (real Qt: QTextCursor.setPosition + setTextCursor)."""
        self._cursor = min(max(0, pos), len(self._text))
        self.cursorPositionChanged.emit()

    def setTabStopWidth(self, w):
        self._tab_width = w

    def tabStopWidth(self):
        return self._tab_width


class QTextBrowser(QPlainTextEdit):
    def __init__(self, parent=None):
        super().__init__(parent)
        self._html = ""
        self.anchorClicked = Signal()

    def setHtml(self, h):
        self._html = h
        self._text = re.sub(r"<[^>]+>", "", h)
        self.textChanged.emit()

    def toHtml(self):
        return self._html

    def setOpenLinks(self, v):
        pass


class QTreeWidgetItem:
    def __init__(self, strings=()):
        self._texts = list(strings)
        self._data = {}
        self._children = []
        self._icon = None

    def setData(self, col, role, value):
        self._data[(col, role)] = value

    def data(self, col, role):
        return self._data.get((col, role))

    def setIcon(self, col, icon):
        self._icon = icon

    def addChild(self, item):
        self._children.append(item)

    def child(self, i):
        return self._children[i]

    def childCount(self):
        return len(self._children)

    def text(self, col):
        return self._texts[col] if col < len(self._texts) else ""


class QTreeWidget(QWidget):
    def __init__(self, parent=None):
        super().__init__(parent)
        self._items = []
        self.itemDoubleClicked = Signal()
        self.itemClicked = Signal()

    def setHeaderLabels(self, labels):
        self._headers = list(labels)

    def addTopLevelItem(self, item):
        self._items.append(item)

    def topLevelItem(self, i):
        return self._items[i]

    def topLevelItemCount(self):
        return len(self._items)

    def setIconSize(self, size):
        pass

    def expandAll(self):
        pass


class QSplitter(QWidget):
    def __init__(self, parent=None):
        super().__init__(parent)
        self._widgets = []

    def addWidget(self, w):
        self._widgets.append(w)

    def setOrientation(self, o):
        self._orientation = o

    def setSizes(self, sizes):
        self._sizes = sizes


class QTabWidget(QWidget):
    def __init__(self, parent=None):
        super().__init__(parent)
        self._tabs = []          # (widget, label)
        self._current = -1
        self.tabCloseRequested = Signal()
        self.currentChanged = Signal()

    def addTab(self, w, label):
        self._tabs.append((w, label))
        if self._current < 0:
            self._current = 0
        return len(self._tabs) - 1

    def removeTab(self, i):
        if 0 <= i < len(self._tabs):
            del self._tabs[i]
            self._current = min(self._current, len(self._tabs) - 1)

    def setTabsClosable(self, v):
        pass

    def count(self):
        return len(self._tabs)

    def widget(self, i):
        return self._tabs[i][0]

    def tabText(self, i):
        return self._tabs[i][1]

    def setCurrentWidget(self, w):
        for i, (wd, _) in enumerate(self._tabs):
            if wd is w:
                self._current = i
                self.currentChanged.emit(i)

    def setCurrentIndex(self, i):
        self._current = i

    def currentIndex(self):
        return self._current

    def currentWidget(self):
        return self._tabs[self._current][0] if self._tabs else None


class QMainWindow(QWidget):
    def __init__(self, parent=None):
        super().__init__(parent)
        self._central = None

    def setCentralWidget(self, w):
        self._central = w

    def centralWidget(self):
        return self._central


class QFileDialog:
    # tests monkeypatch these staticmethods to drive the dialogs
    @staticmethod
    def getOpenFileName(parent=None, caption="", directory="", filter=""):  # noqa: A002
        return "", ""

    @staticmethod
    def getSaveFileName(parent=None, caption="", directory="", filter=""):  # noqa: A002
        return "", ""


class QMessageBox:
    Ok, Cancel = 0x400, 0x400000

    @staticmethod
    def information(parent, title, text, *a):
        return QMessageBox.Ok

    @staticmethod
    def warning(parent, title, text, *a):
        return QMessageBox.Ok


class _Layout:
    def __init__(self, parent=None):
        self.items = []
        if parent is not None and hasattr(parent, "setLayout"):
            parent.setLayout(self)

    def addWidget(self, w, *args):
        self.items.append(w)

    def addLayout(self, lay, *args):
        self.items.append(lay)

    def addStretch(self, s=0):
        self.items.append(("stretch", s))

    def count(self):
        return len(self.items)

    def itemAt(self, i):
        return self.items[i]

    def widgets(self):
        """Test helper: flatten all widgets in this layout tree."""
        out = []
        for it in self.items:
            if isinstance(it, _Layout):
                out.extend(it.widgets())
            elif not isinstance(it, tuple):
                out.append(it)
        return out


class QHBoxLayout(_Layout):
    pass


class QVBoxLayout(_Layout):
    pass


class QGridLayout(_Layout):
    def __init__(self, parent=None):
        super().__init__(parent)
        self._rows = 1

    def addWidget(self, w, row=None, col=None, *span):
        self.items.append(w)
        if row is not None:
            self._rows = max(self._rows, row + 1)

    def addLayout(self, lay, row=None, col=None, *span):
        self.items.append(lay)
        if row is not None:
            self._rows = max(self._rows, row + 1)

    def rowCount(self):
        return self._rows


class QApplication(QWidget):
    _instance = None

    def __init__(self, argv=()):
        super().__init__()
        QApplication._instance = self
        self._argv = list(argv)
        self._app_name = "fibergen_tpu_torch"
        self.settings = QSettings()

    @classmethod
    def instance(cls):
        return cls._instance

    @staticmethod
    def processEvents():
        pass

    def setApplicationName(self, n):
        self._app_name = n

    def applicationName(self):
        return self._app_name

    def exec_(self):
        return 0

    exec = exec_


class QtWidgets:
    QWidget = QWidget
    QDialog = QDialog
    QLabel = QLabel
    QFrame = QFrame
    QPushButton = QPushButton
    QCheckBox = QCheckBox
    QLineEdit = QLineEdit
    QComboBox = QComboBox
    QFontComboBox = QFontComboBox
    QSpinBox = QSpinBox
    QDoubleSpinBox = QDoubleSpinBox
    QSlider = QSlider
    QPlainTextEdit = QPlainTextEdit
    QTextBrowser = QTextBrowser
    QTreeWidget = QTreeWidget
    QTreeWidgetItem = QTreeWidgetItem
    QSplitter = QSplitter
    QTabWidget = QTabWidget
    QMainWindow = QMainWindow
    QFileDialog = QFileDialog
    QMessageBox = QMessageBox
    QHBoxLayout = QHBoxLayout
    QVBoxLayout = QVBoxLayout
    QGridLayout = QGridLayout
    QApplication = QApplication
