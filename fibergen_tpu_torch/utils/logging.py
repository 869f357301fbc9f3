"""Logger and named-scope timing registry.

Port of fibergen_tpu/utils/logging.py: the reference's Logger singleton
(ANSI colour, indent stack, tee to a file; fibergen.cpp:262-372) and its
RAII Timer with per-name statistics (fibergen.cpp:1643-1810, printed by the
``print_timings`` action).  Set ``LOG.enabled = False`` to quiet the
per-iteration log.  The logger writes to the ``sys.stdout`` of the moment
it writes, unless ``stream`` names another.
"""
from __future__ import annotations

import sys
import time
from contextlib import contextmanager


class Logger:
    def __init__(self):
        self.indent = 0
        self.stream = None          # None: sys.stdout at each write
        self.tee = None
        self.enabled = True

    def set_log_file(self, path):
        """Tee every message to ``path`` (appended); a false path stops."""
        if self.tee:
            self.tee.close()
            self.tee = None
        if path:
            self.tee = open(path, "a")

    def _emit(self, msg, color=None):
        if not self.enabled:
            return
        text = "  " * self.indent + str(msg)
        stream = self.stream or sys.stdout
        if color and stream.isatty():
            print(f"\033[{color}m{text}\033[0m", file=stream)
        else:
            print(text, file=stream)
        if self.tee:
            print(text, file=self.tee)
            self.tee.flush()

    def info(self, msg):
        self._emit(msg)

    def warn(self, msg):
        self._emit("WARNING: " + str(msg), color="33")

    def error(self, msg):
        self._emit("ERROR: " + str(msg), color="31")

    @contextmanager
    def indented(self):
        self.indent += 1
        try:
            yield
        finally:
            self.indent -= 1


LOG = Logger()


class TimerRegistry:
    """Name -> (calls, total seconds) (Timer::print_stats,
    fibergen.cpp:1743-1804)."""

    def __init__(self):
        self.stats = {}

    def record(self, name, dt):
        calls, total = self.stats.get(name, (0, 0.0))
        self.stats[name] = (calls + 1, total + dt)

    def reset(self):
        self.stats.clear()

    def report(self) -> str:
        if not self.stats:
            return "no timings recorded"
        grand = sum(t for _, t in self.stats.values())
        lines = [f"{'name':40s} {'calls':>8s} {'total[s]':>12s} {'rel%':>7s}"]
        for name, (calls, total) in sorted(
                self.stats.items(), key=lambda kv: -kv[1][1]):
            lines.append(f"{name:40s} {calls:8d} {total:12.4f} "
                         f"{100 * total / max(grand, 1e-30):6.1f}%")
        return "\n".join(lines)


TIMINGS = TimerRegistry()


@contextmanager
def timer(name, log=False):
    """Scope timer recording into :data:`TIMINGS` (host wall time)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        TIMINGS.record(name, dt)
        if log:
            LOG.info(f"{name}: {dt:.3f}s")


class ProgressBar:
    """Console progress bar (ProgressBar, fibergen.cpp:1579-1641): drawn on
    a terminal only, redrawn when the percentage changes."""

    def __init__(self, total: int = 100, width: int = 40, text: str = ""):
        self.total = max(1, int(total))
        self.width = width
        self.text = text
        self._last = -1
        self._enabled = LOG.enabled and sys.stderr.isatty()

    def update(self, i: int):
        pct = int(100 * i / self.total)
        if not self._enabled or pct == self._last:
            return
        self._last = pct
        filled = self.width * i // self.total
        bar = "#" * filled + "-" * (self.width - filled)
        sys.stderr.write(f"\r{self.text}[{bar}] {pct:3d}%")
        sys.stderr.flush()

    def complete(self):
        if self._enabled:
            self.update(self.total)
            sys.stderr.write("\n")
            sys.stderr.flush()
