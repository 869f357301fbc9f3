"""The program's own spans in a traced window, and the device's idle time
under them.

The port marks its solver with host-scope spans named ``fg.*``
(``fibergen_tpu_torch/utils/logging.py`` ``span``, listed in
``solvers/ls.py``): ``fg.run``, ``fg.run_batched`` and ``fg.mean_stress``
over the entries, ``fg.cg.init``, ``fg.cg.step`` and ``fg.cg.test`` inside
them, and ``fg.sync.<why>`` over every point where the host waits for the
device.  They are host events of the one profile (``trace.Trace``'s
``host_*``), on the clock of the device's activities, and nest by time on
the solver's thread.  A program without them (an older checkout) gives no
span, and the readers then return None.
"""
from __future__ import annotations

import numpy as np

from fgbench.harness.trace import NAMED_GAP_NS

PREFIX = "fg."
SYNC = "fg.sync."
STEP = "fg.cg.step"
ENTRIES = ("fg.run", "fg.run_batched", "fg.mean_stress")


def program_spans(tr):
    """(start, end, name) of the program's spans that begin in the
    window, by start, clipped to the window's end."""
    lo, hi = tr.window
    return [(int(s), min(int(e), hi), n)
            for s, e, n in zip(tr.host_start, tr.host_end, tr.host_name)
            if n.startswith(PREFIX) and lo <= s < hi]


def count(tr, prefix: str) -> int:
    """The program's spans in the window whose name starts with
    ``prefix``."""
    return sum(n.startswith(prefix) for _, _, n in program_spans(tr))


def idle_gaps(tr, min_ns: int = NAMED_GAP_NS):
    """(start, end) of the device's idle gaps in the window of at least
    ``min_ns``: the complement of the union of device operations, as
    ``device_idle_share`` reads it; shorter gaps are the device's own
    spacing between queued work."""
    starts, ends = tr._busy_runs()
    lo, hi = tr.window
    gap_s = np.concatenate([[lo], ends])
    gap_e = np.concatenate([starts, [hi]])
    keep = gap_e - gap_s >= min_ns
    return list(zip(gap_s[keep].tolist(), gap_e[keep].tolist()))


def innermost(spans):
    """The time the nested ``spans`` (by start) cover, as segments (start,
    end, the innermost span's name, whether an entry span is open)."""
    out = []
    stack = []          # (end, name, an entry open) of the open spans
    cursor = 0

    def pop():
        nonlocal cursor
        end, name, entry = stack.pop()
        if end > cursor:
            out.append((cursor, end, name, entry))
            cursor = end

    for s, e, name in spans:
        while stack and stack[-1][0] <= s:
            pop()
        if stack and s > cursor:
            out.append((cursor, s) + stack[-1][1:])
        cursor = max(cursor, s)
        if stack:                # a child ends with its parent at the latest
            e = min(e, stack[-1][0])
        stack.append((e, name, name in ENTRIES
                      or bool(stack and stack[-1][2])))
    while stack:
        pop()
    return out


def idle_pieces(tr):
    """(start, end, innermost span's name) of each stretch of the
    device's idle gaps of at least 20 us in the window during which an
    entry span is open, in order."""
    segs = [s for s in innermost(program_spans(tr)) if s[3]]
    i = 0
    for g0, g1 in idle_gaps(tr):
        while i < len(segs) and segs[i][1] <= g0:
            i += 1
        j = i
        while j < len(segs) and segs[j][0] < g1:
            s0, s1, name, _ = segs[j]
            a, b = max(s0, g0), min(s1, g1)
            if b > a:
                yield a, b, name
            j += 1


def idle_under_spans(tr):
    """ns of device idle (gaps of at least 20 us) in the window that fall
    while an entry span is open, by the innermost program span open over
    them: {name: ns}."""
    out: dict = {}
    for a, b, name in idle_pieces(tr):
        out[name] = out.get(name, 0) + b - a
    return out
