"""Each kernel of a traced window paired with the host call that launched
it, so that device time can be charged to the program's span that was
open on the host when the kernel was launched.

The trace's host events hold the runtime's launch calls
(``cudaLaunchKernel`` and its kin, ``cuLaunchKernel`` of the lower-level
API); the solver launches on one stream, where kernels run in the order
they were launched, so the i-th launch call by start is the i-th kernel
by start.  Where the counts differ (a kernel launched by a call the trace
does not hold, or another stream) nothing is paired and the readers
return None.
"""
from __future__ import annotations

import numpy as np

from fgbench.harness import spans

LAUNCH_CALLS = ("LaunchKernel", "LaunchCooperativeKernel")


def is_launch(name: str) -> bool:
    return any(k in name for k in LAUNCH_CALLS)


def launch_starts(tr) -> np.ndarray:
    """Host start (ns) of every kernel launch call in the trace, in
    order."""
    return np.array([s for s, n in zip(tr.host_start, tr.host_name)
                     if is_launch(n)], dtype=np.int64)


def _within(t, starts, ends):
    """Whether each time of ``t`` lies in one of the intervals (sorted by
    start, possibly nested or overlapping)."""
    if starts.size == 0:
        return np.zeros(t.shape, dtype=bool)
    reach = np.maximum.accumulate(ends)
    i = np.searchsorted(starts, t, side="right") - 1
    ok = i >= 0
    out = np.zeros(t.shape, dtype=bool)
    out[ok] = reach[i[ok]] > t[ok]
    return out


def kernel_seconds_under(tr, prefix: str):
    """Device seconds, within the window, of the kernels launched while a
    program span whose name starts with ``prefix`` was open; None where
    the launch calls and the kernels do not pair up one to one, or where
    the window holds no such span."""
    hit = [(s, e) for s, e, n in spans.program_spans(tr)
           if n.startswith(prefix)]
    if not hit:
        return None
    launches = launch_starts(tr)
    kernels = np.flatnonzero(tr.dev_kernel)
    if launches.size != kernels.size:
        return None
    s, e = tr._clipped()
    under = _within(launches, np.array([h[0] for h in hit], dtype=np.int64),
                    np.array([h[1] for h in hit], dtype=np.int64))
    k = kernels[under]
    return float(np.sum(e[k] - s[k])) * 1e-9


def ms_per_step(run, prefix: str):
    """1e3 times :func:`kernel_seconds_under` over the window's chain
    applications (``spectral_kernels.calls``: the CG steps plus one init a
    request, a batched application once), as ``plain_torch_ms_per_step``
    counts them; None without a traced device operation."""
    tr = run.trace
    steps = sum(run.calls.values())
    if tr is None or tr.n_device_ops == 0 or steps == 0:
        return None
    sec = kernel_seconds_under(tr, prefix)
    return None if sec is None else 1e3 * sec / steps
