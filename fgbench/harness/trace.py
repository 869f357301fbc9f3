"""The traced run: ``torch.profiler`` over the measured window, and its
reduction to device time by kernel, busy time, idle gaps and the
breakdown.

The harness opens a span of its own (``record_function``) around the
window and around each request, so the device's idle gaps can be named by
what the host was doing: the request's span and the innermost host
operation open when the gap began.  The profile is kept in memory.
"""
from __future__ import annotations

import contextlib
import re

import numpy as np

WINDOW = "fgbench.window"
REQUEST = "fgbench.request"
DEVICE_OPS = ("kernel", "gpu_memcpy", "gpu_memset")
NAMED_GAP_NS = 20_000        # gaps shorter than this are summed unnamed
CHAIN_PASSES = ("z_fwd", "z_inv", "y_line", "x_apply")


def kind_of(name: str) -> str:
    """The kind of a device kernel by its name (a copy of
    ``scripts/torch_profile_solve.py``'s ``kind_of``): the port's kernels,
    cuFFT, cuBLAS, cuSOLVER, and PyTorch's own kernels by family."""
    n = name.lower()
    for k in ("stress_div_beta", "eps_from_u", "sum_partials", "z_fwd",
              "z_inv", "y_line", "x_apply"):
        if k in n:
            return "port kernels"
    if "fft" in n:
        return "cuFFT"
    if "gemm" in n or "cutlass" in n:
        return "cuBLAS (einsum)"
    if any(k in n for k in ("sytrd", "stedc", "laed", "lansy", "lascl",
                            "steqr", "syev")):
        return "cuSOLVER eigvalsh"
    if "catarray" in n:
        return "torch.cat/stack"
    if "reduce" in n:
        return "torch reductions"
    if "elementwise" in n or "copy" in n or "fill" in n:
        return "torch elementwise"
    return "other"


def is_chain_pass(name: str) -> bool:
    return any(k in name for k in CHAIN_PASSES)


def short(name: str, limit: int = 160) -> str:
    """A kernel's name without its return type and argument list."""
    n = re.sub(r"^void ", "", name)
    depth, cut = 0, len(n)
    for i in range(len(n) - 1, -1, -1):      # the trailing "(...)" list
        if n[i] == ")":
            depth += 1
        elif n[i] == "(":
            depth -= 1
            if depth == 0:
                cut = i
                break
    n = n[:cut] if cut > 0 and n.endswith(")") else n
    return n[:limit]


class Capture:
    """Profiles the window when ``enabled``; otherwise every call is free."""

    def __init__(self, enabled: bool, device_type: str):
        self.enabled = enabled
        self._prof = None
        self._device_type = device_type

    def start(self):
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self._device_type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.start()

    def span(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function(name)

    def stop(self):
        """The trace of the window, or None."""
        if not self.enabled:
            return None
        self._prof.stop()
        return Trace(self._prof.profiler.kineto_results.events())


def _kind(e, name):
    """The event's kind, from its device and its name (the profiler's own
    ``activity_type()`` is missing from some versions of torch, 2.11 among
    them): a device event is a kernel unless kineto names it a copy or a
    set, or it is the device's side of a harness span or a synchronisation
    record."""
    if not str(e.device_type()).endswith("CUDA"):
        return "cpu_op"
    if name.startswith("fgbench.") or "Sync" in name:
        return "gpu_user_annotation"
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def _ns(e):
    s = int(e.start_ns())
    return s, s + int(e.duration_ns())


class Trace:
    """Device operations, host operations and the harness's spans of one
    profiled window, times in ns on the profiler's clock."""

    def __init__(self, events):
        dev, host = [], []
        self.window = None
        for e in events:
            name = e.name()
            kind = _kind(e, name)
            if kind in DEVICE_OPS:
                dev.append((*_ns(e), name, kind))
            elif kind == "cpu_op":
                t0, t1 = _ns(e)
                if name == WINDOW:
                    self.window = (t0, t1)
                host.append((t0, t1, name))
        dev.sort(key=lambda x: x[0])
        host.sort(key=lambda x: x[0])
        self.dev_start = np.array([d[0] for d in dev], dtype=np.int64)
        self.dev_end = np.array([d[1] for d in dev], dtype=np.int64)
        self.dev_name = [d[2] for d in dev]
        self.dev_kernel = np.array([d[3] == "kernel" for d in dev], dtype=bool)
        self.host_start = np.array([h[0] for h in host], dtype=np.int64)
        self.host_end = np.array([h[1] for h in host], dtype=np.int64)
        self.host_name = [h[2] for h in host]
        ours = [h for h in host if h[2].startswith("fgbench.")]
        self.span_start = np.array([h[0] for h in ours], dtype=np.int64)
        self.span_end = np.array([h[1] for h in ours], dtype=np.int64)
        self.span_name = [h[2] for h in ours]
        if self.window is None:
            raise RuntimeError("the profile holds no window span")

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def _clipped(self):
        lo, hi = self.window
        s = np.clip(self.dev_start, lo, hi)
        e = np.clip(self.dev_end, lo, hi)
        return s, e

    def _busy_runs(self):
        """The merged intervals in which some device operation ran."""
        s, e = self._clipped()
        if s.size == 0:
            return s, e
        reach = np.maximum.accumulate(e)
        new = np.ones(s.size, dtype=bool)
        new[1:] = s[1:] > reach[:-1]
        starts = s[new]
        idx = np.flatnonzero(new)
        ends = np.append(reach[idx[1:] - 1], reach[-1])
        return starts, ends

    @property
    def busy_s(self) -> float:
        starts, ends = self._busy_runs()
        return float(np.sum(ends - starts)) * 1e-9

    @property
    def n_device_ops(self) -> int:
        return int(self.dev_start.size)

    def kernel_seconds(self, pred) -> float:
        """Device seconds of the kernels whose name ``pred`` accepts."""
        s, e = self._clipped()
        tot = 0
        for i in np.flatnonzero(self.dev_kernel):
            if pred(self.dev_name[i]):
                tot += int(e[i] - s[i])
        return tot * 1e-9

    def kernel_events(self):
        """(name, seconds) of every kernel in the window."""
        s, e = self._clipped()
        return [(self.dev_name[i], (e[i] - s[i]) * 1e-9)
                for i in np.flatnonzero(self.dev_kernel)]

    def top_device_ops(self, k=10):
        s, e = self._clipped()
        by_name: dict = {}
        for i in range(s.size):
            n = self.dev_name[i]
            by_name[n] = by_name.get(n, 0) + int(e[i] - s[i])
        tot: dict = {}
        for n, v in by_name.items():
            tot[short(n)] = tot.get(short(n), 0) + v
        top = sorted(tot.items(), key=lambda x: -x[1])[:k]
        return [[n, v * 1e-9] for n, v in top]

    @staticmethod
    def _open_at(t, starts, ends, names, reach):
        """The innermost of the nested events (sorted by start) open at t:
        the latest-started one that has not ended, looked for among the
        ``reach`` events begun last."""
        i = int(np.searchsorted(starts, t, side="right")) - 1
        for j in range(i, max(-1, i - reach), -1):
            if ends[j] >= t:
                return names[j]
        return "none"

    def idle_gaps(self, k=10):
        """The device's idle time in the window by what the host was doing
        when each gap began (the harness's span > the innermost host
        operation), summed by that name; gaps under 20 us summed as one."""
        starts, ends = self._busy_runs()
        lo, hi = self.window
        gap_s = np.concatenate([[lo], ends])
        gap_e = np.concatenate([starts, [hi]])
        keep = gap_e > gap_s
        gap_s, gap_e = gap_s[keep], gap_e[keep]
        tot: dict = {}
        for g0, g1 in zip(gap_s, gap_e):
            d = int(g1 - g0)
            if d < NAMED_GAP_NS:
                name = "gaps under 20 us"
            else:
                span = self._open_at(g0, self.span_start, self.span_end,
                                     self.span_name, len(self.span_name))
                op = self._open_at(g0, self.host_start, self.host_end,
                                   self.host_name, 256)
                name = f"{span} > {op}"
            tot[name] = tot.get(name, 0) + d
        top = sorted(tot.items(), key=lambda x: -x[1])[:k]
        return [[n, v * 1e-9] for n, v in top]
