"""The benchmark's reader of the CG update's spans
(``fgbench/metrics/cg_update_kernel_share.py``) on made-up profiles: the
share of ``fg.cg.update.kernel`` among the ``fg.cg.update.`` spans that
begin in the window, and None without such spans or without a device
operation."""
import types

import pytest

from fgbench.harness import manifest
from fgbench.harness import trace as tr

US = 1_000
HOST = [(tr.WINDOW, 0, 1000), ("fg.run", 10, 900),
        ("fg.cg.update.kernel", -20, -10),          # before the window
        ("fg.cg.step", 100, 300), ("fg.cg.update.kernel", 150, 160),
        ("fg.cg.step", 300, 500), ("fg.cg.update.kernel", 350, 360),
        ("fg.cg.update.kernel", 370, 380),
        ("fg.cg.step", 500, 700), ("fg.cg.update.plain", 550, 600)]
DEVICE = [("void cg_update_kernel<float, 6>(float*)", 150, 400)]


class Ev:
    """A profiler event: name, host or device, start and end in ns."""

    def __init__(self, name, t0, t1, dev):
        self._n, self._t0, self._t1, self._dev = name, t0, t1, dev

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType.CUDA" if self._dev else "DeviceType.CPU"

    def start_ns(self):
        return self._t0

    def duration_ns(self):
        return self._t1 - self._t0


def _read(host, device):
    t = tr.Trace([Ev(n, a * US, b * US, False) for n, a, b in host]
                 + [Ev(n, a * US, b * US, True) for n, a, b in device])
    run = types.SimpleNamespace(trace=t, requests=[], cases_done=1)
    return manifest.plugin("metrics", "cg_update_kernel_share").read(run)


@pytest.mark.parametrize("case,want", [
    ("three kernel spans of four in the window", 75.0),
    ("no update span", None),
    ("no device operation", None),
    ("the plain twin alone", 0.0),
])
def test_cg_update_kernel_share(case, want):
    host, device = HOST, DEVICE
    if case == "no update span":
        host = [h for h in HOST if not h[0].startswith("fg.cg.update.")]
    elif case == "no device operation":
        device = []
    elif case == "the plain twin alone":
        host = [h for h in HOST if h[0] != "fg.cg.update.kernel"]
    got = _read(host, device)
    assert got == (None if want is None else pytest.approx(want))


def test_no_trace_reads_nothing():
    run = types.SimpleNamespace(trace=None, requests=[], cases_done=1)
    assert manifest.plugin("metrics", "cg_update_kernel_share").read(run) \
        is None
