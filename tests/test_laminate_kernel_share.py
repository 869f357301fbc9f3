"""The benchmark's reader of the dim-3 laminate's spans
(``fgbench/metrics/laminate_kernel_share.py``) on made-up profiles: the
share of ``fg.material.laminate.kernel`` among the ``fg.material.laminate.``
spans that begin in the window (100 where every batch took the kernel, 0
where the plain twin ran), and None without such spans or without a device
operation."""
import types

import pytest

from fgbench.harness import manifest
from fgbench.harness import trace as tr

US = 1_000
HOST = [(tr.WINDOW, 0, 1000), ("fg.run_batched", 10, 900),
        ("fg.material.laminate.plain", -20, -10),     # before the window
        ("fg.cg.step", 100, 300), ("fg.material.stress_diff", 110, 170),
        ("fg.material.laminate.kernel", 150, 160),
        ("fg.cg.step", 300, 500), ("fg.material.stress_diff", 310, 370),
        ("fg.material.laminate.kernel", 350, 360),
        ("fg.cg.step", 500, 700), ("fg.material.stress_diff", 510, 570),
        ("fg.material.laminate.kernel", 550, 560)]
DEVICE = [("void {anonymous}::laminate_heat_kernel<float, 0>(...)",
           150, 400)]


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
    return manifest.plugin("metrics", "laminate_kernel_share").read(run)


@pytest.mark.parametrize("case,want", [
    ("every batch through the kernel", 100.0),
    ("no laminate span", None),
    ("no device operation", None),
    ("the plain twin alone", 0.0),
    ("one batch of three on the twin", 100.0 * 2 / 3),
])
def test_laminate_kernel_share(case, want):
    host, device = HOST, DEVICE
    if case == "no laminate span":
        host = [h for h in HOST if not h[0].startswith("fg.material.lam")]
    elif case == "no device operation":
        device = []
    elif case == "the plain twin alone":
        host = [(n.replace("kernel", "plain") if n.startswith(
            "fg.material.lam") else n, a, b) for n, a, b in HOST]
    elif case == "one batch of three on the twin":
        host = [("fg.material.laminate.plain", a, b)
                if (n, a) == ("fg.material.laminate.kernel", 350) else
                (n, a, b) for n, a, b in HOST]
    got = _read(host, device)
    assert got == (None if want is None else pytest.approx(want))


def test_no_trace_reads_nothing():
    run = types.SimpleNamespace(trace=None, requests=[], cases_done=1)
    assert manifest.plugin("metrics", "laminate_kernel_share").read(run) \
        is None
