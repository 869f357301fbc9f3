"""The trace reduction on a made-up profile: the union of device
intervals, the idle gaps named by the harness's span and the host
operation open, and the kinds of events and kernels by their names."""
import pytest

from fgbench.harness import trace as tr


class Ev:
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


def _events():
    return [
        Ev(tr.WINDOW, 0, 1_000_000, False),
        Ev(f"{tr.REQUEST} run (0,)", 10, 990_000, False),
        Ev(f"{tr.REQUEST} run (0,)", 10, 990_000, True),
        Ev("aten::item", 400_000, 700_000, False),
        Ev("void z_fwd_reg<float>(float const*)", 100_000, 300_000, True),
        Ev("void at::vectorized_elementwise_kernel<4>(int)", 250_000,
           400_000, True),
        Ev("Memcpy DtoH (Device -> Pinned)", 700_000, 710_000, True),
        Ev("void stress_div_beta_kernel<float, true, false>(float*)",
           900_000, 950_000, True),
    ]


def test_busy_idle_and_kinds():
    t = tr.Trace(_events())
    assert t.window_s == pytest.approx(1e-3)
    # busy: [100, 400] + [700, 710] + [900, 950] us
    assert t.busy_s == pytest.approx(360e-6)
    assert t.kernel_seconds(tr.is_chain_pass) == pytest.approx(200e-6)
    plain = t.kernel_seconds(lambda n: tr.kind_of(n) != "port kernels")
    assert plain == pytest.approx(150e-6)
    gaps = dict(t.idle_gaps())
    assert gaps[f"{tr.REQUEST} run (0,) > aten::item"] == pytest.approx(
        300e-6)
    assert sum(gaps.values()) == pytest.approx(1e-3 - 360e-6)
    ops = dict(t.top_device_ops())
    assert ops["z_fwd_reg<float>"] == pytest.approx(200e-6)


def test_kernel_names_are_shortened():
    assert tr.short("void ns::k<float, true>(float const*, int)") == \
        "ns::k<float, true>"
    assert tr.kind_of("void (anonymous namespace)::eps_from_u_kernel<float, "
                      "true, false>(...)") == "port kernels"
