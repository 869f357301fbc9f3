"""heat_stencil_ms_per_step (ms, device trace): the device time of the
kernels launched inside the port's ``fg.stencil.heat.`` spans (the plain
heat divergence and gradient of ``ops/staggered.py`` around K4,
``ops/gamma.py``), each kernel paired with its launch call
(``harness/launches.py``), over the window's chain applications.  None
without such spans or where launches and kernels do not pair up."""
from fgbench.harness import launches


def read(run):
    return launches.ms_per_step(run, "fg.stencil.heat.")
