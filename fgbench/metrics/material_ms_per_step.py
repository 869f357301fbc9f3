"""material_ms_per_step (ms, device trace): the device time of the
kernels launched inside the port's ``fg.material.`` spans (each field's
stress difference, ``solvers/ls.py``; the laminate's jump in
``materials/laminate.py``), each kernel paired with its launch call
(``harness/launches.py``), over the window's chain applications.  None
without such spans or where launches and kernels do not pair up."""
from fgbench.harness import launches


def read(run):
    return launches.ms_per_step(run, "fg.material.")
