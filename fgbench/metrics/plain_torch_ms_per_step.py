"""plain_torch_ms_per_step (ms, device trace): device time of the kernels
that are not the port's (materials, vector ops, the plain heat stencils of
``ops/staggered.py``), by the copy of ``kind_of``, over the window's chain
applications (``spectral_kernels.calls``: the CG steps plus one init a
request; a batched application counts once)."""
from fgbench.harness import trace as tracemod


def read(run):
    tr = run.trace
    steps = sum(run.calls.values())
    if tr is None or tr.n_device_ops == 0 or steps == 0:
        return None
    s = tr.kernel_seconds(lambda n: tracemod.kind_of(n) != "port kernels")
    return 1e3 * s / steps
