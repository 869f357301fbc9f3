"""chain_roofline (%, device trace): the bytes the window's chain
applications must move at least, over the peak bandwidth, as a share of
the device time of the chains' passes.

Applications: ``spectral_kernels.calls`` over the window, by (wrapper,
components); each wrapper's bytes from ``fgbench/counts/<wrapper>.py``
where it has a count of its own, else from ``fgbench/counts/chain.py``
(a batched wrapper's batch is the request's load cases).  Time: the
kernels named as a chain pass (z_fwd, y_line, x_apply, z_inv)."""
from fgbench.harness import trace as tracemod


def read(run):
    tr, peaks = run.trace, run.peaks
    if tr is None or peaks is None or not run.calls:
        return None
    total = 0.0
    for (name, comps), n in run.calls.items():
        count = run.count(name) or run.count("chain")
        total += n * count.bytes_moved({
            "components": comps, "voxels": run.voxels,
            "itemsize": run.itemsize,
            "batch": run.batch if name.endswith("_batched") else 1})
    seconds = tr.kernel_seconds(tracemod.is_chain_pass)
    if seconds <= 0:
        return None
    return 100.0 * total / peaks["hbm_bytes_per_s"] / seconds
