"""stencil_roofline (%, device trace): the bytes the window's K1 and K2
launches must move at least, over the peak bandwidth, as a share of their
device time (their fixed-order sums, sum_partials, included).

Each launch of the trace is counted by ``fgbench/counts/<kernel>.py`` from
the kernel's name, whose template arguments give its mode."""
import re

KERNELS = ("stress_div_beta_kernel", "eps_from_u_kernel")
HELPERS = ("sum_partials",)


def read(run):
    tr, peaks = run.trace, run.peaks
    if tr is None or peaks is None:
        return None
    total, seconds = 0.0, 0.0
    for name, dt in tr.kernel_events():
        base = next((k for k in KERNELS if re.search(rf"\b{k}<", name)),
                    None)
        if base is not None:
            total += run.count(base).bytes_moved(
                {"kernel": name, "voxels": run.voxels})
            seconds += dt
        elif any(h in name for h in HELPERS):
            seconds += dt
    if total <= 0 or seconds <= 0:
        return None
    return 100.0 * total / peaks["hbm_bytes_per_s"] / seconds
