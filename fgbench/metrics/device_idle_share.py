"""device_idle_share (%, device trace): 100 (1 - busy / window), busy the
union of the device operations' intervals (kernels, copies, sets) within
the traced window, both from the one profile; None without a traced
device operation."""


def read(run):
    tr = run.trace
    if tr is None or tr.n_device_ops == 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
