"""case_p95_s (s, host clock): the 95th percentile of the latency of every
request in the window, each from its call to its synchronised return with
the mean stress (numpy's linear interpolation between order statistics).
Listed for the cells whose request is one load case."""
import numpy as np


def read(run):
    return float(np.percentile([r.latency_s for r in run.requests], 95))
