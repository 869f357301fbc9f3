"""host_syncs_per_case (syncs, program span): the port's ``fg.sync.*``
spans that begin in the traced window, each one point where the solver's
host thread waits for the device (a chunk's residual read, the first
gamma, an upload from pageable host memory, the closing synchronize, the
mean stress), over the cases done; None without the program's spans."""
from fgbench.harness import spans


def read(run):
    tr = run.trace
    if tr is None or not run.cases_done or spans.count(tr, spans.PREFIX) == 0:
        return None
    return spans.count(tr, spans.SYNC) / run.cases_done
