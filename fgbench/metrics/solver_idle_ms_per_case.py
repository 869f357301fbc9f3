"""solver_idle_ms_per_case (ms, program span): the device's idle gaps of
at least 20 us in the traced window (the complement of the union of
device operations), the part of each during which the port's ``fg.run``,
``fg.run_batched`` or ``fg.mean_stress`` span is open, summed over the
window, over the cases done.  None without a traced device operation or
without the program's spans."""
from fgbench.harness import spans


def read(run):
    tr = run.trace
    if tr is None or tr.n_device_ops == 0 or not run.cases_done:
        return None
    if not any(n in spans.ENTRIES for _, _, n in spans.program_spans(tr)):
        return None
    return 1e-6 * sum(spans.idle_under_spans(tr).values()) / run.cases_done
