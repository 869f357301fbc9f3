"""cg_step_useful_share (%, program span): 100 times the CG steps whose
residual the convergence test read before it stopped the solve (each
request's ``len(residuals)`` - 1; a batch's history once) over the
``fg.cg.step`` spans in the traced window (a batch step once): the rest
were launched in a chunk of ``check_every`` and discarded.  None without
the program's spans."""
from fgbench.harness import spans


def read(run):
    tr = run.trace
    if tr is None:
        return None
    steps = spans.count(tr, spans.STEP)
    if steps == 0:
        return None
    return 100.0 * sum(r.iterations - 1 for r in run.requests) / steps
