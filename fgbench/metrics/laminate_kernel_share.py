"""laminate_kernel_share (%, program span): 100 times the
``fg.material.laminate.kernel`` spans over the ``fg.material.laminate.``
spans that begin in the traced window: the share of the dim-3 laminate's
stress differences (one a batched application or a case) that took the
port's kernel and not its plain twin.  None without such spans (a program
that does not mark them) or without a device operation in the trace (no
kernel could have run)."""
from fgbench.harness import spans

LAMINATE = "fg.material.laminate."
KERNEL = "fg.material.laminate.kernel"


def read(run):
    tr = run.trace
    if tr is None or tr.n_device_ops == 0:
        return None
    total = spans.count(tr, LAMINATE)
    if total == 0:
        return None
    return 100.0 * spans.count(tr, KERNEL) / total
