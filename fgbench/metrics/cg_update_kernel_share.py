"""cg_update_kernel_share (%, program span): 100 times the
``fg.cg.update.kernel`` spans over the ``fg.cg.update.`` spans that begin
in the traced window: the share of the CG's vector updates (one a case and
step) that took the port's fused kernel and not its plain twin.  None
without such spans (a program that does not mark its updates) or without
a device operation in the trace (no kernel could have run)."""
from fgbench.harness import spans

UPDATE = "fg.cg.update."
KERNEL = "fg.cg.update.kernel"


def read(run):
    tr = run.trace
    if tr is None or tr.n_device_ops == 0:
        return None
    total = spans.count(tr, UPDATE)
    if total == 0:
        return None
    return 100.0 * spans.count(tr, KERNEL) / total
