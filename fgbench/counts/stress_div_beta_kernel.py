"""Bytes one launch of K1 (``stress_div_beta_kernel<T, STEP, TAU_SUM>``)
must move, values a voxel as PERF.md's kernel table bounds them: the step
reads r and p_prev (6 each), mu and lam, and writes f (3) and p (6): 23;
the init reads r, mu and lam and writes f: 11.  The tau sum's partials are
a few values a block, left out."""
import re

ITEMSIZE = {"float": 4, "double": 8}


def bytes_moved(app):
    t, step, _ = re.search(r"stress_div_beta_kernel<([^>]*)>",
                           app["kernel"]).group(1).replace(" ", "").split(",")
    return (23 if step == "true" else 11) * app["voxels"] * ITEMSIZE[t]
