"""The modules a run may not load: JAX, its libraries and the JAX package
the port was made from.  Compared by whole top-level names, since the
port's own name, ``fibergen_tpu_torch``, begins with ``fibergen_tpu``."""
from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "fibergen_tpu")


def forbidden_loaded(modules=None) -> list:
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))
