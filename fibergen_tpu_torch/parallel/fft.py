"""Which field shardings take the slab path, and the slab layout itself.

Counterpart of slab_reject_reason / slab_fft_for in
fibergen_tpu/parallel/fft.py, with the same refusals and wording, so that
a caller sees the same ``SolverError``.  The JAX package's ``SlabFFT``
transforms through a y-split hat field; the port's chains run on kz-slabs
instead (``ops/spectral_kernels.py``), so :class:`SlabPar` only names the
mesh and the two splits:

  real field      (ncomp, nx, ny, nz)      x-slabs of nx/D planes
  spectrum        (ncomp, nx, ny, nz//2+1) kz-slabs of :meth:`SlabPar.kz_split`
"""
from __future__ import annotations


class SlabPar:
    """The x-slab layout of one solve over ``mesh`` (parallel.Mesh)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.n_devices = mesh.size
        self.devices = mesh.devices

    def kz_split(self, kz: int):
        """(offset, width) of each slab's kz columns: kz = nz//2+1 rarely
        divides the mesh, so the first kz % D slabs take one column more
        (a slab may take none when kz < D)."""
        d = self.n_devices
        base, extra = divmod(kz, d)
        out, off = [], 0
        for i in range(d):
            w = base + (i < extra)
            out.append((off, w))
            off += w
        return out


def slab_fft_for(sharding, grid):
    """The SlabPar of a solver's field sharding, or None when the layout does
    not qualify (no sharding, replicated, a non-x split, or extents that do
    not divide the mesh).  Unlike the JAX package, a one-device mesh takes
    the slab path too: its single slab wraps its own halo."""
    if sharding is None or slab_reject_reason(sharding, grid) is not None:
        return None
    return SlabPar(sharding.mesh)


def slab_reject_reason(sharding, grid):
    """Why a field sharding does NOT get the slab path (None when it does).
    Solvers use this to refuse loudly instead of solving replicated."""
    from . import NamedSharding
    if sharding is None:
        return "no sharding given"
    if not isinstance(sharding, NamedSharding):
        return f"sharding is {type(sharding).__name__}, not a NamedSharding"
    spec = tuple(sharding.spec) + (None,) * (4 - len(sharding.spec))
    shown = f"PartitionSpec({', '.join(map(repr, sharding.spec))})"
    if spec[0] is not None or spec[2] is not None or spec[3] is not None:
        return (f"field spec {shown} splits a non-x axis; the slab "
                "decomposition requires P(None, <mesh axis>, None, None)")
    axis = spec[1]
    if axis is None:
        return (f"field spec {shown} is replicated (no axis split); "
                "use P(None, <mesh axis>, None, None)")
    if isinstance(axis, tuple):
        return f"field spec splits x over multiple mesh axes {axis}"
    d = sharding.mesh.shape.get(axis, 0)
    if d == 0:
        return f"field spec names axis {axis!r}, which the mesh does not have"
    if d <= 1:
        return None
    bad = []
    if grid.nx % d != 0:
        bad.append(f"nx={grid.nx}")
    if grid.ny % d != 0:
        bad.append(f"ny={grid.ny}")
    if bad:
        return (f"{' and '.join(bad)} not divisible by the {d}-device mesh "
                "(the all-to-all slab transpose needs equal chunks); pad the "
                f"grid to a multiple of {d}")
    return None
