"""Which field shardings take the slab path, the slab layout itself and
the plain slab transforms.

Counterpart of slab_reject_reason / slab_fft_for / SlabFFT in
fibergen_tpu/parallel/fft.py, with the same refusals and wording, so that
a caller sees the same ``SolverError``.  The JAX package's ``SlabFFT``
transforms through a y-split hat field; the port's chains run on kz-slabs
instead (``ops/spectral_kernels.py``), so :class:`SlabPar` names the mesh
and the two splits:

  real field      (ncomp, nx, ny, nz)      x-slabs of nx/D planes
  spectrum        (ncomp, nx, ny, nz//2+1) kz-slabs of :meth:`SlabPar.kz_split`

:func:`slab_rfftn` / :func:`slab_irfftn` are the plain (``torch.fft``)
transforms between the two, the ones the operators without a chain run
(``ops/green.slab_transformed``); :class:`SlabFFT` offers them as the JAX
package's four transforms.
"""
from __future__ import annotations

import torch

from . import comm


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


def slab_rfftn(par, f):
    """The spectrum (norm="forward") of the x-slabs ``f`` as kz-slabs:
    ``rfft`` along z on each x-slab, the exchange (:func:`comm.to_kz`),
    ``fft`` along y and x there.  A kz-slab of width 0 is None."""
    nzc = f[0].shape[-1] // 2 + 1
    spec = [torch.fft.rfft(x, dim=-1, norm="forward") for x in f]
    kzs = comm.to_kz(spec, par.kz_split(nzc), par.devices)
    return [None if y is None else torch.fft.fft(
        torch.fft.fft(y, dim=-2, norm="forward"), dim=-3, norm="forward")
        for y in kzs]


def slab_irfftn(par, kzs, nz):
    """The inverse of :func:`slab_rfftn`: x-slabs of z extent ``nz``."""
    kzs = [None if y is None else torch.fft.ifft(
        torch.fft.ifft(y, dim=-3, norm="forward"), dim=-2, norm="forward")
        for y in kzs]
    nx = next(y for y in kzs if y is not None).shape[-3]
    spec = comm.from_kz(kzs, nx // par.n_devices, par.devices)
    return [torch.fft.irfft(y, n=nz, dim=-1, norm="forward") for y in spec]


class SlabFFT:
    """R2C/C2R 3-D FFTs (norm="forward") of x-slab fields over ``mesh``
    (a ``parallel.Mesh``), the counterpart of the JAX package's SlabFFT:
    :meth:`fftn` takes the x-slabs (a list of (ncomp, nx/D, ny, nz)
    tensors) to kz-slabs of the spectrum ((ncomp, nx, ny, w_j) on slab j's
    device, j's columns of :meth:`SlabPar.kz_split`), where the JAX
    package's hat field is y-split; :meth:`gather` joins them into the
    whole (ncomp, nx, ny, nz//2+1) spectrum."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.par = SlabPar(mesh)
        self.n_devices = mesh.size

    def supports(self, nx: int, ny: int, nz: int) -> bool:
        """Whether nx and ny split over the mesh (the slab path's rule)."""
        return nx % self.n_devices == 0 and ny % self.n_devices == 0

    def fftn(self, x):
        return slab_rfftn(self.par, x)

    def ifftn(self, y, shape):
        """The inverse of :meth:`fftn`; ``shape`` is the real (nx, ny,
        nz)."""
        return slab_irfftn(self.par, y, shape[-1])

    def fftn_zero_trace(self, x):
        """Traceless-tensor forward FFT: components 1.. are transformed,
        component 0 is rebuilt as -(c1 + c2) (fibergen.cpp:18531-18560)."""
        return [None if y is None else torch.cat([-(y[0] + y[1])[None], y])
                for y in self.fftn([s[1:] for s in x])]

    def ifftn_zero_trace(self, y, shape):
        """The inverse of components 1.., component 0 rebuilt as -(c1 + c2)
        (fibergen.cpp:18563-18584)."""
        x = self.ifftn([None if t is None else t[1:] for t in y], shape)
        return [torch.cat([-(s[0] + s[1])[None], s]) for s in x]

    @staticmethod
    def gather(y, device=None):
        """The whole spectrum from its kz-slabs, on ``device`` (default:
        the first kz-slab's)."""
        parts = [t for t in y if t is not None]
        dev = parts[0].device if device is None else torch.device(device)
        return torch.cat([t.to(dev) for t in parts], dim=-1)
