"""x-slab domain decomposition over a mesh of devices driven by one process.

Counterpart of fibergen_tpu/parallel/__init__.py.  Fields are laid out as
``(ncomp, nx, ny, nz)`` and split along x into contiguous slabs, one per
mesh entry: a sharded field is a list of D tensors, slab i of shape
(ncomp, nx/D, ny, nz) on ``mesh.devices[i]``.  One process drives every
slab, as one JAX program drives a ``Mesh``; a device may appear more than
once, so ``make_mesh(["cuda:0"] * 4)`` runs four slabs on one card (every
halo plane and kz chunk still crosses a slab boundary) and
``make_mesh(["cpu"] * 8)`` is the counterpart of the JAX package's forced
host devices.  On several cards the same code puts the slabs on different
cards and its exchanges (:mod:`.comm`) become peer copies.

- the stencils run per slab with one x-plane from each neighbour
  (:func:`.comm.halo_x`);
- the spectral chains z-transform each x-slab, move the spectrum to
  kz-slabs (:func:`.comm.to_kz`), run the y/x passes and the apply there,
  and move it back (:func:`.comm.from_kz`);
- reductions are per-slab partials added in slab order (:func:`.comm.psum`).

Code that runs on a whole field and on its slabs alike tells the two apart
only through :mod:`.slabs`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from .fft import SlabFFT, SlabPar, slab_fft_for, slab_reject_reason

X_AXIS = "x"

__all__ = ["Mesh", "NamedSharding", "make_mesh", "field_sharding",
           "scalar_sharding", "shard_field", "gather_field",
           "good_slab_size", "SlabFFT", "SlabPar", "slab_fft_for",
           "slab_reject_reason", "X_AXIS"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: the devices of the slabs, in slab order, under the axis
    name ``X_AXIS``.  A device may repeat."""

    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self):
        return {X_AXIS: self.size}


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a partition spec over the four field axes (ncomp, x, y,
    z): each entry None (not split) or ``X_AXIS``."""

    mesh: Mesh
    spec: tuple

    @property
    def is_fully_replicated(self) -> bool:
        return all(s is None for s in self.spec)


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over every visible CUDA device, or over ``devices`` (names
    or ``torch.device``s, repeats allowed).  Raises without a card when no
    list is given."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh() takes every visible CUDA device and none is "
                "available; pass a device list such as ['cpu'] * 4")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = tuple(torch.device(d) for d in devices)
    if not devs:
        raise ValueError("a mesh needs at least one device")
    if len({d.type for d in devs}) > 1:
        raise ValueError("a mesh takes CUDA devices or the CPU, not both")
    for d in devs:
        if d.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"mesh device {d} needs a CUDA device and "
                                   "none is available")
            if d.index is None:
                raise ValueError(f"name the card of mesh device {d} "
                                 f"(e.g. 'cuda:0')")
        elif d.type != "cpu":
            raise ValueError(f"unsupported mesh device {d}")
    return Mesh(devs)


def field_sharding(mesh: Mesh) -> NamedSharding:
    """x-slab sharding of ``(ncomp, nx, ny, nz)`` fields: x is split over
    the mesh, the other axes stay whole on each slab."""
    return NamedSharding(mesh, (None, X_AXIS, None, None))


def scalar_sharding(mesh: Mesh) -> NamedSharding:
    """Fully replicated sharding for means, Voigt vectors and scalars."""
    return NamedSharding(mesh, ())


def shard_field(x, mesh: Mesh):
    """Split a field along x (axis -3) into the mesh's contiguous slabs, one
    on each mesh device; works for (ncomp, nx, ny, nz) and (nx, ny, nz)."""
    nx = x.shape[-3]
    if not good_slab_size(nx, mesh.size):
        raise ValueError(f"nx={nx} does not split into {mesh.size} equal "
                         f"slabs")
    return [s.to(device=d, memory_format=torch.contiguous_format, copy=True)
            for s, d in zip(torch.chunk(x, mesh.size, dim=-3), mesh.devices)]


def gather_field(slabs, device=None):
    """The whole field from its x-slabs, on ``device`` (default: the first
    slab's)."""
    dev = slabs[0].device if device is None else torch.device(device)
    return torch.cat([s.to(dev) for s in slabs], dim=-3)


def good_slab_size(nx: int, n_devices: int) -> bool:
    """True when nx splits into equal slabs over the mesh."""
    return nx % n_devices == 0
