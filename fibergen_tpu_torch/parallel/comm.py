"""The collectives the JAX package takes from ``lax``, on lists of slabs.

A sharded field is a list of tensors, slab i on ``devices[i]`` (see
``parallel/__init__.py``).  Every copy between slabs goes through
``Tensor.to(device, non_blocking=True)`` or ``torch.cat``, which order the
source's and the destination's current streams; on one card they are
device copies, on several peer copies.

* :func:`halo_x`: each slab's neighbour x-planes (``lax.ppermute`` in
  pallas_kernels._pad_xy);
* :func:`to_kz` / :func:`from_kz`: the spectrum between x-slabs and
  kz-slabs (the two ``lax.all_to_all`` of pallas_chain._run_middle_slab);
* :func:`psum`: a sum of per-slab partials, added in slab order so the
  result does not depend on timing, on every slab's device;
* :func:`replicate`: a value on every slab's device.
"""
from __future__ import annotations

import torch


def _to(t, dev):
    return t.to(dev, non_blocking=True)


def halo_x(slabs):
    """(minus, plus): minus[i] is the last x-plane of slab i-1, plus[i] the
    first x-plane of slab i+1 (periodic over the mesh), each a contiguous
    (..., 1, ny, nz) tensor on slab i's device.  One slab gets its own
    wrap."""
    d = len(slabs)
    last = [s.narrow(-3, s.shape[-3] - 1, 1) for s in slabs]
    first = [s.narrow(-3, 0, 1) for s in slabs]
    minus = [_to(last[(i - 1) % d], slabs[i].device).contiguous()
             for i in range(d)]
    plus = [_to(first[(i + 1) % d], slabs[i].device).contiguous()
            for i in range(d)]
    return minus, plus


def to_kz(spec, split, devices):
    """x-slab spectra (C, nx/D, ny, kz) -> kz-slabs (C, nx, ny, w_j) with
    (offset, width) = split[j] on devices[j], contiguous."""
    return [torch.cat([_to(s[..., o:o + w], dev) for s in spec], dim=-3)
            if w else None for (o, w), dev in zip(split, devices)]


def from_kz(kzs, nxl, devices):
    """kz-slabs (C, nx, ny, w_j) -> x-slab spectra (C, nx/D, ny, kz),
    contiguous; the inverse of :func:`to_kz` (a slab of width 0 is None)."""
    return [torch.cat([_to(k[..., i * nxl:(i + 1) * nxl, :, :], dev)
                       for k in kzs if k is not None], dim=-1)
            for i, dev in enumerate(devices)]


def psum(parts):
    """sum(parts) taken on the first part's device in slab order, then
    replicated: one tensor per slab, on the slab's device."""
    total = parts[0]
    for p in parts[1:]:
        total = total + _to(p, total.device)
    return replicate(total, [p.device for p in parts])


def replicate(x, devices):
    """``x`` on each of ``devices`` (the tensor itself where it lies)."""
    return [_to(x, d) for d in devices]
