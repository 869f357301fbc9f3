"""The CG's vector update, with its plain twin.

:func:`cg_update` (``csrc/cg_update.cu``) ends a linear CG step in one pass
over the fields, where the JAX package's step is one XLA fusion
(fibergen_tpu/solvers/ls.py:679-683)::

    alpha = gamma / (denom + tiny)
    eps  <- eps + alpha p
    r    <- r + alpha (w - p)
    delta = <r, r> + tiny

on fields of C = 3 or 6 components (``fields.inner_l2``'s Voigt weights),
with the 0-d ``gamma`` and ``denom`` read on the device.  eps and r are
updated in place; p and w are read.  :func:`cg_update_slabs` does the same
on the x-slabs of a sharded field: one launch a slab, delta the mean of the
slabs' means added in slab order, as ``fields.inner_l2`` takes it.

A wrapper given CPU tensors computes the plain twin
(:func:`cg_update_plain`, the plain PyTorch sequence); given CUDA tensors
it launches the kernel or raises, with the tensors' device current.
``launches`` counts kernel launches only.  Each route runs inside a span:
``fg.cg.update.kernel`` around a launch, ``fg.cg.update.plain`` around the
twin.
"""
from __future__ import annotations

import ctypes

import torch

from ..core import fields
from ..parallel import comm
from ..utils.logging import span
from . import _build
from .stencil_kernels import _check, _stream

launches = {"cg_update": 0}

_VP = ctypes.c_void_p
_D = ctypes.c_double
_I = ctypes.c_int
_LL = ctypes.c_longlong
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def cg_update_plain(eps, r, p, w, gamma, denom, tiny, shift):
    """Plain PyTorch update: eps and r in place; returns <r, r> + shift
    (a 0-d tensor)."""
    alpha = gamma / (denom + tiny)
    eps.addcmul_(p, alpha)                             # eps + alpha p
    r.addcmul_(w - p, alpha)                           # r - alpha (p - w)
    return fields.inner_l2(r, r) + shift


def _update(eps, r, p, w, gamma, denom, tiny, shift):
    """One field's update; delta = <r, r> + ``shift``."""
    if eps.device.type == "cpu":
        with span("fg.cg.update.plain"):
            return cg_update_plain(eps, r, p, w, gamma, denom, tiny, shift)
    if eps.device.type != "cuda":
        raise ValueError(f"unsupported device {eps.device}")
    dt, dev = eps.dtype, eps.device
    if dt not in _SUFFIX:
        raise TypeError(f"cg_update takes float32/float64, got {dt}")
    shape = tuple(eps.shape)
    if len(shape) < 2 or shape[0] not in (3, 6):
        raise ValueError(f"cg_update takes (3 or 6, ...) fields, got "
                         f"{shape}")
    for name, t in (("eps", eps), ("r", r), ("p", p), ("w", w)):
        _check(name, t, shape, dt, dev)
    _check("gamma", gamma, (), dt, dev)
    _check("denom", denom, (), dt, dev)
    nvox = eps[0].numel()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    npart = _build.function("cg_update", "cg_update_partials", _LL,
                            [_I])(sms)
    part = torch.empty(npart, dtype=torch.float64, device=dev)
    delta = torch.empty((), dtype=dt, device=dev)
    fn = _build.function("cg_update", "cg_update_" + _SUFFIX[dt], _I,
                         [_I, _LL, _VP, _VP, _D, _D, _VP, _VP, _VP, _VP, _I,
                          _VP, _VP, _VP])
    with span("fg.cg.update.kernel"), torch.cuda.device(dev):
        err = fn(shape[0], nvox, gamma.data_ptr(), denom.data_ptr(),
                 float(tiny), float(shift), eps.data_ptr(), r.data_ptr(),
                 p.data_ptr(), w.data_ptr(), sms, part.data_ptr(),
                 delta.data_ptr(), _stream(dev))
    _build.check(err, "cg_update")
    launches["cg_update"] += 1
    return delta


def cg_update(eps, r, p, w, gamma, denom, tiny):
    """The end of a CG step on one field of C = 3 or 6 components (a whole
    field, or row b of a batch): eps and r updated in place by ``alpha =
    gamma / (denom + tiny)``; returns delta = <r, r> + tiny, a 0-d tensor.
    ``gamma`` and ``denom`` are 0-d tensors on the fields' device, ``tiny``
    a number."""
    return _update(eps, r, p, w, gamma, denom, tiny, tiny)


def cg_update_slabs(eps, r, p, w, gamma, denom, tiny):
    """:func:`cg_update` on every x-slab of a sharded field (lists of
    slabs; ``gamma`` and ``denom`` one entry per slab).  Returns delta on
    every slab's device: the slabs' means added in slab order
    (``comm.psum``) over the slab count, plus tiny."""
    parts = [_update(*a, tiny, 0.0) for a in zip(eps, r, p, w, gamma, denom)]
    return [s / len(parts) + tiny for s in comm.psum(parts)]
