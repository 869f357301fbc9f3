"""The dim-3 laminate's stress difference, with its plain twin.

:func:`laminate_heat` (``csrc/laminate_heat.cu``) turns B strain fields of a
heat or porous-flow laminate (two phases with linear scalar laws, the rank-1
laminate or the infinity laminate of ``materials/laminate.py``) into their
stress differences in one pass over the grid, where the JAX package forms
the laminate in plain jnp (fibergen_tpu/materials/laminate.py)::

    s   = (c1 a1 k1 - c2 a2 k2) (n.F) / (c1 a1^2 k1 + c2 a2^2 k2)
    F1  = F - a1 s n,   F2 = F + a2 s n        (s = 0 off the interface)
    tau = c1 k1 F1 + c2 k2 F2 - 2 mu0 F

with the phase fractions c1, c2, the normals n (e_x where they vanish, not
normalised), the conductivities k1, k2 and the jump weights (a1, a2) =
(c2, c1) of the laminate or (1/2, 1/2) of the infinity laminate.  Case b
reads ``xs[b]`` and writes ``out[b]``; with mu0 = 0 it is the flux P.

A wrapper given CPU tensors computes the plain twin
(:func:`laminate_heat_plain`, the sequence ``LaminateMixed`` ran before the
kernel); given CUDA tensors it launches the kernel, ``MAX_CASES`` cases a
launch, or raises, with the tensors' device current.  ``launches`` counts
kernel launches only.  Each route runs inside a span:
``fg.material.laminate.kernel`` around the launches,
``fg.material.laminate.plain`` around the twin.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils.logging import span
from . import _build
from .stencil_kernels import _check, _stream

THR = 1e-7  # interface threshold (10 eps in the reference)
MAX_CASES = 8  # kMaxCases of csrc/laminate_heat.cu
RULES = {"laminate": 0, "infinity_laminate": 1}

launches = {"laminate_heat": 0}

_VP = ctypes.c_void_p
_D = ctypes.c_double
_I = ctypes.c_int
_LL = ctypes.c_longlong
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def unit_or_ex(n, normalize):
    """The normal field with e_x where it is (near) zero; unit length with
    ``normalize``."""
    nn2 = (n * n).sum(0, keepdim=True)
    ex = torch.zeros_like(n)
    ex[0] = 1.0
    if normalize:
        n = n / torch.sqrt(torch.clamp_min(nn2, 1e-30))
    return torch.where(nn2 > 1e-12, n, ex)


def laminate_jump(F, n, c1, c2, a1, a2, k1, k2, mask):
    """The phase strains (F1, F2) of the dim-3 laminate at the field ``F``:
    the closed-form jump s along the normals ``n`` (s = 0 off ``mask``, the
    interface), for phase fractions c1, c2, jump weights a1, a2 and
    conductivities k1, k2 (numbers or per-voxel fields).  The one plain
    form of the jump: the twin below and ``LaminateMixed``'s generic path
    both take it."""
    ng = (n * F).sum(0)
    s = (c1 * a1 * k1 - c2 * a2 * k2) * ng / (
        c1 * a1 * a1 * k1 + c2 * a2 * a2 * k2)
    s = torch.where(mask, s, torch.zeros_like(s))
    return F - (a1 * s)[None] * n, F + (a2 * s)[None] * n


def laminate_heat_plain(phi1, phi2, normals, xs, out, k1, k2, mu0, rule):
    """Plain PyTorch stress differences of the fields ``xs`` into the rows
    of ``out`` (returned); every tensor in the fields' type."""
    c1, c2 = phi1, phi2
    mask = (c1 > THR) & (c2 > THR)
    n = unit_or_ex(normals, False)
    if rule == "laminate":
        a1, a2 = c2, c1
    else:
        a1 = a2 = torch.full_like(c1, 0.5)
    for b, F in enumerate(xs):
        F1, F2 = laminate_jump(F, n, c1, c2, a1, a2, k1, k2, mask)
        P = c1[None] * (k1 * F1) + c2[None] * (k2 * F2)
        if mu0 == 0.0:
            out[b].copy_(P)
        else:
            torch.sub(P, 2.0 * mu0 * F, out=out[b])
    return out


def laminate_heat(phi1, phi2, normals, xs, out, k1, k2, mu0, rule):
    """The stress differences tau_b = P(x_b) - 2 mu0 x_b of the B fields
    ``xs`` (each (3, nx, ny, nz)) into ``out[b]`` (a (B, 3, nx, ny, nz)
    batch or a list of fields; returned), from the phase fractions ``phi1``,
    ``phi2`` (nx, ny, nz), the ``normals`` (3, nx, ny, nz), the numbers
    ``k1``, ``k2`` (the phases' conductivities) and ``mu0``, and ``rule``
    (``laminate`` or ``infinity_laminate``)."""
    if rule not in RULES:
        raise ValueError(f"laminate_heat takes the rules {list(RULES)}, got "
                         f"{rule!r}")
    dev = xs[0].device
    if dev.type == "cpu":
        with span("fg.material.laminate.plain"):
            return laminate_heat_plain(phi1, phi2, normals, xs, out, k1, k2,
                                       mu0, rule)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    dt = xs[0].dtype
    if dt not in _SUFFIX:
        raise TypeError(f"laminate_heat takes float32/float64, got {dt}")
    shape = tuple(xs[0].shape)
    if len(shape) != 4 or shape[0] != 3:
        raise ValueError(f"laminate_heat takes (3, nx, ny, nz) fields, got "
                         f"{shape}")
    if len(out) != len(xs):
        raise ValueError(f"{len(xs)} fields but {len(out)} outputs")
    _check("phi1", phi1, shape[1:], dt, dev)
    _check("phi2", phi2, shape[1:], dt, dev)
    _check("normals", normals, shape, dt, dev)
    for b in range(len(xs)):
        _check(f"xs[{b}]", xs[b], shape, dt, dev)
        _check(f"out[{b}]", out[b], shape, dt, dev)
    fn = _build.function("laminate_heat", "laminate_heat_" + _SUFFIX[dt], _I,
                         [_I, _LL, _VP, _VP, _VP, _I, _VP, _VP, _D, _D, _D,
                          _I, _VP])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    nvox = phi1.numel()
    with span("fg.material.laminate.kernel"), torch.cuda.device(dev):
        for lo in range(0, len(xs), MAX_CASES):
            chunk = range(lo, min(len(xs), lo + MAX_CASES))
            xp = (_VP * len(chunk))(*[xs[b].data_ptr() for b in chunk])
            op = (_VP * len(chunk))(*[out[b].data_ptr() for b in chunk])
            err = fn(RULES[rule], nvox, phi1.data_ptr(), phi2.data_ptr(),
                     normals.data_ptr(), len(chunk), xp, op, float(k1),
                     float(k2), float(2.0 * mu0), sms, _stream(dev))
            _build.check(err, "laminate_heat")
            launches["laminate_heat"] += 1
    return out
