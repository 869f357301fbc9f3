"""What the references of every mode share: periodic finite differences on
the staggered grid, its modified wavenumbers, and a preconditioned
conjugate gradient on the potential (the displacement, the temperature).

The references solve the discrete equilibrium div(C : (E + grad_h u)) = 0
for the periodic potential u, with the staggered-grid differences

    D+ f = (f(i + 1) - f(i)) n / d,     D- f = (f(i) - f(i - 1)) n / d,

a formulation of their own: the program solves the Lippmann-Schwinger
equation for the strain, these a conjugate gradient on u preconditioned by
the inverse of the homogeneous operator, applied in Fourier space.  Both
have the same solution.  Plain PyTorch only: no kernel, nothing of the
program.

Precision: ``store`` is the type every field is kept in between
operations; the arithmetic is float64 for a float64 store and float32
otherwise (bfloat16 has no FFT), so a bfloat16 store is the program's
float32 solve computed with its fields in bfloat16, the control of the
output check.
"""
from __future__ import annotations

import dataclasses
import math

import torch

AXES = (-3, -2, -1)


@dataclasses.dataclass
class Solution:
    field: torch.Tensor       # (dim, nx, ny, nz): the strain or gradient
    mean: torch.Tensor        # (dim,) float64: the mean stress or flux
    iterations: int
    residual: float           # the last relative preconditioned residual


def work_dtype(store: torch.dtype) -> torch.dtype:
    return torch.float64 if store == torch.float64 else torch.float32


def rounder(store: torch.dtype, work: torch.dtype):
    """x -> x kept in ``store`` (then computed on in ``work``)."""
    if store == work:
        return lambda x: x
    return lambda x: x.to(store).to(work)


def inv_h(shape, cell):
    return tuple(n / d for n, d in zip(shape, cell))


def dp(f, axis, h):
    """Forward difference along spatial axis 0, 1 or 2."""
    return (torch.roll(f, -1, dims=AXES[axis]) - f) * h


def dm(f, axis, h):
    """Backward difference along spatial axis 0, 1 or 2."""
    return (f - torch.roll(f, 1, dims=AXES[axis])) * h


def wavenumbers(shape, cell, device, work=torch.float64):
    """The symbols q_a of D+ on the half spectrum, (e^{i 2 pi m / n} - 1)
    n / d along each axis (D- is -conj(q_a)), shaped to broadcast over
    (nx, ny, nz // 2 + 1), and |q|^2 with its DC bin set to 1; formed in
    float64, returned in ``work``."""
    qs = []
    for a, (n, h) in enumerate(zip(shape, inv_h(shape, cell))):
        m = torch.arange(n // 2 + 1 if a == 2 else n, dtype=torch.float64,
                         device=device)
        theta = 2.0 * math.pi * m / n
        q = torch.complex(torch.cos(theta) - 1.0, torch.sin(theta)) * h
        qs.append(q.reshape([-1 if b == a else 1 for b in range(3)]))
    q2 = sum((q.abs() ** 2) for q in qs)
    q2 = q2.expand(shape[0], shape[1], shape[2] // 2 + 1).clone()
    q2[0, 0, 0] = 1.0
    cx = torch.complex128 if work == torch.float64 else torch.complex64
    return [q.to(cx) for q in qs], q2.to(work)


def spectrum(x, shape):
    return torch.fft.rfftn(x, s=shape, dim=AXES)


def real(xh, shape):
    return torch.fft.irfftn(xh, s=shape, dim=AXES)


def dot(a, b):
    return torch.sum(a * b)


def pcg(apply_a, precond, b, q, tol, maxiter, patience=20):
    """Preconditioned CG on A u = b from u = 0, every field kept by ``q``;
    stops at a relative preconditioned residual sqrt(<r, z> / <r0, z0>) of
    ``tol``, after ``maxiter`` steps, or after ``patience`` steps without a
    gain of 0.1 %.  Returns (u, iterations, residual)."""
    u = torch.zeros_like(b)
    r = q(b.clone())
    z = q(precond(r))
    p = z.clone()
    rz = float(dot(r, z))
    rz0 = abs(rz) or 1.0
    rel = math.sqrt(abs(rz) / rz0)
    best, stall, it = rel, 0, 0
    while it < maxiter and rel > tol and stall < patience:
        ap = q(apply_a(p))
        alpha = rz / float(dot(p, ap))
        u = q(u + alpha * p)
        r = q(r - alpha * ap)
        z = q(precond(r))
        rz_new = float(dot(r, z))
        p = q(z + (rz_new / rz) * p)
        rz = rz_new
        it += 1
        rel = math.sqrt(abs(rz) / rz0)
        if rel < best * (1.0 - 1e-3):
            best, stall = rel, 0
        else:
            stall += 1
    return u, it, rel


def phase_moduli(config, phi, names, work):
    """Per-voxel moduli ``names`` of the configuration's phases mixed by the
    Voigt rule (the phase-fraction-weighted sum), in ``work``."""
    if config.get("mixing", "voigt") != "voigt":
        raise ValueError("the reference mixes by the Voigt rule only")
    phi = phi.to(work)
    out = []
    for name in names:
        m = torch.zeros_like(phi)
        for ph in config["phases"]:
            frac = phi if ph["region"] == "inside" else 1.0 - phi
            m = m + float(ph[name]) * frac
        out.append(m)
    return out


def contrast_mean(config, name):
    """The mean of the phases' smallest and largest ``name``: the modulus of
    the homogeneous medium the preconditioner inverts."""
    vals = [float(ph[name]) for ph in config["phases"]]
    return 0.5 * (min(vals) + max(vals))
