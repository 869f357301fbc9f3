"""Composite Gamma operators beside the elasticity staggered CG step.

Counterpart of fibergen_tpu/ops/gamma.py (GammaOperator*,
fibergen.cpp:20288-20531) for the branches the port runs (the elasticity
staggered CG step of a material on the isotropic route calls K1, K3 and
K2 directly):

* :func:`gamma_staggered`: the generic elasticity branch of
  ``gamma_operator`` on the staggered grid for any other material,
  div_staggered -> K3 -> eps_staggered around a stress difference formed
  in PyTorch (the JAX package forms the stencils outside any Pallas
  kernel there too); with ``g0_solver="multigrid"`` the multigrid
  Poisson solves of solvers/multigrid.py in place of K3;
* :func:`gamma_heat_staggered`: the heat/porous branch of
  ``gamma_operator``, div_staggered_heat -> K4 -> eps_staggered_heat
  (the two plain stencils in the spans ``fg.stencil.heat.div`` and
  ``fg.stencil.heat.grad``);
* :func:`fused_visc`: the viscosity Delta scheme's staggered branch of
  ``delta_operator`` on one direction build, as the JAX solver's
  ``fused_visc`` runs it: K1 tau-sum mode -> K3 with the dual constants
  -> K2 Delta mode (isotropic zero-lambda phases, no mixed BC);
* :func:`delta_staggered`: the same branch for any other stress
  difference (``delta_operator``'s generic staggered path): the plain
  stencils around K3 with the dual constants;
* :func:`gamma_collocated`: the collocated branch of ``gamma_operator``
  for elasticity (K5, 6 components) and heat/porous flow (K5, 3);
* :func:`delta_collocated`: the collocated branch of ``delta_operator``
  (K6, the zero-trace chain with the dual constants);
* :func:`gamma_willot` and :func:`delta_willot`: Willot's rotated Gamma
  in elasticity and in the viscosity Delta scheme (``torch.fft`` around
  the plain apply of ``green.gamma_willot``: the JAX package runs no Pallas
  kernel there either);
* :func:`gamma_hyper`: the hyperelasticity branch of ``gamma_operator``
  (div_staggered_hyper -> K3 with the full-gradient constants ->
  eps_staggered_hyper on the staggered grid; K5 at C = 9 on the
  collocated grid).  K1 and K2 take no part: they assume per-voxel
  isotropic linear moduli.

With ``par`` (a parallel.fft.SlabPar) every operator takes lists of
x-slabs: the chains run on kz-slabs, the staggered stencils per slab on the
neighbours' halo planes (K1 and K2 in halo mode in :func:`fused_visc`),
Willot's Gamma and ``freq_hack`` on the plain slab transforms
(``green.slab_transformed``), and ``E`` is a list with one value per slab.
The means (of tau for the Delta schemes' adjustment and for the mixed-BC
correction) are the slabs' means added in slab order.

The ``*_batched`` forms apply an operator to B right-hand sides at once
(the JAX package's batched CG, which vmaps them, ls.py:944-986): the
case-wise stage before the chain runs case by case, writing each case's
chain input into a (B, C, nx, ny, nz) batch, one batched chain
(``green.*_fused_batched``) transforms the batch, and the case-wise stage
after it runs case by case on the batch's rows; each case's arithmetic is
its single form's.  They take the whole field (no ``par``) and pure-strain
loading (no ``bc``), as ``LSSolver.run_batched`` runs them, and return one
result per case.

``bc`` (a solvers.bc.BCProjector that is not trivial) adds the mixed-BC
mean correction alpha R, R = bc_correction(bc, mean(tau)), as
initBCProjector/applyBCProjector do (fibergen.cpp:20220-20279): the
collocated chains take E + alpha R as their DC value, the staggered paths
add alpha R to eta.
"""
from __future__ import annotations

import torch

from ..core import fields
from ..parallel import comm, slabs
from ..solvers.bc import bc_correction
from ..utils.logging import span
from . import fft, green, staggered
from .stencil_kernels import (eps_from_u_dot, eps_from_u_dot_slabs,
                              stress_div_beta, stress_div_beta_slabs)

# the schemes that take the staggered operators: half_staggered and
# full_staggered differ from staggered only in their material (the
# doubly-fine grid, materials/dfg.py)
STAGGERED = ("staggered", "half_staggered", "full_staggered")


def _halos(slab_list):
    """Each slab's ``(minus, plus)`` halo planes (comm.halo_x)."""
    return list(zip(*comm.halo_x(slab_list)))


def _per_slab(fn, x):
    """``fn(slab, halo)`` on each x-slab of ``x`` with its halo planes."""
    return [fn(t, h) for t, h in zip(x, _halos(x))]


def _like(E, m):
    """E as a tensor of ``m``'s type on its device."""
    return torch.as_tensor(E, dtype=m.dtype, device=m.device)


def _shifted_mean(E, c, tau, mean=fields.mean):
    """E + c mean(tau), whole or on every slab's device (a list)."""
    return slabs.smap(lambda E, m: _like(E, m) + c * m, E, mean(tau))


def _corrected(E, bc, tau, alpha, mean=fields.mean):
    """E + alpha R with R = bc_correction(bc, mean(tau)): the mean of a
    Gamma application under ``bc`` (E as it is without one); on x-slabs
    from the cross-slab mean, on every slab's device."""
    if bc is None:
        return E
    return slabs.smap(lambda E, m: _like(E, m) + alpha * bc_correction(bc, m),
                      E, mean(tau))


def _zero_trace_mean(tau):
    """The mean of a traceless 6-component tau with its component 0
    rebuilt as -(m1 + m2), as the zero-trace chain sees it."""
    return slabs.smap(lambda m: torch.cat([-(m[1] + m[2]).reshape(1), m[1:]]),
                      fields.mean(tau))


def stress_diff_mean(x, mu_x, lam_x, mu_0, lambda_0):
    """mean((C(x) - C0) : x) on a 6-component field with per-voxel
    isotropic moduli, without forming (C(x) - C0) : x: one reduction over
    x and the two moduli planes (the mean that K1's stress difference
    would have)."""
    n = x[0].numel()
    m = torch.einsum("cxyz,xyz->c", x, mu_x - mu_0) * (2.0 / n)
    tr = torch.einsum("xyz,xyz->", x[0] + x[1] + x[2], lam_x - lambda_0) / n
    return m + torch.cat([tr.expand(3), tr.new_zeros(x.shape[0] - 3)])


def gamma_staggered(grid, E, mu_0, lambda_0, tau, bc=None, alpha=-1.0,
                    g0_solver="fft", par=None):
    """eta = alpha Gamma tau with mean E on (6, nx, ny, nz) fields
    (gamma_operator, mode elasticity, staggered scheme):
    div_staggered -> K3 -> eps_staggered, whose mean E + alpha R carries
    the correction under ``bc``.  ``g0_solver="multigrid"`` applies G0 by
    the multigrid Poisson solves (solvers/multigrid.py, plain PyTorch)
    instead of K3, as the JAX package's gamma_operator does
    (fibergen_tpu/ops/gamma.py:101-103).  With ``par`` the halo stencils
    around the kz-slab K3, or around the slab multigrid."""
    if par is not None:
        f = _per_slab(lambda t, h: staggered.div_staggered(grid, t, halo=h),
                      tau)
        if g0_solver == "multigrid":
            from ..solvers.multigrid import g0_multigrid_staggered
            u = g0_multigrid_staggered(grid, mu_0, lambda_0, f, alpha)
        else:
            u = green.g0_staggered_fused(grid, mu_0, lambda_0, f, alpha,
                                         par=par)
        del f
        E = _corrected(E, bc, tau, alpha)
        return [staggered.eps_staggered(grid, _like(slabs.part(E, j), x), x,
                                        halo=h)
                for j, (x, h) in enumerate(zip(u, _halos(u)))]
    f = staggered.div_staggered(grid, tau)
    if g0_solver == "multigrid":
        from ..solvers.multigrid import g0_multigrid_staggered
        u = g0_multigrid_staggered(grid, mu_0, lambda_0, f, alpha)
    else:
        u = green.g0_staggered_fused(grid, mu_0, lambda_0, f, alpha)
    del f
    return staggered.eps_staggered(grid, _corrected(E, bc, tau, alpha), u)


def delta_staggered(grid, E, mu_0, tau, alpha=-1.0, bc=None, par=None):
    """Viscosity dual operator on the staggered grid (delta_operator's
    staggered branch, fibergen_tpu/ops/gamma.py:205-212; DeltaOperator*,
    fibergen.cpp:20380-20486) for any stress difference ``tau``: eta =
    2 alpha mu0v (tau - mu0v Gamma^0 : tau) with mean E, mu0v = 1/(4 mu_0),
    as :func:`gamma_staggered` with the dual constants (-1/(4 mu0v), inf)
    and the mean adj = E - 2 alpha mu0v <tau>, plus 2 alpha mu0v tau (K3
    between the plain stencils; the correction under ``bc`` reads
    mean(tau)).  With ``par`` the halo stencils around the kz-slab K3, the
    mean of tau added over the slabs in slab order."""
    mu0v = 1.0 / (4.0 * mu_0)
    b = 2.0 * alpha * mu0v
    adj = _shifted_mean(E, -b, tau)
    eta = gamma_staggered(grid, adj, -1.0 / (4.0 * mu0v), float("inf"), tau,
                          bc=bc, alpha=alpha, par=par)
    slabs.smap(lambda e, t: e.add_(b * t), eta, tau)
    return eta


def _heat_div(grid, tau, halo=None):
    """The plain heat divergence (one field or slab) in the span
    ``fg.stencil.heat.div``."""
    with span("fg.stencil.heat.div"):
        return staggered.div_staggered_heat(grid, tau, halo=halo)


def _heat_grad(grid, E, u, halo=None):
    """The plain heat gradient plus E (one field or slab) in the span
    ``fg.stencil.heat.grad``."""
    with span("fg.stencil.heat.grad"):
        return staggered.eps_staggered_heat(grid, E, u, halo=halo)


def gamma_heat_staggered(grid, E, mu_0, tau, par=None, bc=None):
    """eta = -Gamma tau with mean E on (3, nx, ny, nz) fields
    (gamma_operator, mode heat/porous, staggered scheme, alpha = -1)."""
    if par is not None:
        f = _per_slab(lambda t, h: _heat_div(grid, t, halo=h), tau)
        u = green.g0_staggered_heat_fused(grid, mu_0, 0.0, f, par=par)
        E = _corrected(E, bc, tau, -1.0)
        return [_heat_grad(grid, slabs.part(E, j), x, halo=h)
                for j, (x, h) in enumerate(zip(u, _halos(u)))]
    f = _heat_div(grid, tau)
    u = green.g0_staggered_heat_fused(grid, mu_0, 0.0, f)
    return _heat_grad(grid, _corrected(E, bc, tau, -1.0), u)


def fused_visc(grid, r, p_prev, beta, E, mu_x, lam_x, mu0, lam0, par=None,
               mod_halo=None):
    """Viscosity Delta staggered application on one direction build:
    p = r + beta p_prev (p = r with ``p_prev=None``); tau = (C(x) - C0) : p;
    u = G0'(div tau) with the dual constants (mu_0' = -mu0, lambda' -> inf,
    fibergen.cpp:20446-20458); eta = adj + grad(u) + 2 alpha mu0v tau with
    alpha = -1, mu0v = 1/(4 mu0) and adj = E - 2 alpha mu0v mean(tau), formed
    on the device.  Returns (eta, p, dot_raw) with dot_raw = nxyz <p, p -
    eta> (the CG denominator); p is None with ``p_prev=None``.  With
    ``par`` K1 tau-sum mode and K2 Delta mode run in halo mode around the
    kz-slab K3 (``mod_halo``: the moduli's halo planes, as
    stress_div_beta_slabs takes them); the tau sum and the dot are the
    slabs' sums added in slab order, on every slab's device."""
    bdelta = 2.0 * (-1.0) * (1.0 / (4.0 * mu0))    # 2 alpha mu0v
    if par is None:
        f, p, tau_sum = stress_div_beta(grid, r, p_prev, beta, mu_x, lam_x,
                                        mu0, lam0, want_tau_sum=True)
        u = green.g0_staggered_fused(grid, -mu0, float("inf"), f)
        adj = E - (bdelta / grid.nxyz) * tau_sum
        w, dot_raw = eps_from_u_dot(grid, adj, u, r if p is None else p,
                                    mu_x=mu_x, tau2c=bdelta, mu0=mu0)
        return w, p, dot_raw
    f, p, tau_sum = stress_div_beta_slabs(grid, r, p_prev, beta, mu_x, lam_x,
                                          mu0, lam0, mod_halo,
                                          want_tau_sum=True)
    u = green.g0_staggered_fused(grid, -mu0, float("inf"), f, par=par)
    del f
    adj = [e - (bdelta / grid.nxyz) * t for e, t in zip(E, tau_sum)]
    w, dot_raw = eps_from_u_dot_slabs(grid, adj, u, r if p is None else p,
                                      mu_x=mu_x, tau2c=bdelta, mu0=mu0)
    return w, p, dot_raw


def _chain_input(tau, C, stage):
    """The (B, C, nx, ny, nz) input of a batched chain: ``stage(tau[b])``
    of each case, formed in turn into its row."""
    f = tau.new_empty((tau.shape[0], C) + tuple(tau.shape[2:]))
    for b in range(tau.shape[0]):
        f[b] = stage(tau[b])
    return f


def _case(E, b):
    """Case b's mean: E[b] of a list of the cases' means, else E."""
    return E[b] if isinstance(E, list) else E


def gamma_staggered_batched(grid, E, mu_0, lambda_0, tau, alpha=-1.0):
    """:func:`gamma_staggered` (the FFT G0) of each case of a (B, 6, nx, ny,
    nz) batch ``tau`` with one batched K3 chain; ``E`` one mean, or a list
    of the cases' means.  A list of the B results."""
    f = _chain_input(tau, 3, lambda t: staggered.div_staggered(grid, t))
    u = green.g0_staggered_fused_batched(grid, mu_0, lambda_0, f, alpha)
    del f
    return [staggered.eps_staggered(grid, _case(E, b), x)
            for b, x in enumerate(u)]


def delta_staggered_batched(grid, E, mu_0, tau, alpha=-1.0):
    """:func:`delta_staggered` of each case of a (B, 6, nx, ny, nz) batch
    ``tau`` with one batched K3 chain (the dual constants); a list of the
    B results."""
    mu0v = 1.0 / (4.0 * mu_0)
    b = 2.0 * alpha * mu0v
    adj = [_shifted_mean(E, -b, t) for t in tau]
    eta = gamma_staggered_batched(grid, adj, -1.0 / (4.0 * mu0v),
                                  float("inf"), tau, alpha)
    for e, t in zip(eta, tau):
        e.add_(b * t)
    return eta


def gamma_heat_staggered_batched(grid, E, mu_0, tau):
    """:func:`gamma_heat_staggered` of each case of a (B, 3, nx, ny, nz)
    batch ``tau`` with one batched K4 chain; a list of the B results."""
    f = _chain_input(tau, 1, lambda t: _heat_div(grid, t))
    u = green.g0_staggered_heat_fused_batched(grid, mu_0, 0.0, f)
    del f
    return [_heat_grad(grid, E, x) for x in u]


def _k1_batch(grid, rs, p_prevs, betas, mu_x, lam_x, mu0, lam0,
              want_tau_sum=False):
    """K1 of each case (init mode with ``p_prevs=None``), each writing its
    force into row b of one (B, 3, nx, ny, nz) batch: (the batch, each
    case's other outputs)."""
    f = rs[0].new_empty((len(rs), 3) + tuple(rs[0].shape[1:]))
    rest = [stress_div_beta(grid, r, None if p_prevs is None else p_prevs[b],
                            None if betas is None else betas[b], mu_x, lam_x,
                            mu0, lam0, want_tau_sum=want_tau_sum,
                            out=f[b])[1:]
            for b, r in enumerate(rs)]
    return f, rest


def k1_k3_k2_batched(grid, rs, p_prevs, betas, E, mu_x, lam_x, mu0, lam0):
    """Staggered elasticity's fused operator (LSSolver._k1_k3_k2, without
    ``bc``) on B right-hand sides: K1 of each case writes its force into
    row b of the batched K3 chain's input, K2 reads row b of its output and
    writes w into row b of one (B, 6, nx, ny, nz) batch.  In step mode
    (``p_prevs``, ``betas``: one per case) (ws, ps, dots); in init mode
    (``p_prevs=None``) ps and dots are None."""
    f, rest = _k1_batch(grid, rs, p_prevs, betas, mu_x, lam_x, mu0, lam0)
    ps = [p for p, in rest]
    u = green.g0_staggered_fused_batched(grid, mu0, lam0, f)
    del f
    w = u.new_empty((len(rs), 6) + tuple(u.shape[2:]))
    dots = [eps_from_u_dot(grid, E, x, p, out=wb)[1]
            for x, p, wb in zip(u, ps, w)]
    return list(w), ps, dots


def fused_visc_batched(grid, rs, p_prevs, betas, E, mu_x, lam_x, mu0, lam0):
    """:func:`fused_visc` on B right-hand sides: K1 tau-sum mode of each
    case into row b of the batched K3 chain's input (the dual constants),
    K2 Delta mode of each case on row b of its output, into row b of one
    (B, 6, nx, ny, nz) batch of w.  (ws, ps, dots), ps None in init mode
    (``p_prevs=None``)."""
    bdelta = 2.0 * (-1.0) * (1.0 / (4.0 * mu0))    # 2 alpha mu0v
    f, rest = _k1_batch(grid, rs, p_prevs, betas, mu_x, lam_x, mu0, lam0,
                        want_tau_sum=True)
    u = green.g0_staggered_fused_batched(grid, -mu0, float("inf"), f)
    del f
    w = u.new_empty((len(rs), 6) + tuple(u.shape[2:]))
    dots = [eps_from_u_dot(grid, E - (bdelta / grid.nxyz) * tau_sum, x,
                           r if p is None else p, mu_x=mu_x, tau2c=bdelta,
                           mu0=mu0, out=wb)[1]
            for x, r, (p, tau_sum), wb in zip(u, rs, rest, w)]
    return list(w), [p for p, _ in rest], dots


def gamma_collocated_batched(grid, E, mu_0, lambda_0, tau, alpha=-1.0,
                             beta=0.0):
    """:func:`gamma_collocated` (without ``freq_hack``) of each case of a
    (B, 6, nx, ny, nz) or (B, 3, nx, ny, nz) batch ``tau`` with one batched
    K5 chain; a list of the B results (rows of one batch)."""
    fused = green.gamma_collocated_fused_batched if tau.shape[1] == 6 else \
        green.gamma_collocated_heat_fused_batched
    return list(fused(grid, E, mu_0, lambda_0, tau, alpha, beta))


def delta_collocated_batched(grid, E, mu_0, tau, alpha=-1.0, beta=0.0):
    """:func:`delta_collocated` of each case of a traceless (B, 6, nx, ny,
    nz) batch ``tau`` with one batched K6 chain; a list of the B results
    (rows of one batch)."""
    mu0v = 1.0 / (4.0 * mu_0)
    return list(green.gamma_collocated_zt_fused_batched(
        grid, E, -1.0 / (4.0 * mu0v), float("inf"), tau, alpha,
        2.0 * alpha * mu0v + beta))


def gamma_collocated(grid, E, mu_0, lambda_0, tau, alpha=-1.0, beta=0.0,
                     par=None, bc=None, freq_hack=False):
    """eta = alpha Gamma : tau + beta tau with mean E on the collocated grid
    (gamma_operator, scheme "collocated"): a 6-component ``tau`` takes the
    elasticity Gamma (symmetrized at the Nyquist bins under
    ``freq_hack``), a 3-component one the heat/porous Gamma."""
    E = _corrected(E, bc, tau, alpha)
    if slabs.local(tau).shape[0] == 6:
        return green.gamma_collocated_fused(grid, E, mu_0, lambda_0, tau,
                                            alpha, beta, freq_hack=freq_hack,
                                            par=par)
    return green.gamma_collocated_heat_fused(grid, E, mu_0, lambda_0, tau,
                                             alpha, beta, par=par)


def delta_collocated(grid, E, mu_0, tau, alpha=-1.0, par=None, bc=None,
                     beta=0.0):
    """Viscosity dual operator on the collocated grid (delta_operator,
    scheme "collocated", fibergen.cpp:19075-19080, 20464-20471): eta =
    2 alpha mu0v (tau - mu0v Gamma^0 : tau) + beta tau with mean E,
    mu0v = 1/(4 mu_0), as the zero-trace collocated Gamma with the dual
    constants (-1/(4 mu0v), inf) and its beta 2 alpha mu0v + beta.  Under
    ``bc`` the correction reads the zero-trace reconstruction of
    mean(tau).  ``beta`` is the Eyre-Milton step's + tau (alpha = -4 mu_0,
    beta = 1), which the JAX package's delta_operator drops."""
    mu0v = 1.0 / (4.0 * mu_0)
    E = _corrected(E, bc, tau, alpha, mean=_zero_trace_mean)
    return green.gamma_collocated_zt_fused(
        grid, E, -1.0 / (4.0 * mu0v), float("inf"), tau, alpha,
        2.0 * alpha * mu0v + beta, par=par)


def gamma_willot(grid, E, mu_0, lambda_0, tau, alpha=-1.0, beta=0.0,
                 bc=None, par=None):
    """eta = alpha Gamma_W tau + beta tau with mean E on (6, nx, ny, nz)
    fields (gamma_operator, mode elasticity, scheme "willot",
    fibergen_tpu/ops/gamma.py:81-89): ``torch.fft`` around
    ``green.gamma_willot``; under ``bc`` the DC bin takes E + alpha R with
    R from the DC bin of the transformed tau.  With ``par`` the plain slab
    transforms around the apply on each kz-slab, its table built from the
    slab's own wavenumbers, R from the cross-slab mean of tau."""
    if par is not None:
        E = _corrected(E, bc, tau, alpha)
        return green.slab_transformed(par, grid, tau, lambda y, j, cols: (
            green.gamma_willot(grid, slabs.part(E, j), mu_0, lambda_0, y,
                               alpha, beta, cols=cols)))
    tau_hat = fft.fftn(tau)
    E = torch.as_tensor(E, dtype=tau.dtype, device=tau.device)
    if bc is not None:
        E = E + alpha * bc_correction(bc, tau_hat[:, 0, 0, 0].real)
    return fft.ifftn(green.gamma_willot(grid, E, mu_0, lambda_0, tau_hat,
                                        alpha, beta), grid.shape)


def delta_willot(grid, E, mu_0, tau, alpha=-1.0, beta=0.0, bc=None,
                 par=None):
    """Viscosity dual operator with Willot's Gamma (delta_operator, scheme
    "willot", fibergen_tpu/ops/gamma.py:205-212): eta = 2 alpha mu0v
    (tau - mu0v Gamma_W^0 : tau) + beta tau with mean E, mu0v =
    1/(4 mu_0), Gamma_W^0 at the dual constants (-1/(4 mu0v), lambda_0 ->
    inf)."""
    mu0v = 1.0 / (4.0 * mu_0)
    b = 2.0 * alpha * mu0v
    adj = _shifted_mean(E, -b, tau)
    eta = gamma_willot(grid, adj, -1.0 / (4.0 * mu0v), float("inf"), tau,
                       alpha, bc=bc, par=par)
    slabs.smap(lambda e, t: e.add_((b + beta) * t), eta, tau)
    return eta


def gamma_hyper(grid, scheme, E, mu_0, lambda_0, tau, alpha=-1.0, beta=0.0,
                par=None, bc=None):
    """eta = alpha Gamma tau + beta tau with mean E on 9-component
    (deformation-gradient) fields (gamma_operator, mode hyperelasticity,
    fibergen.cpp:19619-19774).  ``E`` may be a device tensor on
    the collocated grid; the staggered grid adds it in PyTorch.  With
    ``par`` the staggered stencils run per slab on the neighbours' halo
    planes around the kz-slab K3 chain, and slab j takes E's slab j."""
    E = _corrected(E, bc, tau, alpha)
    if scheme == "collocated":
        return green.gamma_collocated_hyper_fused(grid, E, mu_0, lambda_0,
                                                  tau, alpha, beta, par=par)
    if scheme not in STAGGERED:
        raise ValueError(f"Unknown gamma scheme '{scheme}' for mode "
                         f"'hyperelasticity'")
    if par is None:
        f = staggered.div_staggered_hyper(grid, tau)
        u = green.g0_staggered_hyper_fused(grid, mu_0, lambda_0, f, alpha)
        del f
        eta = staggered.eps_staggered_hyper(
            grid, torch.as_tensor(E, dtype=tau.dtype, device=tau.device), u)
    else:
        f = [staggered.div_staggered_hyper(grid, t, halo=h)
             for t, h in zip(tau, _halos(tau))]
        u = green.g0_staggered_hyper_fused(grid, mu_0, lambda_0, f, alpha,
                                           par=par)
        del f
        eta = [staggered.eps_staggered_hyper(
            grid, torch.as_tensor(slabs.part(E, j), dtype=x.dtype,
                                  device=x.device), x, halo=h)
            for j, (x, h) in enumerate(zip(u, _halos(u)))]
    if beta != 0.0:
        slabs.smap(lambda e, t: e.add_(beta * t), eta, tau)
    return eta
