#!/usr/bin/env python3
"""Smoke run of fibergen_tpu_torch (the PyTorch/CUDA port) on one card.

    python3 chip_smoke.py

Nine paths run on the card (PATHS), six more of general linear
materials (GENERAL_PATHS, phase 9), eight of the interface rules, the
doubly-fine grid and the generic staggered Delta path (INTERFACE_PATHS,
phase 10), four demo projects through the XML front end (FRONT_END,
phase 11), the mesh and file I/O projects (phase 12), the remaining
methods and Gamma schemes (METHOD_PATHS, phase 13) and mixed-precision
refinement, the low-memory CG, the multigrid G0 and the sweep harness
(phase 14), the linear paths last ported to the x-slab mesh
(SLAB_PATHS, phase 15), and the multigrid G0 on slabs, the whole-card
fallback of a mesh the slabs cannot split and the GUI's headless run
(phase 16).  Staggered CG: elasticity (K1, K3,
K2), heat conduction (the scalar K4 chain; porous flow is the same path)
and viscosity (K1 tau-sum mode, K3 with the dual constants, K2 Delta mode).
Collocated: CG in elasticity and heat (the plain stress difference and the
K5 collocated Gamma chain) and in viscosity (the K6 zero-trace chain), and
the Eyre-Milton polarization scheme in elasticity (K5).  Finite-strain
hyperelasticity (Newton-Krylov): staggered (K3 with the full-gradient
constants) and collocated (K5 at C = 9).  Phases, each failing loudly:

1. the card's name and power limit; build the CUDA kernels from ``csrc/``;
2. every kernel in every mode against its plain PyTorch twin at the paths'
   shapes (256^3 float32), on an odd float64 grid, on a float64 grid of
   power-of-two axes (the chains' register line FFT), at phase 10's
   64^3 in float32 and float64 (K3 also with the viscosity dual
   constants) and on one-voxel z axes (phase 11's 128 x 128 x 1 in
   float32 and float64, 33 x 17 x 1 in float64), with kernel, twin and
   cuFFT times from CUDA events; the batched chains (K3, K4, K5 at C = 6
   and 3, K6: run_batched's one launch for B right-hand sides) bitwise
   against B single launches and within the tolerance of their twins on
   those shapes in float32 and float64, timed at 256^3 float32 with phase
   8's batch sizes (and K3 B = 5 at 64^3) against B single launches and
   cuFFT's batched pair;
3. the kernel path (cuda) against the plain path (cpu) on one 48^3
   float64 solve of each linear path and one 24^3 float64 Newton solve of
   each hyperelastic path;
4. the paths at full size: the bench's 256^3 sphere RVE solved to 1e-6 in
   float32 on each linear path (timed second run, kernel launches counted
   around each; a path launches each of its kernels and no other), the
   staggered elasticity solve also in float64 and at 512^3; the JAX
   package's hyperelastic bench (a 256^3 two-phase SVK sphere at 2 %
   stretch, tol 1e-5) on both hyperelastic paths and with the frozen
   tangent, its P11 held against the JAX package's answer;
5. the x-laminates' analytic C11 and conductivity on the card, on the
   staggered and the collocated grid, and the SVK laminate at a small
   strain against the linear C11;
6. sharded: the x-slab solve on four slabs of one card
   (``make_mesh(["cuda:0"] * 4)``): each slab kernel (K1, K2 in halo mode,
   K1 tau-sum and K2 Delta mode among them; the kz-slab K3, K4, K5 and K6
   chains, and the finite-strain K5 at C = 9 and K3 with the full-gradient
   constants, these two also against their whole-field chains) against
   its twin at 256^3 float32 with times and the time of the two spectrum
   exchanges, K1/K2 halo mode in every mode bitwise against the periodic
   kernels on one slab; a 48^3 float64 sharded solve of each
   linear sharded path (SHARDED_PATHS, polarization included) and a 24^3
   float64 sharded Newton solve of each hyperelastic path with kernels
   against the plain twins on CPU slabs; the 256^3 float32 sharded solve
   of each linear path and the hyperelastic bench on both grids against
   phase 4's unsharded solves (launches counted: a path launches its slab
   kernels and no other); with two or more cards, the staggered
   elasticity and hyperelastic solves over min(4, count) cards;
7. the launch counts and one JSON line per kernel and mode with its
   numbers;
8. load cases on the bench's RVE at 256^3 float32 (``load_cases``): the
   effective stiffness (staggered elasticity) and conductivity (staggered
   heat), batched collocated elasticity and collocated viscosity (the five
   traceless cases), and collocated heat, each ``run_batched`` (one batched
   chain launch per step and for the init, K1 and K2 once per case)
   against its sequential ``run()`` solves; uniaxial stress under a
   mixed-BC projector on both
   grids; a 64^3 float64 linear loadstep run against the single-step
   solve, with and without extrapolation; the mixed_bc demo's
   finite-strain load (P11 = 1 prescribed, F22 = 1.1) at 32^3 float64;
9. general linear materials on the bench's sphere at 256^3 float32
   (``general_materials``, GENERAL_PATHS): the tiso demo's fibre (about
   e_x, and about a per-voxel axis) in its isotropic matrix on the generic
   staggered route (K3 alone) and on the collocated grid (K5), the bench's
   phases under the Reuss rule (K1, K2, K3), an anisotropic conductor on
   both grids (K4; K5 at C = 3); path 1 in float64; the route oracle (the
   bench's phases as general 6x6 and as tiso laws on the generic route
   against phase 4's K1/K2 solve); path 1's effective stiffness batched
   and sequential, with the symmetry about the fibre axis; and 48^3
   float64 solves on the card against the CPU, the Maximum, Random, 50-50,
   Split and Iso rules among them;
10. slice I on the bench's sphere at 256^3 float32 (``interfaces_and_dfg``,
   INTERFACE_PATHS): the bench's phases on the 512^3 doubly-fine sphere
   under full_staggered (K3 alone), with the share of prolong -> law ->
   restrict in a step; the laminate on the sharp sphere (the Voigt rule
   there: a route oracle against phase 4) and on a partial-volume sphere
   with its analytic normals on both grids (K3; K5), between Reuss and
   Voigt, with the jump solve's share and Cramer's rule against a batched
   torch.linalg.solve; the heat laminate (K4); fluidity mixing on both
   grids (K3; K6); staggered viscosity on the generic Delta path (K3
   alone) under the Maximum rule (a route oracle against phase 4's K1
   tau-sum route) and with lambda phases; the Nunan-Keller demo at n = 64
   (rigid spheres, V = 0.2, the five traceless cases batched and one by
   one) against the paper's alpha and beta; mixed BCs in staggered
   viscosity at 64^3 float64; 48^3 float64 solves on the card against
   the CPU;
11. the XML front end (``front_end``, FRONT_END): the demo projects
   hashin (256^3, the coated sphere's k*), transverse_isotropy (256^3, 30
   generated fibres, tiso on the orientation field, laminate rule), heat
   (128^2 x 1, the three cases batched) and Nunan-Keller (n = 64, the
   paper's alpha and beta) through ``ft.FG`` in float32, each with its
   init_phase and solve times and peak memory, launching its path's
   kernels and no other; float32 phi against float64 phi at 256^3; the
   heat run's K against the CPU in float64; hashin and transverse_isotropy
   at 32^3 and heat at 128^2 x 1, float64 through FG on the card against
   the CPU (phi and the geometry fields, iterations, the result);
12. meshes and file I/O (``meshes_and_io``): a synthetic 256^3 CT volume
   (smoothed, thresholded Gaussian noise: pore, calcite, quartz) written
   as two gzip'd uint8 rasters and read by the digital_rocks demo's
   project, its six cases one by one (K1, K2, K3) and batched, C_eff
   symmetric and its isotropic fit inside the n-phase Hashin-Shtrikman
   bounds; the solution VTK of a 128^3 solve read back (u one K3 launch,
   the identity eps_staggered(<eps>, u) = eps); the recovery chains (u
   K3, T K4, the viscosity velocity K3 and pressure K4) against their
   plain twins at 256^3 float32 and 48^3 float64; the mesh demos (stl at
   32^3 and 128^3, K4; tetmesh at 48 x 48 x 4 and 192 x 192 x 16, K3;
   normals with its write_vtk) with init_phase per primitive; the 32^3
   crop and the stl demo at n = 16 in float64 on the card against the
   CPU, a checkpoint of the card resumed on the CPU; get_fft_time;
13. the remaining methods and schemes (``remaining_methods``,
   METHOD_PATHS) at 256^3 float32 on the bench's sphere: nesterov and
   basic+el on both grids, CG with cg_reinit and with the sigma
   estimator (K1, K3, K2; K5), Willot in elasticity and viscosity and
   freq_hack on the collocated grid (torch.fft: no launch), polarization
   in viscosity (K6); on the hyperelastic bench nl_cg on both grids (K3;
   K5 at C = 9) and basic (K3), and Newton over the Maximum rule on phase
   10's partial-volume sphere; each against phase 4's CG or Newton
   solve of the same cell, then in float64 on the card against the CPU
   (48^3 linear, 31^3 hyperelastic);
14. mixed-precision refinement, the low-memory CG, the multigrid G0 and
   the sweep harness (``mixed_precision_low_memory``): the bench's sphere
   at 256^3 float32 refined to 1e-10 on both grids (K1, K3, K2; K5)
   against a float64 solve on the card, the hashin demo at its shipped
   tol in float32 through FG against float64, lm6 (K3 alone) at 512^3 in
   elasticity and viscosity against the plain route with both peaks, lm6
   on 1024 x 1024 x 512 (which the plain layout cannot hold), the
   multigrid G0 at 64^3 (no kernel) against the FFT G0, a three-point
   Experiment sweep, and the new paths in float64 at 32^3 on the card
   against the CPU;
15. the linear paths last ported to the x-slab mesh (``sharded_paths``,
   SLAB_PATHS) on four slabs of one card at 256^3 float32: staggered
   viscosity on both routes (K1 tau-sum and K2 Delta mode in halo mode;
   the generic Delta path under Maximum, K3 alone), uniaxial stress under
   mixed BCs on both grids, the B = 6 effective stiffness in one
   run_batched, Willot's Gamma and freq_hack (torch.fft on the kz-slabs),
   the tiso fibre, Reuss, the laminate and the 512^3 doubly-fine sphere,
   each warm with its wall, peak memory and launches, held to its
   unsharded solve of phases 4, 8, 9, 10 and 13; then each at 48^3
   float64 on the card's slabs against CPU slabs; with two or more cards,
   staggered viscosity and uniaxial stress over min(4, count) cards;
16. the rest of the port (``rest_of_port``): the multigrid G0 on four
   x-slabs of one card at 32^3 (levels 32 -> 16 -> 8 -> 4, the last
   gathered) in float32 and float64 against the unsharded multigrid (the
   same iterations, no launch) and one float64 G0 application against
   CPU slabs; sharding_fallback="warn" on a three-slab mesh of the card
   (256^3 float32: the warning, then phase 4's iterations, stress and
   launches bitwise; "error" raises); gui.app.run_project_and_view(
   show=False) on the card (GUI_XML at 64^3 float32: the viewed slice,
   the loadstep snapshots, K1/K3/K2; at 24^3 float64 the card's slice
   against the CPU's within 1e-10);
17. the solver's spans (``solver_spans``) in the benchmark's cells
   elastic-cases and elastic-tensor (``fgbench/``, 256^3 float32): one
   request of each under ``torch.cuda.set_sync_debug_mode("warn")``, every
   flagged synchronisation inside an ``fg.sync.*`` span and as many as
   those spans besides ``fg.sync.end``, no ``fg.`` event on the device;
   then the cases a second of traced 51 s windows with the spans and with
   ``span()`` stubbed out (on, off, off, on).

The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device
the script exits non-zero before printing any result.
"""
import collections
import json
import math
import os
import re
import subprocess
import sys
import time

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12          # float32 outside the tensor cores
H100_F64_FLOPS = 34e12          # float64 outside the tensor cores


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps=20, warm=3):
    """Mean device time of ``fn`` over ``reps`` calls, from CUDA events."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def rel_err(out, ref):
    """Max-abs error relative to the reference's max-abs, and the max-abs
    error itself (complex values compare as real and imaginary parts)."""
    import torch
    if out.is_complex():
        out, ref = torch.view_as_real(out), torch.view_as_real(ref)
    err = float((out.double() - ref.double()).abs().max())
    return err / float(ref.double().abs().max()), err


def dot_err(dot, ref):
    """A dot product's error relative to the reference, and its absolute
    error."""
    err = abs(float(dot) - float(ref))
    return err / abs(float(ref)), err


def sphere_phi(n, dtype):
    """bench.py's inclusion: a centred sphere of radius 0.3 (30 % of the
    cell's edge), as a numpy (n, n, n) array."""
    import numpy as np
    a = ((np.arange(n) + 0.5) / n - 0.5) ** 2
    return ((a[:, None, None] + a[None, :, None] + a[None, None, :])
            < 0.09).astype(dtype)


# the bench's RVE (bench.py make_problem) per mode: the phases' moduli
# (fibre, matrix) and the loading.  Elasticity: mu=10 lam=5 / mu=1 lam=1,
# e_xx = 1; heat (and porous flow): conductivities 10 / 1, unit x gradient;
# viscosity: fluidities 0.1 / 1, e_xz = 1.
RVE = {
    "elasticity": dict(dim=6, law="isotropic", fiber=(10.0, 5.0),
                       matrix=(1.0, 1.0), load=[1.0, 0, 0, 0, 0, 0]),
    "heat": dict(dim=3, law="scalar", fiber=(10.0,), matrix=(1.0,),
                 load=[1.0, 0, 0]),
    "viscosity": dict(dim=6, law="scalar", fiber=(0.1,), matrix=(1.0,),
                      load=[0, 0, 0, 0, 1.0, 0]),
    # scripts/bench_hyper_newton.py: SVK fibre mu=10 lam=5, matrix mu=1
    # lam=1, uniaxial stretch F = diag(1.02, 1, 1)
    "hyperelasticity": dict(dim=9, law="svk", fiber=(10.0, 5.0),
                            matrix=(1.0, 1.0),
                            load=[1.02, 1, 1, 0, 0, 0, 0, 0, 0]),
}
# path -> (mode, gamma_scheme, method)
PATHS = {
    "elasticity": ("elasticity", "staggered", "cg"),
    "heat": ("heat", "staggered", "cg"),
    "viscosity": ("viscosity", "staggered", "cg"),
    "elasticity-collocated": ("elasticity", "collocated", "cg"),
    "heat-collocated": ("heat", "collocated", "cg"),
    "viscosity-collocated": ("viscosity", "collocated", "cg"),
    "elasticity-polarization": ("elasticity", "collocated", "polarization"),
    "hyperelasticity": ("hyperelasticity", "staggered", "cg"),
    "hyperelasticity-collocated": ("hyperelasticity", "collocated", "cg"),
}
HYPER_PATHS = ("hyperelasticity", "hyperelasticity-collocated")
LINEAR_PATHS = tuple(p for p in PATHS if p not in HYPER_PATHS)
# the hyperelastic bench's options (scripts/bench_hyper_newton.py) and the
# JAX package's answer there, the mean P11 at 256^3 (PARITY.md:699)
HYPER_OPT = dict(tol=1e-5, error_estimator="residual",
                 outer_error_estimator="epsilon", check_every=8,
                 maxiter=2000)
HYPER_P11 = 0.074716
# the batched chain that run_batched launches, for all cases at once, in
# place of each single chain (LSSolver._cg_step_batched)
BATCHED_CHAIN = {c: c + "_batched" for c in (
    "g0_staggered_chain", "g0_staggered_heat_chain", "gamma_collocated_chain",
    "gamma_collocated_zt_chain")}
# the kernels each path must launch; it launches no other
PATH_KERNELS = {
    "elasticity": ("stress_div_beta", "eps_from_u_dot", "g0_staggered_chain"),
    "heat": ("g0_staggered_heat_chain",),
    "viscosity": ("stress_div_beta", "eps_from_u_dot", "g0_staggered_chain"),
    "elasticity-collocated": ("gamma_collocated_chain",),
    "heat-collocated": ("gamma_collocated_chain",),
    "viscosity-collocated": ("gamma_collocated_zt_chain",),
    "elasticity-polarization": ("gamma_collocated_chain",),
    "hyperelasticity": ("g0_staggered_chain",),
    "hyperelasticity-collocated": ("gamma_collocated_chain",),
    # phase 9: general linear materials (GENERAL_PATHS)
    "elasticity-general": ("g0_staggered_chain",),
    "elasticity-general-collocated": ("gamma_collocated_chain",),
    "elasticity-tiso-field": ("g0_staggered_chain",),
    "elasticity-reuss": ("stress_div_beta", "eps_from_u_dot",
                         "g0_staggered_chain"),
    "heat-aniso": ("g0_staggered_heat_chain",),
    "heat-aniso-collocated": ("gamma_collocated_chain",),
    # phase 10: interface laminates, the doubly-fine grid, the generic
    # staggered Delta path (INTERFACE_PATHS)
    "elasticity-full-staggered": ("g0_staggered_chain",),
    "elasticity-laminate": ("g0_staggered_chain",),
    "elasticity-laminate-collocated": ("gamma_collocated_chain",),
    "heat-laminate": ("g0_staggered_heat_chain", "laminate_heat"),
    "viscosity-generic": ("g0_staggered_chain",),
    "viscosity-lambda": ("g0_staggered_chain",),
    "viscosity-fluidity": ("g0_staggered_chain",),
    "viscosity-fluidity-collocated": ("gamma_collocated_zt_chain",),
    "viscosity-nunan-keller": ("g0_staggered_chain",),
    "viscosity-mixed-bc": ("g0_staggered_chain",),
    # phase 11: the XML front end (FRONT_END)
    "fg-hashin": ("stress_div_beta", "eps_from_u_dot", "g0_staggered_chain"),
    "fg-transverse-isotropy": ("g0_staggered_chain",),
    # (heat's three and Nunan-Keller's five cases batched: run_batched)
    "fg-heat": ("g0_staggered_heat_chain_batched", "laminate_heat"),
    "fg-nunan-keller": ("g0_staggered_chain_batched",),
    # phase 12: meshes and file I/O (the raw CT volume's stiffness, the
    # mesh demos; the recovery chains count apart, meshes_and_io)
    "fg-digital-rocks": ("stress_div_beta", "eps_from_u_dot",
                         "g0_staggered_chain"),
    "fg-stl": ("g0_staggered_heat_chain",),
    "fg-tetmesh": ("g0_staggered_chain",),
    "fg-normals": (),
    # phase 13: the remaining methods and schemes (METHOD_PATHS); Willot
    # and freq_hack run torch.fft, no kernel of the port
    "elasticity-nesterov": ("stress_div_beta", "eps_from_u_dot",
                            "g0_staggered_chain"),
    "elasticity-nesterov-collocated": ("gamma_collocated_chain",),
    "elasticity-basic-el": ("stress_div_beta", "eps_from_u_dot",
                            "g0_staggered_chain"),
    "elasticity-basic-el-collocated": ("gamma_collocated_chain",),
    "elasticity-cg-reinit": ("stress_div_beta", "eps_from_u_dot",
                             "g0_staggered_chain"),
    "elasticity-sigma": ("stress_div_beta", "eps_from_u_dot",
                         "g0_staggered_chain"),
    "elasticity-willot": (),
    "viscosity-willot": (),
    "elasticity-freq-hack": (),
    "viscosity-polarization": ("gamma_collocated_zt_chain",),
    "hyperelasticity-nl-cg": ("g0_staggered_chain",),
    "hyperelasticity-nl-cg-collocated": ("gamma_collocated_chain",),
    "hyperelasticity-basic": ("g0_staggered_chain",),
    "hyperelasticity-maximum": ("g0_staggered_chain",),
    # phase 14: refinement (its float64 residual runs the same kernels in
    # their double instances), the low-memory CG (lm6: K3 alone; the
    # stacked step's init runs the plain K1 / K3 / K2 operator), the
    # multigrid G0 (no kernel), the sweep harness
    "elasticity-refined": ("stress_div_beta", "eps_from_u_dot",
                           "g0_staggered_chain"),
    "elasticity-collocated-refined": ("gamma_collocated_chain",),
    "fg-hashin-refined": ("stress_div_beta", "eps_from_u_dot",
                          "g0_staggered_chain"),
    "elasticity-lm6": ("g0_staggered_chain",),
    "viscosity-lm6": ("g0_staggered_chain",),
    "elasticity-lowmem-stacked": ("stress_div_beta", "eps_from_u_dot",
                                  "g0_staggered_chain"),
    "elasticity-multigrid": (),
    "fg-experiment": ("stress_div_beta", "eps_from_u_dot",
                      "g0_staggered_chain"),
}

# phase 9: the tiso demo's materials (demo/elasticity/transverse_isotropy):
# an isotropic matrix of E = 910, nu = 0.3 (mu = 350, lam = 525) and a
# transversely isotropic fibre, here about e_x
TISO_FIBRE = dict(E=3860.0, nu=0.2, E_a=5390.0, G_a=390.0, nu_a=0.031)
TISO_MATRIX = dict(E=910.0, nu=0.3)
# path -> (mode, gamma_scheme, mixing rule, fibre of general_solver)
GENERAL_PATHS = {
    "elasticity-general": ("elasticity", "staggered", "voigt", "tiso"),
    "elasticity-general-collocated": ("elasticity", "collocated", "voigt",
                                      "tiso"),
    "elasticity-tiso-field": ("elasticity", "staggered", "voigt",
                              "tiso-field"),
    "elasticity-reuss": ("elasticity", "staggered", "reuss", "iso"),
    "heat-aniso": ("heat", "staggered", "voigt", "aniso"),
    "heat-aniso-collocated": ("heat", "collocated", "voigt", "aniso"),
}

# the paths of the x-slab sharded solve and the slab kernels each launches
SHARDED_PATHS = ("elasticity", "heat", "elasticity-collocated",
                 "heat-collocated", "viscosity-collocated",
                 "elasticity-polarization")
SHARDED_KERNELS = {
    "elasticity": ("stress_div_beta_halo", "eps_from_u_dot_halo",
                   "g0_staggered_chain_slab"),
    "heat": ("g0_staggered_heat_chain_slab",),
    "elasticity-collocated": ("gamma_collocated_chain_slab",),
    "heat-collocated": ("gamma_collocated_chain_slab",),
    "viscosity-collocated": ("gamma_collocated_zt_chain_slab",),
    "elasticity-polarization": ("gamma_collocated_chain_slab",),
    "hyperelasticity": ("g0_staggered_chain_slab",),
    "hyperelasticity-collocated": ("gamma_collocated_chain_slab",),
    # phase 15 (SLAB_PATHS): staggered viscosity (K1 tau-sum and K2 Delta
    # in halo mode; the generic Delta path K3 alone), the generic
    # elasticity route (K3 alone), Reuss (K1/K2); Willot and freq_hack run
    # torch.fft around their apply on kz-slabs, no kernel of the port
    "viscosity": ("stress_div_beta_halo", "eps_from_u_dot_halo",
                  "g0_staggered_chain_slab"),
    "viscosity-generic": ("g0_staggered_chain_slab",),
    "elasticity-general": ("g0_staggered_chain_slab",),
    "elasticity-reuss": ("stress_div_beta_halo", "eps_from_u_dot_halo",
                         "g0_staggered_chain_slab"),
    "elasticity-laminate": ("g0_staggered_chain_slab",),
    "elasticity-full-staggered": ("g0_staggered_chain_slab",),
    "elasticity-willot": (),
    "elasticity-freq-hack": (),
    # phase 16: the multigrid G0 on the slabs (plain PyTorch, no kernel)
    "elasticity-multigrid": (),
}
SLABS = 4


def sphere_solver(n, dtype, device, mode="elasticity", scheme="staggered",
                  method="cg", mesh=None, **opt):
    """The bench's RVE in ``mode`` (RVE) on an n^3 grid, solved with
    ``method`` on the ``scheme`` grid; with ``mesh`` (a list of devices)
    sharded into x-slabs over it."""
    import fibergen_tpu_torch as ft
    from fibergen_tpu_torch import parallel
    c = RVE[mode]
    phi = sphere_phi(n, "float32" if dtype == "float32" else "float64")
    mat = ft.convert.material_from_numpy(
        [("fiber", *c["fiber"], phi), ("matrix", *c["matrix"], 1.0 - phi)],
        dim=c["dim"], device=device if mesh is None else mesh[0],
        law=c["law"])
    sharding = None if mesh is None else parallel.field_sharding(
        parallel.make_mesh(mesh))
    s = ft.LSSolver(ft.Grid(n, n, n), mat, ft.SolverOptions(
        mode=mode, method=method, gamma_scheme=scheme, dtype=dtype, **opt),
        device=None if mesh is not None else device, sharding=sharding)
    s.set_strain(c["load"])
    return s


def placement(device, mesh):
    """(the material's device, the LSSolver keywords) of a solve on
    ``device``, or sharded into x-slabs over ``mesh`` (a list of
    devices)."""
    from fibergen_tpu_torch import parallel
    if mesh is None:
        return device, dict(device=device)
    return mesh[0], dict(sharding=parallel.field_sharding(
        parallel.make_mesh(mesh)))


def general_solver(n, dtype, device, fibre, mode="elasticity",
                   scheme="staggered", rule="voigt", blur=None, mesh=None,
                   **opt):
    """A general linear material on the bench's sphere (n^3, ``dtype``),
    loaded by e_xx = 1 (elasticity) or a unit x gradient (heat).  The
    ``fibre``:

    * ``tiso``: the tiso demo's fibre about e_x in its iso matrix;
      ``tiso-field``: the same about a per-voxel axis, unit vectors
      normalised from a numpy normal draw (seed 0);
    * ``iso``: the bench's isotropic phases (mu = 10, lam = 5 / mu = 1,
      lam = 1); ``general-iso``: the same constants as LinearGeneral 6x6
      stiffnesses; ``tiso-iso``: as tiso laws with E_a = E, G_a = mu,
      nu_a = nu;
    * ``aniso`` (heat): K = R diag(10, 5, 2) R^T, R a 30 degree rotation
      about z, in a matrix of conductivity 1.

    ``blur`` (voxels) smooths the sphere's surface into interface voxels
    (a logistic profile), for the rules that treat them apart.  ``mesh``
    (a list of devices) shards the solve into x-slabs over it."""
    import numpy as np
    import fibergen_tpu_torch as ft
    from fibergen_tpu_torch.materials.convert import elastic_constants
    dt = "float32" if dtype == "float32" else "float64"
    if blur is None:
        phi = sphere_phi(n, dt)
    else:
        a = ((np.arange(n) + 0.5) / n - 0.5) ** 2
        r = np.sqrt(a[:, None, None] + a[None, :, None] + a[None, None, :])
        phi = (1.0 / (1.0 + np.exp((r - 0.3) * n / blur))).astype(dt)

    def iso_c(mu, lam):
        C = np.zeros((6, 6))
        C[:3, :3] = lam
        C[range(3), range(3)] += 2.0 * mu
        C[3, 3] = C[4, 4] = C[5, 5] = mu
        return ("general", C)

    def tiso_iso(mu, lam):
        c = elastic_constants(mu=mu, lam=lam)
        return ("tiso", dict(E=c["E"], nu=c["nu"], E_a=c["E"], G_a=mu,
                             nu_a=c["nu"]), [1.0, 0.0, 0.0])

    c = elastic_constants(**TISO_MATRIX)
    matrix = ("isotropic", c["mu"], c["lam"])
    if fibre == "tiso":
        f = ("tiso", TISO_FIBRE, [1.0, 0.0, 0.0])
    elif fibre == "tiso-field":
        o = np.random.default_rng(0).standard_normal((3, n, n, n))
        f = ("tiso", TISO_FIBRE, (o / np.linalg.norm(o, axis=0)).astype(dt))
    elif fibre == "aniso":
        ang = np.pi / 6
        R = np.array([[np.cos(ang), -np.sin(ang), 0.0],
                      [np.sin(ang), np.cos(ang), 0.0], [0.0, 0.0, 1.0]])
        f, matrix = ("aniso", R @ np.diag([10.0, 5.0, 2.0]) @ R.T), \
            ("scalar", 1.0)
    else:
        make = {"iso": lambda mu, lam: ("isotropic", mu, lam),
                "general-iso": iso_c, "tiso-iso": tiso_iso}[fibre]
        f, matrix = make(10.0, 5.0), make(1.0, 1.0)
    dim = 3 if mode == "heat" else 6
    mdev, where = placement(device, mesh)
    mat = ft.convert.material_from_numpy(
        [("fiber", f, phi), ("matrix", matrix, 1.0 - phi)], dim=dim,
        device=mdev, rule=rule)
    s = ft.LSSolver(ft.Grid(n, n, n), mat, ft.SolverOptions(
        mode=mode, gamma_scheme=scheme, dtype=dtype, **opt), **where)
    s.set_strain([1.0, 0.0, 0.0, 0.0, 0.0, 0.0][:dim])
    return s


# phase 10: path -> (mode, gamma_scheme, mixing rule, phases, phi).  The
# phases: the bench's of the mode (RVE), or viscosity phases that carry a
# lambda; phi: the bench's sharp sphere, its partial-volume (smooth)
# sphere with the analytic normals, or the sharp sphere on the doubly-fine
# grid (a DfgMaterial)
INTERFACE_PATHS = {
    "elasticity-full-staggered": ("elasticity", "full_staggered", "voigt",
                                  "bench", "fine"),
    "elasticity-laminate": ("elasticity", "staggered", "laminate", "bench",
                            "smooth"),
    "elasticity-laminate-collocated": ("elasticity", "collocated",
                                       "laminate", "bench", "smooth"),
    "heat-laminate": ("heat", "staggered", "laminate", "bench", "smooth"),
    "viscosity-generic": ("viscosity", "staggered", "maximum", "bench",
                          "sharp"),
    "viscosity-lambda": ("viscosity", "staggered", "voigt", "lambda",
                         "sharp"),
    "viscosity-fluidity": ("viscosity", "staggered", "fluidity", "bench",
                           "smooth"),
    "viscosity-fluidity-collocated": ("viscosity", "collocated", "fluidity",
                                      "bench", "smooth"),
}
# the Nunan-Keller demo (demo/viscosity/nunan_keller): rigid spheres (V =
# 0.2) in a fluid of fluidity 1 (0.5 for the law), full_staggered; their
# alpha and beta (Nunan and Keller 1984)
NUNAN_KELLER = dict(V=0.2, alpha=1.0666, beta=0.49665)


def smooth_sphere(n, dtype, r=0.3, ss=4):
    """The partial-volume phi of a centred sphere of radius ``r`` (the
    share of ss^3 points of each voxel inside it; on the card if there is
    one, an x-slab at a time) and its outward unit normal field (e_x
    stands in at the centre), as numpy arrays in ``dtype``."""
    import torch
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    t = (torch.arange(n * ss, dtype=torch.float64, device=dev) + 0.5) / (
        n * ss) - 0.5
    t2 = t * t
    yz = t2[:, None] + t2[None, :]
    phi = torch.empty((n, n, n), dtype=torch.float64, device=dev)
    for i in range(n):
        inside = (t2[i * ss:(i + 1) * ss, None, None] + yz[None]) < r * r
        phi[i] = inside.reshape(ss, n, ss, n, ss).double().mean(dim=(0, 2, 4))
    c = (torch.arange(n, dtype=torch.float64, device=dev) + 0.5) / n - 0.5
    X = torch.stack(torch.meshgrid(c, c, c, indexing="ij"))
    nrm = X.norm(dim=0, keepdim=True)
    X = torch.where(nrm > 0, X / nrm.clamp_min(1e-30),
                    torch.tensor([1.0, 0.0, 0.0], dtype=torch.float64,
                                 device=dev).reshape(3, 1, 1, 1))
    return (phi.cpu().numpy().astype(dtype), X.cpu().numpy().astype(dtype))


def interface_solver(n, dtype, device, path, rule=None, geometry=None,
                     mesh=None, **opt):
    """The material of ``path`` (INTERFACE_PATHS; its rule replaced by
    ``rule``) on the bench's sphere at n^3 in ``dtype``, loaded as the
    bench loads its mode.  ``geometry`` (phi, normals) replaces the
    path's phi (both solvers of a comparison then read the same arrays;
    on the doubly-fine grid phi is 2n^3).  ``mesh`` as in
    :func:`general_solver`."""
    import fibergen_tpu_torch as ft
    mode, scheme, rule0, phases, kind = INTERFACE_PATHS[path]
    rule = rule or rule0
    dt = "float32" if dtype == "float32" else "float64"
    if geometry is not None:
        phi, normals = geometry
    elif kind == "smooth":
        phi, normals = smooth_sphere(n, dt)
    else:
        phi, normals = sphere_phi(2 * n if kind == "fine" else n, dt), None
    c = RVE[mode]
    if phases == "lambda":
        # 2 mu + 3 lam < 4 mu_0 in both phases: the Delta operator stays
        # regular on the trace (ROADMAP.md, Queue 3)
        fibre, matrix = ("isotropic", 0.05, 0.01), ("isotropic", 0.5, 0.02)
    else:
        fibre, matrix = (c["law"], *c["fiber"]), (c["law"], *c["matrix"])
    takes_normals = rule in ("laminate", "infinity_laminate", "fluidity")
    mdev, where = placement(device, mesh)
    mat = ft.convert.material_from_numpy(
        [("fiber", fibre, phi), ("matrix", matrix, 1.0 - phi)],
        dim=c["dim"], device=mdev, rule=rule,
        normals=normals if takes_normals else None)
    if kind == "fine":
        mat = ft.DfgMaterial(mat)
    s = ft.LSSolver(ft.Grid(n, n, n), mat, ft.SolverOptions(
        mode=mode, gamma_scheme=scheme, dtype=dtype, **opt), **where)
    s.set_strain(c["load"])
    return s


def general_path_solver(n, dtype, device, path, **opt):
    """The material of ``path`` (GENERAL_PATHS) on the bench's sphere."""
    mode, scheme, rule, fibre = GENERAL_PATHS[path]
    return general_solver(n, dtype, device, fibre, mode, scheme, rule, **opt)


def path_solver(n, dtype, device, path, **opt):
    """The bench's RVE on ``path`` (PATHS).  The polarization scheme has no
    CG residual: it runs with the epsilon estimator at the same tol."""
    if PATHS[path][2] == "polarization":
        opt["error_estimator"] = "epsilon"
    return sphere_solver(n, dtype, device, *PATHS[path], **opt)


# per-voxel values moved and flops of each kernel's work on the paths:
# K1 step reads r, p_prev, mu, lam and writes f, p; K1 init reads eps, mu,
# lam and writes f; the tau sum adds six per-block partials (no per-voxel
# values); K2 dot reads u, p and writes w; K2 no-dot reads u and writes w;
# K2 Delta also reads mu; the chains read f and write u (C values each, C
# = 3 for K3, 1 for K4, 6 or 3 for K5, 5 for K6), and their flops are those
# of a C-component rfftn + irfftn pair (2.5 N log2 N each per component)
# plus those of the apply per half-spectrum bin (about 56 for K3, 6 for K4;
# counted from GammaCollocated: 154 for K5 at C = 6 and for K6, 36 for K5
# at C = 3; from GammaCollocatedHyper: 176 for K5 at C = 9).
WORK = {
    "stress_div_beta": dict(values=14 + 9, flops=51),
    "stress_div_beta[init]": dict(values=8 + 3, flops=39),
    "stress_div_beta[tau_sum]": dict(values=14 + 9, flops=57),
    "eps_from_u_dot": dict(values=9 + 6, flops=51),
    "eps_from_u_dot[nodot]": dict(values=3 + 6, flops=30),
    "eps_from_u_dot[delta]": dict(values=10 + 6, flops=66),
    "g0_staggered_chain": dict(values=3 + 3, flops=None, comps=3, apply=56),
    "g0_staggered_heat_chain": dict(values=1 + 1, flops=None, comps=1,
                                    apply=6),
    "gamma_collocated_chain": dict(values=6 + 6, flops=None, comps=6,
                                   apply=154),
    "gamma_collocated_chain[heat]": dict(values=3 + 3, flops=None, comps=3,
                                         apply=36),
    "gamma_collocated_zt_chain": dict(values=5 + 5, flops=None, comps=5,
                                      apply=154),
    "gamma_collocated_chain[hyper]": dict(values=9 + 9, flops=None, comps=9,
                                          apply=176),
    "g0_staggered_chain[hyper]": dict(values=3 + 3, flops=None, comps=3,
                                      apply=56),
    # the CG's vector update at C = 6: eps, r, p, w read, eps, r written
    "cg_update": dict(values=6 * (4 + 2), flops=6 * 7),
    # the dim-3 laminate at B = 3: phi1, phi2, n read once, each case's
    # strain read and stress difference written
    "laminate_heat": dict(values=5 + 6 * 3, flops=15 + 9 * 3),
}
# a slab kernel does the same work as its whole-field kernel (the halo
# planes and the exchanged spectrum are the decomposition's own traffic)
WORK.update({
    "stress_div_beta[halo]": WORK["stress_div_beta"],
    "stress_div_beta[halo,init]": WORK["stress_div_beta[init]"],
    "stress_div_beta[halo,tau_sum]": WORK["stress_div_beta[tau_sum]"],
    "eps_from_u_dot[halo]": WORK["eps_from_u_dot"],
    "eps_from_u_dot[halo,delta]": WORK["eps_from_u_dot[delta]"],
    "eps_from_u_dot[halo,nodot]": WORK["eps_from_u_dot[nodot]"],
    "g0_staggered_chain_slab": WORK["g0_staggered_chain"],
    "g0_staggered_heat_chain_slab": WORK["g0_staggered_heat_chain"],
    "gamma_collocated_chain_slab": WORK["gamma_collocated_chain"],
    "gamma_collocated_chain_slab[heat]": WORK["gamma_collocated_chain[heat]"],
    "gamma_collocated_zt_chain_slab": WORK["gamma_collocated_zt_chain"],
    "gamma_collocated_chain_slab[hyper]":
        WORK["gamma_collocated_chain[hyper]"],
    "g0_staggered_chain_slab[hyper]": WORK["g0_staggered_chain[hyper]"],
})


def bound_ms(name, count, itemsize):
    w = WORK[name]
    peak = H100_F32_FLOPS if itemsize == 4 else H100_F64_FLOPS
    flops = w["flops"]
    if flops is None:
        flops = w["comps"] * 2 * 2.5 * math.log2(count) + w["apply"] / 2
    t_bytes = w["values"] * itemsize * count / H100_BYTES_PER_S
    t_ops = flops * count / peak
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else \
        "operations"


def check_kernels(shape, dtype, timed):
    """Phase 2 on one grid: each kernel against its twin; with ``timed``
    also kernel, twin and cuFFT times.  Returns {name: numbers}."""
    import torch
    import fibergen_tpu_torch as ft
    from fibergen_tpu_torch.ops import fft, green
    from fibergen_tpu_torch.ops import spectral_kernels as spk
    from fibergen_tpu_torch.ops import stencil_kernels as sk

    dev = torch.device("cuda")
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    g = ft.Grid(*shape, dx=1.0, dy=0.9, dz=1.1)
    gen = torch.Generator(device=dev).manual_seed(1234)
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev, dtype=dtype)
    n = g.nxyz
    r, pp, u = rnd(6, *shape), rnd(6, *shape), rnd(3, *shape)
    mu = 1.0 + rnd(*shape).abs()
    lam = 0.5 + rnd(*shape).abs()
    E = rnd(6)
    gam = torch.tensor(0.83, dtype=dtype, device=dev)
    gam_prev = torch.tensor(1.7, dtype=dtype, device=dev)
    mu0, lam0 = 2.75, 0.0
    c10, c20 = green.g0_constants(mu0, lam0)
    itemsize = torch.empty((), dtype=dtype).element_size()
    out = {}

    def report(name, errs, kern, plain, count):
        worst = max(e[0] for e in errs)
        rec = {"max_rel_err": worst, "max_abs_err": max(e[1] for e in errs)}
        line = f"  {name:24s} {tuple(shape)} {str(dtype)[6:]}: " \
               f"max rel err {worst:.3e}"
        if timed:
            rec["ms"], rec["plain_ms"] = cuda_ms(kern), cuda_ms(plain)
            rec["bound_ms"], rec["bound_by"] = bound_ms(name, count, itemsize)
            line += (f", kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f}"
                     f" ms, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})")
        log(line)
        if not worst <= tol:
            raise AssertionError(f"{name}: error {worst:.3e} > {tol:g}")
        out[name] = rec

    # K1, step mode and init mode
    k1 = lambda: sk.stress_div_beta(g, r, pp, (gam, gam_prev), mu, lam, mu0,
                                    lam0)
    p1 = lambda: sk.stress_div_beta_plain(g, r, pp, gam / gam_prev, mu, lam,
                                          mu0, lam0)
    (f, p), (fr, pr) = k1(), p1()
    report("stress_div_beta", [rel_err(f, fr), rel_err(p, pr)], k1, p1, n)
    k1i = lambda: sk.stress_div_beta(g, r, None, None, mu, lam, mu0, lam0)
    p1i = lambda: sk.stress_div_beta_plain(g, r, None, None, mu, lam, mu0,
                                           lam0)
    report("stress_div_beta[init]", [rel_err(k1i()[0], p1i()[0])], k1i, p1i,
           n)

    # K2, dot mode and no-dot mode
    k2 = lambda: sk.eps_from_u_dot(g, E, u, pp)
    p2 = lambda: sk.eps_from_u_dot_plain(g, E, u, pp)
    (w, d), (wr, dr) = k2(), p2()
    report("eps_from_u_dot", [rel_err(w, wr), dot_err(d, dr)], k2, p2, n)
    k2n = lambda: sk.eps_from_u_dot(g, E, u)
    p2n = lambda: sk.eps_from_u_dot_plain(g, E, u)
    report("eps_from_u_dot[nodot]", [rel_err(k2n()[0], p2n()[0])], k2n, p2n,
           n)

    # K1 tau-sum mode (viscosity), step and init: f, p and the tau sum;
    # the sum is compared relative to the largest sum
    k1t = lambda: sk.stress_div_beta(g, r, pp, (gam, gam_prev), mu, lam, mu0,
                                     lam0, want_tau_sum=True)
    p1t = lambda: sk.stress_div_beta_plain(g, r, pp, gam / gam_prev, mu, lam,
                                           mu0, lam0, want_tau_sum=True)
    errs = [rel_err(a, b) for a, b in zip(k1t(), p1t())]
    ki = sk.stress_div_beta(g, r, None, None, mu, lam, mu0, lam0,
                            want_tau_sum=True)
    pi = sk.stress_div_beta_plain(g, r, None, None, mu, lam, mu0, lam0,
                                  want_tau_sum=True)
    errs += [rel_err(ki[0], pi[0]), rel_err(ki[2], pi[2])]
    report("stress_div_beta[tau_sum]", errs, k1t, p1t, n)

    # K2 Delta mode (viscosity): the gradient plus the Delta term, and the
    # dot against the full w
    tau2c = -1.0 / (2.0 * mu0)
    k2d = lambda: sk.eps_from_u_dot(g, E, u, pp, mu_x=mu, tau2c=tau2c,
                                    mu0=mu0)
    p2d = lambda: sk.eps_from_u_dot_plain(g, E, u, pp, mu_x=mu, tau2c=tau2c,
                                          mu0=mu0)
    (w, d), (wr, dr) = k2d(), p2d()
    report("eps_from_u_dot[delta]", [rel_err(w, wr), dot_err(d, dr)], k2d,
           p2d, n)

    # K3: the whole chain against rfftn -> plain G0 apply -> irfftn
    k3 = lambda: spk.g0_staggered_chain(g, f, c10, c20)
    p3 = lambda: spk.g0_staggered_chain_plain(g, f, c10, c20)
    # and with the viscosity Delta scheme's dual constants (-mu0, inf),
    # which the fused and the generic staggered Delta paths hand K3
    d10, d20 = green.g0_constants(-mu0, float("inf"))
    report("g0_staggered_chain",
           [rel_err(k3(), p3()),
            rel_err(spk.g0_staggered_chain(g, f, d10, d20),
                    spk.g0_staggered_chain_plain(g, f, d10, d20))], k3, p3, n)
    # K4: the scalar chain (heat) on one component
    f1 = f[:1].contiguous()
    h10 = 1.0 / (2.0 * mu0)
    k4 = lambda: spk.g0_staggered_heat_chain(g, f1, h10)
    p4 = lambda: spk.g0_staggered_heat_chain_plain(g, f1, h10)
    report("g0_staggered_heat_chain", [rel_err(k4(), p4())], k4, p4, n)

    # K5 (6 and 3 components) and K6 with a device E and beta != 0
    A, B = green.collocated_constants(mu0, 0.4)
    r3 = r[:3].contiguous()
    k5 = lambda: spk.gamma_collocated_chain(g, r, A, B, E, 0.37)
    p5 = lambda: spk.gamma_collocated_chain_plain(g, r, A, B, E, 0.37)
    report("gamma_collocated_chain", [rel_err(k5(), p5())], k5, p5, n)
    k5h = lambda: spk.gamma_collocated_chain(g, r3, A, 0.0, E[:3], 0.37)
    p5h = lambda: spk.gamma_collocated_chain_plain(g, r3, A, 0.0, E[:3], 0.37)
    report("gamma_collocated_chain[heat]", [rel_err(k5h(), p5h())], k5h, p5h,
           n)
    Az, Bz = green.collocated_constants(-mu0, float("inf"))
    k6 = lambda: spk.gamma_collocated_zt_chain(g, r, Az, Bz, E, -0.2)
    p6 = lambda: spk.gamma_collocated_zt_chain_plain(g, r, Az, Bz, E, -0.2)
    report("gamma_collocated_zt_chain", [rel_err(k6(), p6())], k6, p6, n)

    # K5 at C = 9 (hyperelasticity) with the path's constants (lambda_0 =
    # 0, so B = 0; beta = 0), and once with B and beta set; K3 with the
    # full-gradient constants (c20 = 0 at lambda_0 = 0)
    tau9, E9 = rnd(9, *shape), rnd(9)
    Ah, Bh = green.hyper_constants(mu0, 0.0)
    k9 = lambda: spk.gamma_collocated_hyper_chain(g, tau9, Ah, Bh, E9, 0.0)
    p9 = lambda: spk.gamma_collocated_hyper_chain_plain(g, tau9, Ah, Bh, E9,
                                                        0.0)
    A4, B4 = green.hyper_constants(mu0, 0.4)
    errs = [rel_err(k9(), p9()),
            rel_err(spk.gamma_collocated_hyper_chain(g, tau9, A4, B4, E9,
                                                     0.37),
                    spk.gamma_collocated_hyper_chain_plain(g, tau9, A4, B4,
                                                           E9, 0.37))]
    report("gamma_collocated_chain[hyper]", errs, k9, p9, n)
    k3h = lambda: spk.g0_staggered_chain(g, f, -Ah, Bh)
    p3h = lambda: spk.g0_staggered_chain_plain(g, f, -Ah, Bh)
    report("g0_staggered_chain[hyper]", [rel_err(k3h(), p3h())], k3h, p3h, n)
    if timed:
        for name, x in (("g0_staggered_chain", f),
                        ("g0_staggered_heat_chain", f1),
                        ("gamma_collocated_chain", r),
                        ("gamma_collocated_chain[heat]", r3),
                        ("gamma_collocated_zt_chain", r[1:]),
                        ("gamma_collocated_chain[hyper]", tau9),
                        ("g0_staggered_chain[hyper]", f)):
            out[name]["library_ms"] = cuda_ms(
                lambda: fft.ifftn(fft.fftn(x), g.shape))
            log(f"  cuFFT rfftn+irfftn ({x.shape[0]}, {shape}) "
                f"{str(dtype)[6:]}: {out[name]['library_ms']:.4f} ms")
    return out


def check_cg_update(shape, dtype, timed):
    """Phase 2's CG vector update (``vector_kernels.cg_update``) on one
    grid at C = 6 and 3: eps and r against the twin's (the plain sequence
    the solver ran before the kernel) within phase 2's tolerance, delta
    against the twin's in float64, two calls the same bits, w untouched;
    with ``timed`` (C = 6) the kernel, the twin and the byte bound.
    Returns {"cg_update": numbers} when timed."""
    import torch
    from fibergen_tpu_torch.ops import vector_kernels as vk

    dev = torch.device("cuda")
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    gen = torch.Generator(device=dev).manual_seed(4321)
    tiny = float(torch.finfo(dtype).tiny)
    tiny64 = float(torch.finfo(torch.float64).tiny)
    out = {}
    for C in (6, 3):
        state = [torch.randn((C,) + tuple(shape), generator=gen, device=dev,
                             dtype=dtype) for _ in range(4)]
        state += [torch.tensor(0.83, dtype=dtype, device=dev),
                  torch.tensor(1.7, dtype=dtype, device=dev)]
        w0 = state[3].clone()
        k, t = [x.clone() for x in state], [x.clone() for x in state]
        d_k = vk.cg_update(*k, tiny)
        vk.cg_update_plain(*t, tiny, tiny)
        d_64 = vk.cg_update_plain(
            *(x.to(torch.float64, copy=True) for x in state), tiny64, tiny64)
        again = vk.cg_update(*[x.clone() for x in state], tiny)
        errs = [rel_err(k[0], t[0]), rel_err(k[1], t[1]), dot_err(d_k, d_64)]
        del t
        worst = max(e[0] for e in errs)
        rec = {"max_rel_err": worst, "max_abs_err": max(e[1] for e in errs)}
        line = (f"  {'cg_update':24s} C={C} {tuple(shape)} "
                f"{str(dtype)[6:]}: max rel err {worst:.3e} (delta "
                f"{errs[2][0]:.3e} of the float64 twin's), repeatable "
                f"{torch.equal(again, d_k)}")
        if timed and C == 6:
            itemsize = torch.empty((), dtype=dtype).element_size()
            n = math.prod(shape)
            rec["ms"] = cuda_ms(lambda: vk.cg_update(*k, tiny))
            rec["plain_ms"] = cuda_ms(
                lambda: vk.cg_update_plain(*k, tiny, tiny))
            rec["bound_ms"], rec["bound_by"] = bound_ms("cg_update", n,
                                                        itemsize)
            rec["library_ms"] = None
            line += (f", kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f}"
                     f" ms, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}"
                     f", {rec['bound_ms'] / rec['ms']:.1%} of it)")
            out["cg_update"] = rec
        log(line)
        if not (worst <= tol and torch.equal(again, d_k)
                and torch.equal(k[3], w0)):
            raise AssertionError(f"cg_update C={C}: error {worst:.3e} > "
                                 f"{tol:g}, or not repeatable, or w moved")
        del k, state
    return out


def check_laminate_heat(shape, dtype, timed):
    """Phase 2's dim-3 laminate (``material_kernels.laminate_heat``) on one
    grid, B = 3, both rules: the stress differences against the twin's
    (the plain sequence the material ran before the kernel) within 1e-6
    (float32) or 1e-12 (float64) of their largest, two calls the same bits;
    with ``timed`` (the laminate rule) the kernel, the twin and the byte
    bound.  Returns {"laminate_heat": numbers} when timed."""
    import torch
    from fibergen_tpu_torch.ops import material_kernels as mk

    dev = torch.device("cuda")
    tol = 1e-12 if dtype == torch.float64 else 1e-6
    gen = torch.Generator(device=dev).manual_seed(2626)
    rnd = lambda *s: torch.rand(s, generator=gen, device=dev, dtype=dtype)
    phi1 = rnd(*shape)
    phi1[rnd(*shape) < 0.6] = 0.0          # pure voxels, as in the mat
    phi2 = 1.0 - phi1
    n = 2.0 * rnd(3, *shape) - 1.0
    xs = [torch.randn((3,) + tuple(shape), generator=gen, device=dev,
                      dtype=dtype) for _ in range(3)]
    k1, k2, mu0 = 1.0, 10.0, 2.75
    out = {}
    for rule in mk.RULES:
        k = torch.empty((3, 3) + tuple(shape), dtype=dtype, device=dev)
        t, again = torch.empty_like(k), torch.empty_like(k)
        go = lambda o: mk.laminate_heat(phi1, phi2, n, xs, o, k1, k2, mu0,
                                        rule)
        plain = lambda o: mk.laminate_heat_plain(phi1, phi2, n, xs, o, k1, k2,
                                                 mu0, rule)
        go(k)
        plain(t)
        go(again)
        worst, err = rel_err(k, t)
        rec = {"max_rel_err": worst, "max_abs_err": err}
        line = (f"  {'laminate_heat':24s} {rule} B=3 {tuple(shape)} "
                f"{str(dtype)[6:]}: max rel err {worst:.3e}, repeatable "
                f"{torch.equal(again, k)}")
        if timed and rule == "laminate":
            itemsize = torch.empty((), dtype=dtype).element_size()
            rec["ms"] = cuda_ms(lambda: go(k))
            rec["plain_ms"] = cuda_ms(lambda: plain(t))
            rec["bound_ms"], rec["bound_by"] = bound_ms(
                "laminate_heat", math.prod(shape), itemsize)
            rec["library_ms"] = None
            line += (f", kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f}"
                     f" ms, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}"
                     f", {rec['bound_ms'] / rec['ms']:.1%} of it)")
            out["laminate_heat"] = rec
        log(line)
        if not (worst <= tol and torch.equal(again, k)):
            raise AssertionError(f"laminate_heat {rule}: error {worst:.3e} > "
                                 f"{tol:g}, or not repeatable")
        del k, t, again
    return out


# phase 2's batched chains (LSSolver.run_batched's): name -> (the WORK of
# one case, components, E's length or None, B at the timed 256^3 shape);
# B as the phase 8 batches take them (K3 B = 6, K4 B = 3, K5 B = 6 and, in
# heat, 3, K6 B = 5)
BATCHED = {
    "g0_staggered_chain_batched": ("g0_staggered_chain", 3, None, 6),
    "g0_staggered_heat_chain_batched": ("g0_staggered_heat_chain", 1, None,
                                        3),
    "gamma_collocated_chain_batched": ("gamma_collocated_chain", 6, 6, 6),
    "gamma_collocated_chain_batched[heat]": ("gamma_collocated_chain[heat]",
                                             3, 3, 3),
    "gamma_collocated_zt_chain_batched": ("gamma_collocated_zt_chain", 6, 6,
                                          5),
}


def check_batched_chains(shape, dtype, timed, sizes=None):
    """Phase 2's batched chains on one grid: each batched entry (B
    right-hand sides, each with its own E) bitwise (torch.equal) against B
    single launches of its chain and, at B = 1, against one; within the
    phase's tolerance of its plain twin; one launch counted per call.  B is
    3, or ``sizes[name]`` (only those names) with ``timed``, which also
    times the batched launch, the B single launches, the plain twin and
    cuFFT's batched pair (one rfftn and one irfftn over (B, C, nx, ny,
    nz)); the bound is B times the single chain's.  Returns {name:
    numbers}."""
    import torch
    import fibergen_tpu_torch as ft
    from fibergen_tpu_torch.ops import fft, green
    from fibergen_tpu_torch.ops import spectral_kernels as spk

    dev = torch.device("cuda")
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    g = ft.Grid(*shape, dx=1.0, dy=0.9, dz=1.1)
    gen = torch.Generator(device=dev).manual_seed(4321)
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev, dtype=dtype)
    itemsize = torch.empty((), dtype=dtype).element_size()
    c10, c20 = green.g0_constants(2.75, 0.4)
    A, B = green.collocated_constants(2.75, 0.4)
    Az, Bz = green.collocated_constants(-2.75, float("inf"))
    # name -> (batched wrapper, single wrapper, plain twin), each (f, E)
    fns = {
        "g0_staggered_chain_batched": (
            lambda f, E: spk.g0_staggered_chain_batched(g, f, c10, c20),
            lambda f, E: spk.g0_staggered_chain(g, f, c10, c20),
            lambda f, E: spk.g0_staggered_chain_batched_plain(g, f, c10,
                                                              c20)),
        "g0_staggered_heat_chain_batched": (
            lambda f, E: spk.g0_staggered_heat_chain_batched(g, f, c10),
            lambda f, E: spk.g0_staggered_heat_chain(g, f, c10),
            lambda f, E: spk.g0_staggered_heat_chain_batched_plain(g, f,
                                                                   c10)),
        "gamma_collocated_chain_batched": (
            lambda f, E: spk.gamma_collocated_chain_batched(g, f, A, B, E,
                                                            0.37),
            lambda f, E: spk.gamma_collocated_chain(g, f, A, B, E, 0.37),
            lambda f, E: spk.gamma_collocated_chain_batched_plain(
                g, f, A, B, E, 0.37)),
        "gamma_collocated_chain_batched[heat]": (
            lambda f, E: spk.gamma_collocated_chain_batched(g, f, A, 0.0, E,
                                                            0.37),
            lambda f, E: spk.gamma_collocated_chain(g, f, A, 0.0, E, 0.37),
            lambda f, E: spk.gamma_collocated_chain_batched_plain(
                g, f, A, 0.0, E, 0.37)),
        "gamma_collocated_zt_chain_batched": (
            lambda f, E: spk.gamma_collocated_zt_chain_batched(
                g, f, Az, Bz, E, -0.2),
            lambda f, E: spk.gamma_collocated_zt_chain(g, f, Az, Bz, E,
                                                       -0.2),
            lambda f, E: spk.gamma_collocated_zt_chain_batched_plain(
                g, f, Az, Bz, E, -0.2)),
    }
    out = {}
    for name, (single_name, C, ne, _) in BATCHED.items():
        if sizes is not None and name not in sizes:
            continue
        nb = 3 if sizes is None else sizes[name]
        batched, single, plain = fns[name]
        counter = name.split("[")[0]
        f = rnd(nb, C, *shape)
        if C == 6 and "zt" in name:
            f[:, 0] = -(f[:, 1] + f[:, 2])      # traceless
        E = None if ne is None else rnd(nb, ne)
        n0 = spk.launches[counter]
        ob = batched(f, E)
        torch.cuda.synchronize()
        assert spk.launches[counter] == n0 + 1, name
        same = all(torch.equal(ob[b], single(f[b], None if E is None
                                             else E[b])) for b in range(nb))
        one = torch.equal(batched(f[1:2], None if E is None else E[1:2])[0],
                          ob[1])
        err = rel_err(ob, plain(f, E))
        rec = {"B": nb, "max_rel_err": err[0], "max_abs_err": err[1],
               "bitwise": same and one}
        line = (f"  {name:36s} {tuple(shape)} {str(dtype)[6:]} B={nb}: "
                f"bitwise B single launches {same}, B = 1 {one}, max rel "
                f"err {err[0]:.3e}")
        if timed:
            xs = [f[b].contiguous() for b in range(nb)]
            Es = [None if E is None else E[b] for b in range(nb)]
            rec["ms"] = cuda_ms(lambda: batched(f, E))
            rec["singles_ms"] = cuda_ms(lambda: [single(x, e) for x, e in
                                                 zip(xs, Es)])
            rec["plain_ms"] = cuda_ms(lambda: plain(f, E), reps=5)
            rec["library_ms"] = cuda_ms(
                lambda: fft.ifftn(fft.fftn(f), g.shape))
            rec["bound_ms"], rec["bound_by"] = bound_ms(single_name,
                                                        g.nxyz * nb, itemsize)
            line += (f", batched {rec['ms']:.4f} ms, {nb} single launches "
                     f"{rec['singles_ms']:.4f} ms (batched / singles "
                     f"{rec['ms'] / rec['singles_ms']:.3f}), plain "
                     f"{rec['plain_ms']:.4f} ms, cuFFT batched pair "
                     f"{rec['library_ms']:.4f} ms, bound "
                     f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})")
            del xs
        log(line)
        if not (same and one and err[0] <= tol):
            raise AssertionError(f"{name} {shape}: bitwise {same}/{one}, "
                                 f"error {err[0]:.3e} (limit {tol:g})")
        out[name] = rec
        del f, ob
    torch.cuda.empty_cache()
    return out


def check_slab_kernels(shape, dtype, devices, timed):
    """Phase 6 on one grid: each slab kernel on x-slabs over ``devices``
    against its plain twin on the same slabs; with ``timed`` also kernel,
    twin and library (the same per-slab cuFFT stages around the exchange)
    times and the two exchanges' time.  On one slab, K1 and K2 in halo mode
    must equal the periodic kernels bitwise.  Returns {name: numbers}."""
    import torch
    import fibergen_tpu_torch as ft
    from fibergen_tpu_torch import parallel
    from fibergen_tpu_torch.parallel import comm
    from fibergen_tpu_torch.ops import green
    from fibergen_tpu_torch.ops import spectral_kernels as spk
    from fibergen_tpu_torch.ops import stencil_kernels as sk

    dev = torch.device(devices[0])
    d = len(devices)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    g = ft.Grid(*shape, dx=1.0, dy=0.9, dz=1.1)
    gen = torch.Generator(device=dev).manual_seed(4321)
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev, dtype=dtype)
    mesh = parallel.make_mesh(devices)
    par = parallel.SlabPar(mesh)
    sh = lambda a: parallel.shard_field(a, mesh)
    G = parallel.gather_field
    r, pp, u = rnd(6, *shape), rnd(6, *shape), rnd(3, *shape)
    mu, lam = 1.0 + rnd(*shape).abs(), 0.5 + rnd(*shape).abs()
    E = rnd(6)
    gam = torch.tensor(0.83, dtype=dtype, device=dev)
    gam_prev = torch.tensor(1.7, dtype=dtype, device=dev)
    mu0, lam0 = 2.75, 0.0
    rs, ps, us, ms, ls = sh(r), sh(pp), sh(u), sh(mu), sh(lam)
    mh = (comm.halo_x(ms), comm.halo_x(ls))
    beta = list(zip(comm.replicate(gam, par.devices),
                    comm.replicate(gam_prev, par.devices)))
    Es = comm.replicate(E, par.devices)
    itemsize = torch.empty((), dtype=dtype).element_size()
    n = g.nxyz
    out = {}

    def report(name, errs, kern, plain, library=None, call=None):
        """``kern``: the kernel's launches on every slab (the halo planes
        ready); ``call``: the slab-level call with its exchanges, where
        they are apart from the launches."""
        worst = max(e[0] for e in errs)
        rec = {"max_rel_err": worst, "max_abs_err": max(e[1] for e in errs)}
        line = f"  {name:34s} {tuple(shape)} {str(dtype)[6:]} x{d}: " \
               f"max rel err {worst:.3e}"
        if timed:
            rec["ms"], rec["plain_ms"] = cuda_ms(kern), cuda_ms(plain)
            rec["bound_ms"], rec["bound_by"] = bound_ms(name, n, itemsize)
            rec["library_ms"] = None if library is None else cuda_ms(library)
            line += (f", kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f}"
                     f" ms, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})")
            if library is not None:
                line += f", cuFFT stages {rec['library_ms']:.4f} ms"
            if call is not None:
                rec["call_ms"] = cuda_ms(call)
                line += f", with its halo exchange {rec['call_ms']:.4f} ms"
        log(line)
        if not worst <= tol:
            raise AssertionError(f"{name}: error {worst:.3e} > {tol:g}")
        out[name] = rec

    # K1 halo mode, step and init; twin: the plain K1 on each slab with its
    # halo planes attached
    rh, ph = comm.halo_x(rs), comm.halo_x(ps)
    h1 = [((rh[0][i], ph[0][i], mh[0][0][i], mh[1][0][i]),
           (rh[1][i], ph[1][i], mh[0][1][i], mh[1][1][i])) for i in range(d)]
    h1i = [((a[0], None) + a[2:], (b[0], None) + b[2:]) for a, b in h1]
    k1 = lambda: [sk.stress_div_beta(g, rs[i], ps[i], beta[i], ms[i], ls[i],
                                     mu0, lam0, halo=h1[i])
                  for i in range(d)]
    c1 = lambda: sk.stress_div_beta_slabs(g, rs, ps, beta, ms, ls, mu0, lam0,
                                          mh)
    p1 = lambda: [sk.stress_div_beta_plain(g, rs[i], ps[i], gam / gam_prev,
                                           ms[i], ls[i], mu0, lam0,
                                           halo=h1[i]) for i in range(d)]
    (f, p), ref = c1(), p1()
    report("stress_div_beta[halo]",
           [rel_err(G(f), G([x[0] for x in ref])),
            rel_err(G(p), G([x[1] for x in ref]))], k1, p1, call=c1)
    k1i = lambda: [sk.stress_div_beta(g, rs[i], None, None, ms[i], ls[i],
                                      mu0, lam0, halo=h1i[i])
                   for i in range(d)]
    c1i = lambda: sk.stress_div_beta_slabs(g, rs, None, None, ms, ls, mu0,
                                           lam0, mh)
    p1i = lambda: [sk.stress_div_beta_plain(g, rs[i], None, None, ms[i],
                                            ls[i], mu0, lam0,
                                            halo=h1i[i])[0]
                   for i in range(d)]
    fi = c1i()[0]
    report("stress_div_beta[halo,init]", [rel_err(G(fi), G(p1i()))], k1i,
           p1i, call=c1i)

    # K2 halo mode, dot and no-dot; the dot is the slabs' sums in order
    uh = comm.halo_x(us)
    h2 = [(uh[0][i], uh[1][i]) for i in range(d)]
    k2 = lambda: [sk.eps_from_u_dot(g, Es[i], us[i], ps[i], halo=h2[i])
                  for i in range(d)]
    c2 = lambda: sk.eps_from_u_dot_slabs(g, Es, us, ps)
    p2 = lambda: [sk.eps_from_u_dot_plain(g, E, us[i], ps[i], halo=h2[i])
                  for i in range(d)]
    (w, dot), ref = c2(), p2()
    dr = sum(float(x[1]) for x in ref)
    report("eps_from_u_dot[halo]",
           [rel_err(G(w), G([x[0] for x in ref])), dot_err(dot[0], dr)], k2,
           p2, call=c2)
    k2n = lambda: [sk.eps_from_u_dot(g, Es[i], us[i], halo=h2[i])
                   for i in range(d)]
    c2n = lambda: sk.eps_from_u_dot_slabs(g, Es, us)
    p2n = lambda: [sk.eps_from_u_dot_plain(g, E, us[i], halo=h2[i])[0]
                   for i in range(d)]
    wn = c2n()[0]
    report("eps_from_u_dot[halo,nodot]", [rel_err(G(wn), G(p2n()))], k2n,
           p2n, call=c2n)

    # K1 tau-sum mode (step and init) and K2 Delta mode in halo mode, the
    # staggered viscosity path on slabs: the tau sum is the slabs' sums
    # added in slab order (compared relative to the largest sum), the
    # Delta term reads mu without halo planes
    k1t = lambda: [sk.stress_div_beta(g, rs[i], ps[i], beta[i], ms[i], ls[i],
                                      mu0, lam0, want_tau_sum=True,
                                      halo=h1[i]) for i in range(d)]
    c1t = lambda: sk.stress_div_beta_slabs(g, rs, ps, beta, ms, ls, mu0,
                                           lam0, mh, want_tau_sum=True)
    p1t = lambda: [sk.stress_div_beta_plain(g, rs[i], ps[i], gam / gam_prev,
                                            ms[i], ls[i], mu0, lam0,
                                            want_tau_sum=True, halo=h1[i])
                   for i in range(d)]
    ft_, pt_, ts = c1t()
    ref = p1t()
    fti, _, tsi = sk.stress_div_beta_slabs(g, rs, None, None, ms, ls, mu0,
                                           lam0, mh, want_tau_sum=True)
    refi = [sk.stress_div_beta_plain(g, rs[i], None, None, ms[i], ls[i], mu0,
                                     lam0, want_tau_sum=True, halo=h1i[i])
            for i in range(d)]
    report("stress_div_beta[halo,tau_sum]",
           [rel_err(G(ft_), G([x[0] for x in ref])),
            rel_err(G(pt_), G([x[1] for x in ref])),
            rel_err(ts[0], sum(x[2] for x in ref)),
            rel_err(G(fti), G([x[0] for x in refi])),
            rel_err(tsi[0], sum(x[2] for x in refi))], k1t, p1t, call=c1t)
    tau2c = -1.0 / (2.0 * mu0)
    k2d = lambda: [sk.eps_from_u_dot(g, Es[i], us[i], ps[i], mu_x=ms[i],
                                     tau2c=tau2c, mu0=mu0, halo=h2[i])
                   for i in range(d)]
    c2d = lambda: sk.eps_from_u_dot_slabs(g, Es, us, ps, mu_x=ms,
                                          tau2c=tau2c, mu0=mu0)
    p2d = lambda: [sk.eps_from_u_dot_plain(g, E, us[i], ps[i], mu_x=ms[i],
                                           tau2c=tau2c, mu0=mu0, halo=h2[i])
                   for i in range(d)]
    (wd, dotd), ref = c2d(), p2d()
    report("eps_from_u_dot[halo,delta]",
           [rel_err(G(wd), G([x[0] for x in ref])),
            dot_err(dotd[0], sum(float(x[1]) for x in ref))], k2d, p2d,
           call=c2d)

    if d == 1:
        # one slab wraps its own halo: bitwise the periodic kernels, in
        # every mode
        f0, p0 = sk.stress_div_beta(g, r, pp, (gam, gam_prev), mu, lam, mu0,
                                    lam0)
        fi0, _ = sk.stress_div_beta(g, r, None, None, mu, lam, mu0, lam0)
        w0, dot0 = sk.eps_from_u_dot(g, E, u, pp)
        wn0, _ = sk.eps_from_u_dot(g, E, u)
        ft0, pt0, ts0 = sk.stress_div_beta(g, r, pp, (gam, gam_prev), mu,
                                           lam, mu0, lam0, want_tau_sum=True)
        wd0, dotd0 = sk.eps_from_u_dot(g, E, u, pp, mu_x=mu, tau2c=tau2c,
                                       mu0=mu0)
        same = all(torch.equal(a, b) for a, b in (
            (f[0], f0), (p[0], p0), (fi[0], fi0), (w[0], w0), (wn[0], wn0),
            (dot[0], dot0)))
        same_visc = all(torch.equal(a, b) for a, b in (
            (ft_[0], ft0), (pt_[0], pt0), (ts[0], ts0), (wd[0], wd0),
            (dotd[0], dotd0)))
        log(f"  K1/K2 halo mode on one slab bitwise equal to the periodic "
            f"kernels: {same}; K1 tau-sum and K2 Delta halo mode: "
            f"{same_visc}")
        assert same, "K1/K2 halo mode differs from the periodic kernels"
        assert same_visc, ("K1 tau-sum / K2 Delta halo mode differs from "
                           "the periodic kernels")

    # the kz-slab chains; library: the per-slab cuFFT stages around the same
    # exchanges, with no apply
    c10, c20 = green.g0_constants(mu0, lam0)
    fs = sh(rnd(3, *shape))
    f1 = sh(rnd(1, *shape))
    A, B = green.collocated_constants(mu0, 0.4)
    Az, Bz = green.collocated_constants(-mu0, float("inf"))
    r3 = sh(r[:3].contiguous())
    ident = lambda y, j, off, w: y
    stages = lambda x: (lambda: spk._slab_chain_plain(par, g, x, ident))
    for name, kern, plain, lib in (
            ("g0_staggered_chain_slab",
             lambda: spk.g0_staggered_chain_slab(par, g, fs, c10, c20),
             lambda: spk.g0_staggered_chain_slab_plain(par, g, fs, c10, c20),
             stages(fs)),
            ("g0_staggered_heat_chain_slab",
             lambda: spk.g0_staggered_heat_chain_slab(par, g, f1, 0.18),
             lambda: spk.g0_staggered_heat_chain_slab_plain(par, g, f1, 0.18),
             stages(f1)),
            ("gamma_collocated_chain_slab",
             lambda: spk.gamma_collocated_chain_slab(par, g, rs, A, B, Es,
                                                     0.37),
             lambda: spk.gamma_collocated_chain_slab_plain(par, g, rs, A, B,
                                                           Es, 0.37),
             stages(rs)),
            ("gamma_collocated_chain_slab[heat]",
             lambda: spk.gamma_collocated_chain_slab(par, g, r3, A, 0.0,
                                                     E[:3], 0.37),
             lambda: spk.gamma_collocated_chain_slab_plain(par, g, r3, A, 0.0,
                                                           E[:3], 0.37),
             stages(r3)),
            ("gamma_collocated_zt_chain_slab",
             lambda: spk.gamma_collocated_zt_chain_slab(par, g, rs, Az, Bz,
                                                        Es, -0.2),
             lambda: spk.gamma_collocated_zt_chain_slab_plain(
                 par, g, rs, Az, Bz, Es, -0.2),
             stages([x[1:] for x in rs]))):
        report(name, [rel_err(G(kern()), G(plain()))], kern, plain, lib)

    # the finite-strain slab chains with the sharded Newton path's
    # constants (lambda_0 = 0: B = 0, beta = 0), K5 at C = 9 once more with
    # B and beta set; each also against its whole-field chain on the same
    # input
    tau9, E9 = rnd(9, *shape), rnd(9)
    t9s, E9s = sh(tau9), comm.replicate(E9, par.devices)
    Ah, Bh = green.hyper_constants(mu0, 0.0)
    A4, B4 = green.hyper_constants(mu0, 0.4)
    k9 = lambda: spk.gamma_collocated_hyper_chain_slab(par, g, t9s, Ah, Bh,
                                                       E9s, 0.0)
    p9 = lambda: spk.gamma_collocated_hyper_chain_slab_plain(par, g, t9s, Ah,
                                                             Bh, E9s, 0.0)
    errs = [rel_err(G(k9()), G(p9())),
            rel_err(G(k9()), spk.gamma_collocated_hyper_chain(
                g, tau9, Ah, Bh, E9, 0.0)),
            rel_err(G(spk.gamma_collocated_hyper_chain_slab(
                par, g, t9s, A4, B4, E9s, 0.37)),
                G(spk.gamma_collocated_hyper_chain_slab_plain(
                    par, g, t9s, A4, B4, E9s, 0.37)))]
    report("gamma_collocated_chain_slab[hyper]", errs, k9, p9, stages(t9s))
    del tau9
    k3h = lambda: spk.g0_staggered_chain_slab(par, g, fs, -Ah, Bh)
    p3h = lambda: spk.g0_staggered_chain_slab_plain(par, g, fs, -Ah, Bh)
    errs = [rel_err(G(k3h()), G(p3h())),
            rel_err(G(k3h()), spk.g0_staggered_chain(g, G(fs), -Ah, Bh))]
    report("g0_staggered_chain_slab[hyper]", errs, k3h, p3h, stages(fs))
    if timed:
        # the two exchanges of a step's chain (C = 3, K3): x-slab spectrum
        # to kz-slabs and back
        cdt = torch.complex64 if dtype == torch.float32 else torch.complex128
        spec = [torch.zeros((3, g.nx // d, g.ny, g.nzc), dtype=cdt,
                            device=x) for x in par.devices]
        split = par.kz_split(g.nzc)
        kzs = comm.to_kz(spec, split, par.devices)
        out["exchange_ms"] = cuda_ms(
            lambda: comm.from_kz(comm.to_kz(spec, split, par.devices),
                                 g.nx // d, par.devices))
        nbytes = sum(t.numel() for t in spec) * spec[0].element_size()
        out["exchange_bound_ms"] = 1e3 * 4 * nbytes / H100_BYTES_PER_S
        log(f"  exchanges x-slabs -> kz-slabs -> x-slabs, 3 components: "
            f"{out['exchange_ms']:.4f} ms for 2 x {nbytes / 1e6:.1f} MB, "
            f"each read and written once: bound "
            f"{out['exchange_bound_ms']:.4f} ms")
        del spec, kzs
    return out


# the traceless load cases of the effective viscosity (fibergen_tpu
# api._effective_viscosity): xx-yy, yy-zz and the three shears
EFF_VISC = [[1.0, -1, 0, 0, 0, 0], [0, 1.0, -1, 0, 0, 0],
            [0, 0, 0, 1.0, 0, 0], [0, 0, 0, 0, 1.0, 0], [0, 0, 0, 0, 0, 1.0]]
# the mixed_bc demo (demo/hyperelasticity/mixed_bc): SVK matrix mu = lam =
# 10, sphere (R = 0.3) mu = 10, lam = 100; p11 = 0, s11 = 1, e22 = 0.1; and
# the JAX package's answer at n = 32 on its own voxelization of the sphere
# (tests/test_demos.py: F11, P22, P33)
MIXED_BC_DEMO = dict(fiber=(10.0, 100.0), matrix=(10.0, 10.0), s11=1.0,
                     e22=0.1, pinned=(0.9886118258, 3.6713797927,
                                      1.2379378454))


def load_cases(run_counted, res32, path_launches, n=256, dtype="float32",
               device="cuda", nl=64, nh=32):
    """Phase 8: the load-case layer.  ``run_counted(solver, label, path,
    fn, batched)`` runs ``fn`` (the solver's run by default) with every
    launch count set to 0 and checks the path's kernels; ``res32`` holds
    phase 4's pure-strain iterations per path.  Each batched path runs
    batched, sequential, sequential, batched (the two pairs in turns); the
    batched run launches its batched chain once per step and once for the
    init, K1 and K2 (where the path has them) once per case as well."""
    import numpy as np
    import torch
    import fibergen_tpu_torch as ft
    from fibergen_tpu_torch.core import voigt
    cuda = device == "cuda"
    opt = dict(error_estimator="residual", tol=1e-6, check_every=8,
               maxiter=4000)
    log(f"phase 8: load cases, {n}^3 {dtype}, residual tol 1e-6, "
        f"check_every 8")

    def batched_vs_sequential(path, Es):
        s = path_solver(n, dtype, device, path, **opt)
        dim, Es = s.dim, np.asarray(Es, dtype=np.float64)

        def batched():
            t0 = time.perf_counter()
            assert not s.run_batched(Es)
            return time.perf_counter() - t0

        def sequential():
            S, its, t0 = np.zeros((len(Es), dim)), 0, time.perf_counter()
            for i, E in enumerate(Es):
                s.set_bc_projector(voigt.id4(dim))
                s.set_strain(E)
                s.set_stress(np.zeros(dim))
                assert not s.run()
                S[i] = s.calc_mean_stress()
                its += len(s.residuals)
            return S, its, time.perf_counter() - t0

        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t_b = []
        _, got = run_counted(s, f"{path} run_batched B={len(Es)}", path,
                             lambda: t_b.append(batched()), batched=True)
        peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else 0.0
        path_launches[f"{path} [batched]"] = got
        its_b, Sb = len(s.residuals), s.calc_mean_stress_batched()
        steps = -(-its_b // opt["check_every"]) * opt["check_every"]
        chain = next(BATCHED_CHAIN[k] for k in PATH_KERNELS[path]
                     if k in BATCHED_CHAIN)
        per_case = {k: v for k, v in got.items() if v and k != chain}
        log(f"  {path} B={len(Es)}: {chain} {got[chain]} launches for "
            f"{steps} steps and the init; {per_case}")
        assert got[chain] == steps + 1, (path, got[chain], steps)
        assert all(v == len(Es) * (steps + 1) for v in per_case.values())
        Ss, its_s, t_s = sequential()
        _, _, t_s2 = sequential()
        t_b.append(batched())
        d = float(np.max(np.abs(Sb - Ss)) / np.max(np.abs(Ss)))
        log(f"  {path} B={len(Es)}: batched {its_b} iterations, wall "
            f"{t_b[0]:.4f} / {t_b[1]:.4f} s; sequential {its_s} iterations "
            f"in all, wall {t_s:.4f} / {t_s2:.4f} s; batched / sequential "
            f"{sum(t_b) / (t_s + t_s2):.3f}; peak device memory "
            f"{peak:.2f} GiB; means rel diff {d:.3e}")
        assert np.all(np.isfinite(Sb)) and d <= 1e-5, (path, d)
        res32[f"{path} [batched]"] = (its_b, Sb)
        del s
        if cuda:
            torch.cuda.empty_cache()
        return Sb

    # effective stiffness (api.calc_effective_properties, elasticity)
    S = batched_vs_sequential("elasticity", np.eye(6)).T
    C = S.copy()
    C[:, 3:6] *= 0.5
    S1, S2 = S[0:3, 0:3].sum(), np.trace(S)
    lam, mu = (2 * S1 - S2) / 15.0, (3 * S2 - S1) / 30.0
    fit = np.zeros((6, 6))
    fit[0:3, 0:3] = lam
    np.fill_diagonal(fit[0:3, 0:3], lam + 2 * mu)
    fit[3, 3] = fit[4, 4] = fit[5, 5] = 2 * mu
    log(f"  C_eff (Voigt):\n{np.array2string(C, precision=6)}")
    log(f"  isotropic fit: K_eff {lam + 2.0 / 3.0 * mu:.6f}, mu_eff "
        f"{mu:.6f}, lambda_eff {lam:.6f}, relative error of fit "
        f"{np.linalg.norm(S - fit) / np.linalg.norm(S):.3e}")
    K = batched_vs_sequential("heat", np.eye(3)).T
    log(f"  conductivity:\n{np.array2string(K, precision=6)}")
    batched_vs_sequential("elasticity-collocated", np.eye(6))
    batched_vs_sequential("heat-collocated", np.eye(3))
    batched_vs_sequential("viscosity-collocated", EFF_VISC)

    # uniaxial stress: strain xx prescribed, every other stress zero
    P = np.zeros((6, 6))
    P[0, 0] = 1.0
    for path in ("elasticity", "elasticity-collocated"):
        s = path_solver(n, dtype, device, path, **opt)
        s.set_bc_projector(P)
        s.set_strain([0.01, 0, 0, 0, 0, 0])
        s.set_stress(np.zeros(6))
        fail, got = run_counted(s, f"{path} uniaxial stress", path)
        path_launches[f"{path} [mixed BC]"] = got
        Sm, bce = s.calc_mean_stress(), s.bc_error()
        side = float(np.max(np.abs(Sm[1:])) / abs(Sm[0]))
        log(f"  {path} uniaxial stress: {len(s.residuals)} iterations "
            f"(pure strain: {res32.get(path, ('not run',))[0]}), "
            f"solve_time {s.solve_time:.4f} s, bc_error {bce:.3e}, "
            f"max |stress-controlled mean stress| / |sigma_xx| {side:.3e}, "
            f"mean stress {Sm.tolist()}")
        assert not fail and bce <= s.opt.bc_tol and side <= 1e-5, path
        res32[f"{path} [mixed BC]"] = (len(s.residuals), Sm)
        del s

    # the linear loadstep loop against one step, 64^3 float64
    lopt = dict(error_estimator="residual", tol=1e-11, check_every=8,
                maxiter=4000)

    def per_loadstep(s, label, path="elasticity"):
        counts, solve = [], s.run_solver

        def counted(E, S):
            k = len(s.residuals)
            solve(E, S)
            counts.append(len(s.residuals) - k)
        s.run_solver = counted
        assert not run_counted(s, label, path)[0]
        return counts, s.calc_mean_stress()

    one, S1 = per_loadstep(sphere_solver(nl, "float64", device, **lopt),
                           f"{nl}^3 float64 one loadstep")
    for method, eopt in (("cg", lopt), ("basic", dict(
            error_estimator="epsilon", tol=1e-8, maxiter=4000))):
        for order in (0, 1):
            counts, S4 = per_loadstep(sphere_solver(
                nl, "float64", device, method=method, loadsteps=4,
                loadstep_extrapolation_order=order, **eopt),
                f"{nl}^3 float64 {method} 4 loadsteps, order {order}")
            d = float(np.max(np.abs(S4 - S1)) / np.max(np.abs(S1)))
            log(f"  {nl}^3 float64 {method}, 4 loadsteps, polynomial "
                f"extrapolation of order {order}: iterations per loadstep "
                f"{counts} (one loadstep: {one}), final mean stress rel "
                f"diff to the single step {d:.3e}")
            assert d <= (1e-9 if method == "cg" else 1e-6), (method, d)

    # the mixed_bc demo's finite-strain load
    c = MIXED_BC_DEMO
    phi = sphere_phi(nh, "float64")
    mat = ft.convert.material_from_numpy(
        [("pore", *c["fiber"], phi), ("matrix", *c["matrix"], 1.0 - phi)],
        dim=9, law="svk", device=device)
    s = ft.LSSolver(ft.Grid(nh, nh, nh), mat, ft.SolverOptions(
        mode="hyperelasticity", tol=1e-10, check_every=8, maxiter=4000),
        device=device)
    Pm = voigt.id4(9)
    Pm[0, 0] = 0.0
    E = np.zeros(9)
    E[1] = c["e22"]
    s.set_bc_projector(Pm)
    s.set_strain(E + voigt.dyad4_mv(Pm, voigt.identity_vec(9)))
    s.set_stress([c["s11"]] + [0.0] * 8)
    fail, got = run_counted(s, f"{nh}^3 float64 mixed_bc demo",
                            "hyperelasticity")
    path_launches["hyperelasticity [mixed BC]"] = got
    F, Pk = s.calc_mean_strain(), s.calc_mean_stress()
    pin = c["pinned"]
    log(f"  {nh}^3 float64 mixed_bc demo: {s.newton_iterations} (outer, "
        f"inner) iterations, solve_time {s.solve_time:.3f} s, bc_error "
        f"{s.bc_error():.3e}, P11 {Pk[0]:.10f} (prescribed 1), F22 "
        f"{F[1]:.10f} (prescribed 1.1), free F11 {F[0]:.10f} P22 "
        f"{Pk[1]:.10f} P33 {Pk[2]:.10f}; the JAX package's demo (its own "
        f"voxelized sphere) F11 {pin[0]} P22 {pin[1]} P33 {pin[2]}")
    assert not fail and abs(Pk[0] - 1.0) <= s.opt.bc_tol
    assert abs(F[1] - 1.1) <= 1e-12 and np.all(np.isfinite(Pk))


def general_materials(run_counted, res32, path_launches, n=256):
    """Phase 9: general linear materials (GENERAL_PATHS) at n^3 float32,
    residual tol 1e-6, check_every 8.  ``run_counted`` and ``res32`` as in
    :func:`load_cases`; the launches of each timed solve go into
    ``path_launches``."""
    import numpy as np
    import torch
    from fibergen_tpu_torch.core import voigt
    opt = dict(error_estimator="residual", tol=1e-6, check_every=8,
               maxiter=4000)
    log(f"phase 9: general linear materials, {n}^3 float32, residual tol "
        f"1e-6, check_every 8")

    def timed(s, label, path):
        """A warm solve: one run, then the counted one with its wall time
        and peak device memory."""
        assert not s.run()                       # warm-up
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        fail, got = run_counted(s, label, path)
        wall = time.perf_counter() - t0
        its, S = len(s.residuals), s.calc_mean_stress()
        log(f"  {label}: {its} iterations, final_rel {s.residuals[-1]:.3e}, "
            f"wall {wall:.4f} s (solve_time {s.solve_time:.4f} s), peak "
            f"device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, mean "
            f"stress {S.tolist()}")
        assert not fail and s.residuals[-1] <= 1e-6 and np.all(np.isfinite(S))
        return its, S, got

    res = {}
    for path in GENERAL_PATHS:
        s = general_path_solver(n, "float32", "cuda", path, **opt)
        *res[path], path_launches[path] = timed(s, f"{n}^3 float32 {path}",
                                                path)
        del s
        torch.cuda.empty_cache()
    res32.update(res)

    # path 1 in float64
    its, S32 = res["elasticity-general"]
    s64 = general_path_solver(n, "float64", "cuda", "elasticity-general",
                              **opt)
    assert not run_counted(s64, f"{n}^3 float64 elasticity-general",
                           "elasticity-general")[0]
    S64 = s64.calc_mean_stress()
    d = float(np.max(np.abs(S64 - S32)) / np.max(np.abs(S64)))
    log(f"  {n}^3 float64 elasticity-general: {len(s64.residuals)} "
        f"iterations, final_rel {s64.residuals[-1]:.3e}, rel diff to "
        f"float32 {d:.3e}")
    assert abs(len(s64.residuals) - its) <= 2 and d <= 1e-5
    del s64
    torch.cuda.empty_cache()

    # the route oracle: the bench's isotropic phases as general and as tiso
    # laws on the generic route against phase 4's K1/K2 elasticity solve
    its0, S0 = res32["elasticity"]
    for fibre in ("general-iso", "tiso-iso"):
        s = general_solver(n, "float32", "cuda", fibre, **opt)
        fail, _ = run_counted(s, f"{n}^3 float32 {fibre} (route oracle)",
                              "elasticity-general")
        S = s.calc_mean_stress()
        d = float(np.max(np.abs(S - S0)) / np.max(np.abs(S0)))
        log(f"  route oracle {fibre}: {len(s.residuals)} iterations "
            f"(phase 4's K1/K2 elasticity: {its0}), mean stress rel diff "
            f"{d:.3e}")
        assert not fail and abs(len(s.residuals) - its0) <= 1 and d <= 1e-5
        del s
        torch.cuda.empty_cache()

    # the effective stiffness of path 1: batched against sequential
    s = general_path_solver(n, "float32", "cuda", "elasticity-general", **opt)
    t0 = time.perf_counter()
    fail, got = run_counted(s, f"{n}^3 float32 elasticity-general "
                               f"run_batched B=6", "elasticity-general",
                            lambda: s.run_batched(np.eye(6)), batched=True)
    t_b = time.perf_counter() - t0
    assert not fail
    its_b, Sb = len(s.residuals), s.calc_mean_stress_batched()
    path_launches["elasticity-general [batched]"] = got
    Ss, its_s, t0 = np.zeros((6, 6)), 0, time.perf_counter()
    for i in range(6):
        s.set_bc_projector(voigt.id4(6))
        s.set_strain(np.eye(6)[i])
        s.set_stress(np.zeros(6))
        assert not s.run()
        Ss[i] = s.calc_mean_stress()
        its_s += len(s.residuals)
    t_s = time.perf_counter() - t0
    d = float(np.max(np.abs(Sb - Ss)) / np.max(np.abs(Ss)))
    C = Sb.T.copy()
    C[:, 3:6] *= 0.5
    sym = {"C22/C33": (C[1, 1], C[2, 2]), "C12/C13": (C[0, 1], C[0, 2]),
           "C55/C66": (C[4, 4], C[5, 5])}
    sym = {k: abs(a - b) / abs(a) for k, (a, b) in sym.items()}
    log(f"  elasticity-general B=6: batched {its_b} iterations, wall "
        f"{t_b:.4f} s; sequential {its_s} iterations in all, wall "
        f"{t_s:.4f} s; means rel diff {d:.3e}")
    log(f"  C_eff (Voigt) of the tiso fibre (axis e_x) in its matrix:\n"
        f"{np.array2string(C, precision=4)}")
    log(f"  transverse symmetry, relative: "
        f"{', '.join(f'{k} {v:.3e}' for k, v in sym.items())}")
    assert np.all(np.isfinite(Sb)) and d <= 1e-5
    assert all(v <= 1e-4 for v in sym.values()), sym
    del s
    torch.cuda.empty_cache()

    # the kernel path against the plain path, 48^3 float64 (phase 3's
    # limits); the rules that treat interface voxels apart on a sphere
    # blurred over 1.5 voxels
    copt = dict(error_estimator="residual", tol=1e-8, check_every=4,
                maxiter=1000)
    cases = [(p, GENERAL_PATHS[p][3:], GENERAL_PATHS[p][:3], None)
             for p in ("elasticity-general", "elasticity-tiso-field",
                       "elasticity-reuss", "heat-aniso")]
    cases += [(f"elasticity-{rule}", (fibre,),
               ("elasticity", "staggered", rule), 1.5)
              for rule, fibre in (("maximum", "tiso"), ("random", "tiso"),
                                  ("fiftyfifty", "tiso"), ("split", "iso"),
                                  ("iso", "iso"))]
    for label, (fibre,), (mode, scheme, rule), blur in cases:
        path = label if label in GENERAL_PATHS else "elasticity-general"
        s_cpu, s_gpu = (general_solver(48, "float64", dev, fibre, mode,
                                       scheme, rule, blur=blur, **copt)
                        for dev in ("cpu", "cuda"))
        assert not s_cpu.run()
        assert not run_counted(s_gpu, f"48^3 float64 {label}", path)[0]
        rc, rg = np.asarray(s_cpu.residuals), np.asarray(s_gpu.residuals)
        res_rel = float(np.max(np.abs(rg - rc) / np.abs(rc))) \
            if len(rc) == len(rg) else float("inf")
        Sc, Sg = s_cpu.calc_mean_stress(), s_gpu.calc_mean_stress()
        s_rel = float(np.max(np.abs(Sg - Sc)) / np.max(np.abs(Sc)))
        log(f"  {label}: iterations cpu {len(rc)} cuda {len(rg)}, residual "
            f"history max rel diff {res_rel:.3e}, mean stress max rel diff "
            f"{s_rel:.3e}")
        assert len(rc) == len(rg), f"{label}: iteration counts differ"
        assert res_rel <= 1e-9 and s_rel <= 1e-10, label


def interfaces_and_dfg(run_counted, res32, path_launches, n=256,
                       device="cuda", nk=64, nm=64, nc=48):
    """Phase 10: interface laminates, the doubly-fine grid and the generic
    staggered Delta path (INTERFACE_PATHS) at n^3 float32, residual tol
    1e-6, check_every 8; ``run_counted`` and ``res32`` as in
    :func:`load_cases`, the launches of each timed solve into
    ``path_launches``.  Each path prints its iterations, wall, peak memory
    and launches; the generic paths launch their chain and neither K1 nor
    K2 (run_counted).  Nunan-Keller runs at nk^3, the mixed BCs at nm^3,
    the comparison with the CPU at nc^3."""
    import numpy as np
    import torch
    import fibergen_tpu_torch as ft
    from fibergen_tpu_torch.core import voigt
    from fibergen_tpu_torch.materials import dfg, laminate
    cuda = device == "cuda"
    opt = dict(error_estimator="residual", tol=1e-6, check_every=8,
               maxiter=4000)
    log(f"phase 10: interface laminates, the doubly-fine grid, the generic "
        f"staggered Delta path; {n}^3 float32, residual tol 1e-6, "
        f"check_every 8")

    def solve(s, label, path, warm=True):
        """A solve (after a warm-up run with ``warm``) with its wall time,
        peak device memory and launches; (iterations, mean stress, wall)."""
        if warm:
            assert not s.run()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        fail, got = run_counted(s, label, path)
        wall = time.perf_counter() - t0
        its, S = len(s.residuals), s.calc_mean_stress()
        log(f"  {label}: {its} iterations, final_rel {s.residuals[-1]:.3e}, "
            f"wall {wall:.4f} s ({1e3 * wall / its:.2f} ms an iteration), "
            f"peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30 if cuda else 0:.2f} "
            f"GiB, mean "
            f"stress {S.tolist()}")
        assert not fail and s.residuals[-1] <= opt["tol"]
        assert np.all(np.isfinite(S))
        return its, S, wall, got

    # a. the bench's phases on the 2n^3 fine sphere (DfgMaterial)
    path = "elasticity-full-staggered"
    s = interface_solver(n, "float32", device, path, **opt)
    its, S, wall, path_launches[path] = solve(
        s, f"{n}^3 float32 {path} ({2 * n}^3 fine phases)", path)
    res32[path] = (its, S)
    its0, S0 = res32["elasticity"]
    d = float(np.max(np.abs(S - S0)) / np.max(np.abs(S0)))
    log(f"  {path}: mean stress rel diff to phase 4's staggered solve on "
        f"the {n}^3 sphere {d:.3e} ({its0} iterations there)")
    F = torch.randn((6,) + s.grid.shape, device=device,
                    generator=torch.Generator(device).manual_seed(0))
    t_law = cuda_ms(lambda: s.mat.stress_diff(F, s.mu_0, 0.0), reps=5,
                    warm=1)
    t_pr = cuda_ms(lambda: dfg.restrict(dfg.prolong(F)), reps=5, warm=1)
    log(f"  {path}: prolong -> fine law -> restrict {t_law:.3f} ms, of it "
        f"prolong + restrict {t_pr:.3f} ms; an iteration "
        f"{1e3 * wall / its:.3f} ms, the stress difference "
        f"{t_law / (1e3 * wall / its):.1%} of it")
    del s, F
    torch.cuda.empty_cache()

    # b. the laminate: a route oracle on the sharp sphere (the Voigt rule
    # there), then the smooth sphere on both grids between Reuss and Voigt
    geo = smooth_sphere(n, "float32")
    s = interface_solver(n, "float32", device, "elasticity-laminate",
                         geometry=(sphere_phi(n, "float32"), geo[1]), **opt)
    its, S, _, _ = solve(s, f"{n}^3 float32 elasticity-laminate on the "
                            f"sharp sphere (route oracle)",
                         "elasticity-laminate", warm=False)
    d = float(np.max(np.abs(S - S0)) / np.max(np.abs(S0)))
    log(f"  route oracle: {its} iterations (phase 4's K1/K2 elasticity: "
        f"{its0}), mean stress rel diff {d:.3e}")
    assert abs(its - its0) <= 1 and d <= 1e-5
    del s
    sxx = {}
    for path in ("elasticity-laminate", "elasticity-laminate-collocated"):
        s = interface_solver(n, "float32", device, path, geometry=geo, **opt)
        its, S, wall, path_launches[path] = solve(
            s, f"{n}^3 float32 {path} (smooth sphere)", path)
        res32[path] = (its, S)
        sxx[path] = S[0]
        if path == "elasticity-laminate":
            F = torch.randn((6,) + s.grid.shape, device=device,
                            generator=torch.Generator(device).manual_seed(1))
            view = s.mat._two_phase_view(F)
            t_pk1 = cuda_ms(lambda: s.mat.pk1(F), reps=5, warm=1)
            t_jump = cuda_ms(lambda: s.mat._phase_strains(F, view), reps=5,
                             warm=1)
            log(f"  {path}: the laminate's stress {t_pk1:.3f} ms, of it the "
                f"jump solve (phase strains) {t_jump:.3f} ms; an iteration "
                f"{1e3 * wall / its:.3f} ms, the jump solve "
                f"{t_jump / (1e3 * wall / its):.1%} of it")
            # the per-voxel 3x3 solve: Cramer's rule on the component
            # fields against a batched torch.linalg.solve
            g = torch.Generator(device).manual_seed(2)
            A = torch.randn((3, 3) + s.grid.shape, device=device, generator=g)
            K = [[sum(A[i, k] * A[j, k] for k in range(3)) + (3.0 if i == j
                                                               else 0.0)
                  for j in range(3)] for i in range(3)]
            b = list(torch.randn((3,) + s.grid.shape, device=device,
                                 generator=g))
            Km = torch.stack([torch.stack(r, -1) for r in K], -2)
            bm = torch.stack(b, -1)[..., None]
            t_cr = cuda_ms(lambda: laminate._solve3(K, b), reps=5, warm=1)
            t_ls = cuda_ms(lambda: torch.linalg.solve(Km, bm), reps=5, warm=1)
            x_cr = torch.stack(laminate._solve3(K, b), -1)
            err = float((x_cr - torch.linalg.solve(Km, bm)[..., 0]).abs().max()
                        / x_cr.abs().max())
            log(f"  {n}^3 float32 per-voxel 3x3 jump solve: Cramer's rule on "
                f"the fields {t_cr:.3f} ms, batched torch.linalg.solve "
                f"{t_ls:.3f} ms, max rel diff {err:.2e}")
            del A, K, b, Km, bm, x_cr, F, view
        del s
        torch.cuda.empty_cache()
    for rule in ("voigt", "reuss"):
        s = interface_solver(n, "float32", device, "elasticity-laminate",
                             rule=rule, geometry=geo, **opt)
        assert not s.run()
        sxx[rule] = s.calc_mean_stress()[0]
        del s
    log(f"  smooth sphere sigma_xx: reuss {sxx['reuss']:.7f} <= laminate "
        f"{sxx['elasticity-laminate']:.7f} (collocated "
        f"{sxx['elasticity-laminate-collocated']:.7f}) <= voigt "
        f"{sxx['voigt']:.7f}")
    assert sxx["reuss"] <= sxx["elasticity-laminate"] <= sxx["voigt"]

    # c. heat; e. fluidity mixing, both on the smooth sphere
    for path in ("heat-laminate", "viscosity-fluidity",
                 "viscosity-fluidity-collocated"):
        s = interface_solver(n, "float32", device, path, geometry=geo, **opt)
        *_, path_launches[path] = solve(s, f"{n}^3 float32 {path} (smooth "
                                           f"sphere)", path)
        del s
    del geo
    torch.cuda.empty_cache()

    # d. staggered viscosity through the generic Delta path: the maximum
    # rule is the Voigt rule on the sharp sphere (a route oracle against
    # phase 4's K1 tau-sum route), and phases with a lambda
    its0, S0 = res32["viscosity"]
    for path in ("viscosity-generic", "viscosity-lambda"):
        s = interface_solver(n, "float32", device, path, **opt)
        its, S, _, path_launches[path] = solve(s, f"{n}^3 float32 {path}",
                                               path)
        res32[path] = (its, S)
        if path == "viscosity-generic":
            d = float(np.max(np.abs(S - S0)) / np.max(np.abs(S0)))
            log(f"  route oracle: {its} iterations (phase 4's K1/K2 "
                f"viscosity: {its0}), mean stress rel diff {d:.3e}")
            assert abs(its - its0) <= 1 and d <= 1e-5
        del s

    # f. Nunan-Keller at n = 64 under full_staggered: the five traceless
    # cases in one batch, then sequentially for each case's iterations
    V = NUNAN_KELLER["V"]
    r = (3.0 * V / (4.0 * np.pi)) ** (1.0 / 3.0)
    phi = smooth_sphere(2 * nk, "float32", r=r)[0]
    mat = ft.DfgMaterial(ft.convert.material_from_numpy(
        [("matrix", 0.5, 1.0 - phi), ("fiber", 0.0, phi)], dim=6,
        law="scalar", device=device))
    s = ft.LSSolver(ft.Grid(nk, nk, nk), mat, ft.SolverOptions(
        mode="viscosity", gamma_scheme="full_staggered", tol=1e-5,
        dtype="float32", check_every=8), device=device)
    Es = ft.api.VISCOSITY_CASES
    t0 = time.perf_counter()
    fail, path_launches["viscosity-nunan-keller"] = run_counted(
        s, f"{nk}^3 float32 Nunan-Keller run_batched B=5",
        "viscosity-nunan-keller", lambda: s.run_batched(Es), batched=True)
    wall = time.perf_counter() - t0
    assert not fail
    res = ft.api.effective_viscosity(s.calc_mean_stress_batched(), 0.5)
    its_b, S_seq, its_seq = len(s.residuals), np.zeros((5, 6)), []
    t0 = time.perf_counter()
    for i, E in enumerate(Es):
        s.set_strain(E)
        assert not s.run()
        S_seq[i] = s.calc_mean_stress()
        its_seq.append(len(s.residuals))
    wall_seq = time.perf_counter() - t0
    seq = ft.api.effective_viscosity(S_seq, 0.5)
    ea = abs(res.alpha - NUNAN_KELLER["alpha"]) / NUNAN_KELLER["alpha"]
    eb = abs(res.beta - NUNAN_KELLER["beta"]) / NUNAN_KELLER["beta"]
    log(f"  Nunan-Keller, n = {nk} ({2 * nk}^3 fine phases, V = "
        f"{float(phi.mean()):.5f}): batched {its_b} iterations, wall "
        f"{wall:.4f} s; alpha {res.alpha:.6f} (paper "
        f"{NUNAN_KELLER['alpha']}, rel {ea:.2e}), beta {res.beta:.6f} "
        f"(paper {NUNAN_KELLER['beta']}, rel {eb:.2e}); sequential "
        f"iterations per case {its_seq}, wall {wall_seq:.4f} s (batched / "
        f"sequential {wall / wall_seq:.3f}), alpha {seq.alpha:.6f} beta "
        f"{seq.beta:.6f}")
    assert ea <= 0.01 and eb <= 0.01
    assert abs(seq.alpha - res.alpha) <= 1e-3 and abs(seq.beta - res.beta) \
        <= 1e-3
    del s, mat

    # g. mixed BCs in staggered viscosity: xz stress-controlled
    s = path_solver(nm, "float64", device, "viscosity", tol=1e-8,
                    error_estimator="residual", check_every=4)
    P = voigt.id4(6)
    P[4, 4] = 0.0
    s.set_bc_projector(P)
    s.set_stress([0, 0, 0, 0, 0.4, 0])
    s.set_strain([0, 0, 0, 1.0, 0, 0])
    fail, _ = run_counted(s, f"{nm}^3 float64 viscosity, xz "
                             f"stress-controlled", "viscosity-mixed-bc")
    S = s.calc_mean_stress()
    log(f"  mixed BCs in staggered viscosity: {len(s.residuals)} "
        f"iterations, bc_error {s.bc_error():.3e} (bc_tol {s.opt.bc_tol}), "
        f"mean stress {S.tolist()}")
    assert not fail and s.bc_error() <= s.opt.bc_tol
    del s
    torch.cuda.empty_cache()

    # h. the card against the CPU, nc^3 float64 (phase 3's limits)
    copt = dict(error_estimator="residual", tol=1e-8, check_every=4,
                maxiter=1000)
    for path in ("elasticity-full-staggered", "elasticity-laminate",
                 "viscosity-generic", "viscosity-lambda"):
        kind = INTERFACE_PATHS[path][4]
        geo = smooth_sphere(nc, "float64") if kind == "smooth" else None
        s_cpu, s_gpu = (interface_solver(nc, "float64", dev, path,
                                         geometry=geo, **copt)
                        for dev in ("cpu", device))
        assert not s_cpu.run()
        assert not run_counted(s_gpu, f"{nc}^3 float64 {path}", path)[0]
        rc, rg = np.asarray(s_cpu.residuals), np.asarray(s_gpu.residuals)
        res_rel = float(np.max(np.abs(rg - rc) / np.abs(rc))) \
            if len(rc) == len(rg) else float("inf")
        Sc, Sg = s_cpu.calc_mean_stress(), s_gpu.calc_mean_stress()
        s_rel = float(np.max(np.abs(Sg - Sc)) / np.max(np.abs(Sc)))
        log(f"  {path}: iterations cpu {len(rc)} cuda {len(rg)}, residual "
            f"history max rel diff {res_rel:.3e}, mean stress max rel diff "
            f"{s_rel:.3e}")
        assert len(rc) == len(rg), f"{path}: iteration counts differ"
        assert res_rel <= 1e-9 and s_rel <= 1e-10, path


# phase 11: the XML front end.  Each run -> (demo project, settings, the
# check); every run takes datatype float
FRONT_END = {
    "fg-hashin": ("elasticity/hashin", {"variables.res..value": 256,
                                        "solver.tol": 1e-6}),
    "fg-transverse-isotropy": ("elasticity/transverse_isotropy",
                               {"variables.res..value": 256}),
    "fg-heat": ("heat/heat", {}),
    "fg-nunan-keller": ("viscosity/nunan_keller", {}),
}
DEMO_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "demo")
HASHIN_K = 3.63867684478 + 2.0 / 3.0     # the coated sphere's exact k*


def demo_fg(name, device="cuda", datatype="float", settings=None):
    """ft.FG on the demo project of FRONT_END[name], its settings applied,
    its solver built (the fibres and phases not yet)."""
    import fibergen_tpu_torch as ft
    path, kv = FRONT_END[name]
    f = ft.FG(os.path.join(DEMO_DIR, path, "project.xml"), device=device)
    f.set("datatype", datatype)
    for k, v in dict(kv, **(settings or {})).items():
        f.set(k, v)
    f._init_python()
    f.init_lss()
    return f


def front_end(run_counted, path_launches, device="cuda"):
    """Phase 11: the demo projects through ft.FG on the card in float32
    (FRONT_END), each run's launches counted around f.run() (the fibres,
    the voxelization and the solve): a run launches its path's kernels and
    no other.  Prints each run's init_phase time (voxelization and the
    geometry fields it needs, fibre generation excluded), solve time,
    wall time and peak device memory; then float32 phi against float64
    phi at 256^3, and three demos in float64 on the card against the CPU
    (the float32 heat run too)."""
    import numpy as np
    import torch
    from fibergen_tpu_torch.geometry import discretize
    log("phase 11: the XML front end (demo projects through ft.FG), "
        "float32")
    got = {}
    cuda = device == "cuda"
    for name in FRONT_END:
        f = demo_fg(name, device)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        fail, got[name] = run_counted(f.solver, name, name, f.run)
        wall = time.perf_counter() - t0
        path_launches[name] = got[name]
        s = f.solver
        log(f"  {name}: grid {s.grid.shape}, {len(f.gen.all_fibers())} "
            f"primitives, {len(s.residuals)} iterations, init_phase "
            f"{f.phase_time:.4f} s (geometry fields {f.geometry_time:.4f} s), "
            f"solve_time {s.solve_time:.4f} s, wall {wall:.3f} s, peak "
            f"device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30 if cuda else 0:.2f} "
            f"GiB, distance evaluations {f.get_distance_evals()}")
        assert fail == 0, name
        if name == "fg-hashin":
            sig = np.array(f.get_mean_stress())
            k_eff = sig[:3].sum() / 9.0
            log(f"    k_eff {k_eff:.8f} vs k* {HASHIN_K:.8f} (rel "
                f"{abs(k_eff - HASHIN_K) / HASHIN_K:.3e}, limit 2e-3)")
            assert abs(k_eff - HASHIN_K) <= 2e-3 * HASHIN_K
            # float32 phi against float64 phi on the same fibres: the
            # float32 coordinates carry an error of a few ulps of the cell
            # edge, which moves a voxel's fraction by that over the
            # supersampled voxel edge h
            g = s.grid
            fib = f.gen.all_fibers()
            p32 = [discretize.phi_field(g, fib[k:k + 1], 2, torch.float32,
                                        device) for k in range(len(fib))]
            p64 = [discretize.phi_field(g, fib[k:k + 1], 2, torch.float64,
                                        device) for k in range(len(fib))]
            d = max(float((a.double() - b).abs().max())
                    for a, b in zip(p32, p64))
            dm = max(abs(float(a.double().mean() - b.mean()))
                     for a, b in zip(p32, p64))
            lim = 8 * float(np.finfo(np.float32).eps) * (2 * g.nx)
            log(f"    phi float32 vs float64 at {g.nx}^3 (supersample 2): "
                f"max abs diff {d:.3e} (limit 8 eps32 / h = {lim:.3e}), "
                f"volume fraction diff {dm:.3e}")
            assert d <= lim and dm <= 1e-6
            del p32, p64
        elif name == "fg-transverse-isotropy":
            sig = np.array(f.get_mean_stress())
            log(f"    mean stress {sig.tolist()}")
            assert np.all(np.isfinite(sig)) and sig[0] > sig[1] \
                and sig[0] > sig[2]
        elif name == "fg-heat":
            K = np.array(f.get_effective_property())
            log(f"    K diagonal {np.diag(K).tolist()}")
            heat32 = (K, len(s.residuals))   # held to the CPU below
            # its three cases batched (as the run took them) and one by
            # one on the same solver, warm, in turns
            walls = {"batched": [], "sequential": []}
            for _ in range(2):
                for how in walls:
                    t0 = time.perf_counter()
                    if how == "batched":
                        assert not s.run_batched(np.eye(3))
                    else:
                        for E in np.eye(3):
                            s.set_strain(E)
                            assert not s.run()
                    sync_all()
                    walls[how].append(time.perf_counter() - t0)
            log(f"    the three cases batched {walls['batched']} s, one by "
                f"one {walls['sequential']} s: batched / sequential "
                f"{sum(walls['batched']) / sum(walls['sequential']):.3f}")
            assert np.all(np.diag(K) > 1.0) and np.all(np.diag(K) < 10.0)
        else:
            alpha, beta = f._nunan_keller
            da = abs(alpha - NUNAN_KELLER["alpha"]) / NUNAN_KELLER["alpha"]
            db = abs(beta - NUNAN_KELLER["beta"]) / NUNAN_KELLER["beta"]
            log(f"    alpha {alpha:.6f} (paper {NUNAN_KELLER['alpha']}, rel "
                f"{da:.3e}), beta {beta:.6f} (paper {NUNAN_KELLER['beta']}, "
                f"rel {db:.3e}), limit 1 %")
            assert da <= 0.01 and db <= 0.01
        del f, s
        if cuda:
            torch.cuda.empty_cache()

    # the card against the CPU in float64 through FG: hashin at 32^3 (K1,
    # K2, K3), heat at its 128^2 x 1 (K4 on the one-voxel z axis) and
    # transverse_isotropy at 32^3 (K3 alone; the laminate rule's normals,
    # the fibres' orientation field); phi and those fields within 1e-12,
    # the same iterations, the mean stress or K within 1e-10
    cross = (("fg-hashin", {"variables.res..value": 32, "solver.tol": 1e-10},
              ()),
             ("fg-heat", {}, ("normals",)),
             ("fg-transverse-isotropy", {"variables.res..value": 32},
              ("normals", "orientation")))
    for name, kv, fields in cross:
        runs = {}
        for dev in ("cpu", device):
            f = demo_fg(name, dev, "double", kv)
            if dev == "cpu":
                fail = f.run()
            else:
                fail = run_counted(f.solver, f"{name} float64", name,
                                   f.run)[0]
            assert fail == 0, (name, dev)
            runs[dev] = f
        c, g = runs["cpu"], runs[device]
        dphi = float(np.abs(g.get_field("phi") - c.get_field("phi")).max())
        dgeo = max([float(np.abs(g.get_field(k) - c.get_field(k)).max())
                    for k in fields], default=0.0)
        effective = c.get_effective_property() is not None
        what = "K" if effective else "mean stress"
        out = lambda f: np.array(f.get_effective_property() if effective
                                 else f.get_mean_stress())
        Sc, Sg = out(c), out(g)
        s_rel = float(np.max(np.abs(Sg - Sc)) / np.max(np.abs(Sc)))
        its = (len(c.get_residuals()), len(g.get_residuals()))
        log(f"  {name} {g.solver.grid.shape} float64 cuda vs cpu: phi max "
            f"abs diff {dphi:.3e}, {'/'.join(fields) or 'no other fields'} "
            f"{dgeo:.3e} (limit 1e-12), iterations {its}, "
            f"{what} max rel diff "
            f"{s_rel:.3e} (limit 1e-10)")
        assert dphi <= 1e-12 and dgeo <= 1e-12 and its[0] == its[1] \
            and s_rel <= 1e-10, name
        if name == "fg-heat":
            # the float32 run on the card against the float64 CPU run
            K32, its32 = heat32
            k_rel = float(np.max(np.abs(K32 - Sc)) / np.max(np.abs(Sc)))
            log(f"  fg-heat float32 on the card vs float64 on the cpu: K "
                f"max rel diff {k_rel:.3e} (limit 1e-5), iterations "
                f"({its32}, {its[0]})")
            assert k_rel <= 1e-5 and its32 == its[0]
        del runs, c, g


# phase 12: meshes and file I/O.  The synthetic CT volume stands in for the
# digital_rocks demo's Grosmont rasters (demo/elasticity/digital_rocks,
# whose data is not in the repo): thresholded, smoothed Gaussian noise of
# correlation length 8 voxels at 256^3, about 0.2 pore (the matrix), 0.5
# calcite and 0.3 quartz
ROCK_MODULI = {"K": (0.037, 37.0, 68.3), "mu": (0.044, 44.0, 28.4)}
# the demo's phases in its order: matrix (pore), quartz, calcite
MESH_DEMOS = {
    "fg-stl": ("geometry/stl", {}),
    "fg-tetmesh": ("geometry/tetmesh", {}),
    "fg-normals": ("geometry/normals", {}),
}


def rock_volume(n, corr=8.0, seed=0):
    """(quartz, calcite) indicator fields (float64 numpy, n^3) of the
    thresholded Gaussian-filtered noise of ``seed`` (made on the card):
    the lowest 20 % of the values pore, the next 50 % calcite, the rest
    quartz; the filter's sigma is half the correlation length ``corr``
    (voxels)."""
    import numpy as np
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    noise = torch.randn((n, n, n), generator=g, device="cuda")
    k = torch.fft.fftfreq(n, device="cuda") * n
    kz = torch.fft.rfftfreq(n, device="cuda") * n
    w = torch.exp(-2.0 * (math.pi * 0.5 * corr / n) ** 2
                  * (k[:, None, None] ** 2 + k[None, :, None] ** 2
                     + kz[None, None, :] ** 2))
    v = torch.fft.irfftn(torch.fft.rfftn(noise) * w, s=(n, n, n))
    q = torch.quantile(v.flatten()[::97].double(),
                       torch.tensor([0.2, 0.7], dtype=torch.float64,
                                    device="cuda")).float()
    quartz = (v >= q[1]).cpu().numpy().astype(np.float64)
    calcite = ((v >= q[0]) & (v < q[1])).cpu().numpy().astype(np.float64)
    return quartz, calcite


def write_rasters(tmp, tag, quartz, calcite):
    """The two gzip'd uint8 rasters of the digital_rocks demo's actions, in
    io/rawio.py's layout (column order, 0 or 255), compressed at level 1
    (the writer's level 9 is far slower at 256^3; the reader takes
    either)."""
    import gzip
    import numpy as np
    paths = []
    for k, d in ((1, quartz), (2, calcite)):
        p = os.path.join(tmp, f"{tag}_{k}.raw.gz")
        with gzip.open(p, "wb", compresslevel=1) as fp:
            fp.write(np.ascontiguousarray(d * 255, dtype=np.uint8).tobytes())
        paths.append(p)
    return paths


def rocks_fg(paths, n, device, datatype="float", load_case=False, **kv):
    """ft.FG on demo/elasticity/digital_rocks/project.xml with its rasters
    set to ``paths``, n and the settings ``kv``, its solver built;
    ``load_case`` runs e11 = 1 instead of the effective properties."""
    import fibergen_tpu_torch as ft
    f = ft.FG(os.path.join(DEMO_DIR, "elasticity", "digital_rocks",
                           "project.xml"), device=device)
    f.set("datatype", datatype)
    f.set("solver..n", n)
    for i, p in enumerate(paths):
        f.set(f"actions.read_raw_data[{i}]..filename", p)
    if load_case:
        f.erase("actions.calc_effective_properties")
        f.set("actions.run_load_case..e11", 1)
    for k, v in kv.items():
        f.set(k.replace("__", "."), v)
    f._init_python()
    f.init_lss()
    return f


def hs_bounds(phis, K, mu):
    """The n-phase Hashin-Shtrikman bounds (Berryman's form) of the bulk
    and shear moduli: ((K_lo, K_hi), (mu_lo, mu_hi)).  With two phases
    they are those of the calc_HS_bounds action
    (convert.hashin_shtrikman_bounds)."""
    import numpy as np
    phis, K, mu = (np.asarray(a, dtype=np.float64) for a in (phis, K, mu))
    lam = lambda z: 1.0 / np.sum(phis / (K + 4.0 / 3.0 * z)) - 4.0 / 3.0 * z
    gam = lambda z: 1.0 / np.sum(phis / (mu + z)) - z
    zeta = lambda k, m: m / 6.0 * (9.0 * k + 8.0 * m) / (k + 2.0 * m)
    return ((lam(mu.min()), lam(mu.max())),
            (gam(zeta(K.min(), mu.min())), gam(zeta(K.max(), mu.max()))))


def iso_fit(C):
    """(K, mu) of the isotropic fit of a Voigt stiffness whose shear
    columns are halved (calc_effective_properties' fit)."""
    import numpy as np
    C = np.array(C, dtype=np.float64)
    C[:, 3:6] *= 2.0
    S1, S2 = C[0:3, 0:3].sum(), np.trace(C)
    lam, mu = (2 * S1 - S2) / 15.0, (3 * S2 - S1) / 30.0
    return lam + 2.0 / 3.0 * mu, mu


def counted(fn):
    """``fn()`` with every launch count set to 0 just before it; returns
    (its result, the counts)."""
    from fibergen_tpu_torch.ops import spectral_kernels as spk
    from fibergen_tpu_torch.ops import stencil_kernels as sk
    for table in (sk.launches, spk.launches):
        for name in table:
            table[name] = 0
    out = fn()
    sync_all()
    return out, {k: v for k, v in dict(sk.launches, **spk.launches).items()
                 if v}


class plain_chains:
    """Within the block the K3 and K4 wrappers compute their plain twins
    (torch.fft around the apply) on the card: the recovery's reference."""

    def __enter__(self):
        from fibergen_tpu_torch.ops import spectral_kernels as spk
        self.saved = (spk.g0_staggered_chain, spk.g0_staggered_heat_chain)
        spk.g0_staggered_chain = spk.g0_staggered_chain_plain
        spk.g0_staggered_heat_chain = spk.g0_staggered_heat_chain_plain

    def __exit__(self, *exc):
        from fibergen_tpu_torch.ops import spectral_kernels as spk
        spk.g0_staggered_chain, spk.g0_staggered_heat_chain = self.saved


def meshes_and_io(run_counted, path_launches, card):
    """Phase 12: the raw CT volume in and its stiffness out at 256^3, the
    solution VTK at 128^3, the recovery chains against their twins, the
    mesh demos, the card against the CPU in float64, get_fft_time."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    import fibergen_tpu_torch as ft
    from fibergen_tpu_torch.io import rawio
    from fibergen_tpu_torch.io import vtk as vtkio
    from fibergen_tpu_torch.ops import staggered
    from fibergen_tpu_torch.utils.logging import TIMINGS

    t_phase = time.perf_counter()
    log(f"phase 12: meshes and file I/O ({card})")
    tmp = tempfile.mkdtemp(prefix="fg_phase12_")
    try:
        # ---- 1. raw CT in, stiffness out, 256^3 float32
        t0 = time.perf_counter()
        quartz, calcite = rock_volume(256)
        raw256 = write_rasters(tmp, "rock256", quartz, calcite)
        log(f"  synthetic CT volume 256^3: quartz {quartz.mean():.4f}, "
            f"calcite {calcite.mean():.4f}, pore "
            f"{1 - quartz.mean() - calcite.mean():.4f}; two gzip'd uint8 "
            f"rasters ({sum(os.path.getsize(p) for p in raw256)} bytes) in "
            f"{time.perf_counter() - t0:.2f} s")
        f = rocks_fg(raw256, 256, "cuda")
        torch.cuda.reset_peak_memory_stats()
        TIMINGS.reset()
        t0 = time.perf_counter()
        fail, got = run_counted(f.solver, "fg-digital-rocks 256^3 float32",
                                "fg-digital-rocks", f.run)
        wall = time.perf_counter() - t0
        assert fail == 0
        path_launches["fg-digital-rocks"] = got
        s = f.solver
        t_read = TIMINGS.stats["action read_raw_data"][1]
        t_eff = TIMINGS.stats["action calc_effective_properties"][1]
        C = np.array(f.get_effective_property())
        sym = float(np.abs(C - C.T).max() / np.abs(C).max())
        phis = [float(p.phi.mean()) for p in s.mat.phases]
        (klo, khi), (mlo, mhi) = hs_bounds(phis, *ROCK_MODULI.values())
        K, mu = iso_fit(C)
        log(f"  fg-digital-rocks 256^3 float32: phases {phis}, "
            f"calc_effective_properties (six cases, "
            f"{'batched' if hasattr(s, 'eps_batch') else 'one by one'}) "
            f"{t_eff:.3f} s, the last case {len(s.residuals)} iterations "
            f"in {s.solve_time:.4f} s; read_raw_data x 2 {t_read:.3f} s; "
            f"wall {wall:.3f} s; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        log(f"    C_eff diagonal {np.diag(C).tolist()}, asymmetry "
            f"{sym:.3e} of its largest entry (limit 1e-4); K {K:.5f} in HS "
            f"[{klo:.5f}, {khi:.5f}], mu {mu:.5f} in HS [{mlo:.5f}, "
            f"{mhi:.5f}]")
        assert sym <= 1e-4 and klo <= K <= khi and mlo <= mu <= mhi
        # the six cases batched on the same solver (the front end ran them
        # one by one at this size: its batch gate is 8e9 bytes)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        assert not s.run_batched(np.eye(6))
        t_b = time.perf_counter() - t0
        Cb = s.calc_mean_stress_batched().T
        Cb[:, 3:6] *= 0.5
        d = float(np.abs(Cb - C).max() / np.abs(C).max())
        log(f"    run_batched(eye(6)): {len(s.residuals)} iterations, "
            f"{t_b:.3f} s, peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; C_eff "
            f"batched vs one by one max diff {d:.3e} of the largest entry "
            f"(limit 1e-5)")
        assert d <= 1e-5
        del f, s
        torch.cuda.empty_cache()

        # ---- 2. the solution VTK of a 128^3 solve
        raw128 = write_rasters(tmp, "rock128", quartz[::2, ::2, ::2],
                               calcite[::2, ::2, ::2])
        f = rocks_fg(raw128, 128, "cuda", load_case=True)
        assert f.run() == 0
        s = f.solver
        _, got = counted(f._displacement_field)
        assert got == {"g0_staggered_chain": 1}, got
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        u = f._displacement_field()
        torch.cuda.synchronize()
        t_u = time.perf_counter() - t0
        path = os.path.join(tmp, "rock128.vtk")
        t0 = time.perf_counter()
        f.write_vtk_solution(path)
        t_w = time.perf_counter() - t0
        header, records = vtkio.read_vtk(path)
        names = [n for _, n, _ in records]
        want = (["phi_matrix", "phi_quartz", "phi_calcite"]
                + [f"epsilon_{c}" for c in ("11", "22", "33", "23", "13",
                                            "12")]
                + [f"sigma_{c}" for c in ("11", "22", "33", "23", "13",
                                          "12")]
                + ["u", "u_0", "u_1", "u_2"])
        assert header[0] == "# vtk DataFile Version 3.0"
        assert header[2:5] == ["BINARY", "DATASET STRUCTURED_POINTS",
                               "DIMENSIONS 128 128 128"], header
        assert names == want, names
        u_file = dict((n, a) for k, n, a in records if k == "VECTORS")["u"]
        du = rel_max(u_file, f.get_field("u"))
        E = s.eps.mean(dim=(1, 2, 3))
        ident = float((staggered.eps_staggered(s.grid, E, u) - s.eps)
                      .abs().max() / s.eps.abs().max())
        log(f"  solution VTK of a 128^3 float32 solve ({len(s.residuals)} "
            f"iterations): u in {t_u * 1e3:.2f} ms (one K3 launch), file "
            f"{os.path.getsize(path)} bytes written in {t_w:.3f} s, fields "
            f"{len(names)}; u in the file vs get_field max rel diff "
            f"{du:.3e} (limit 1e-6); "
            f"identity eps_staggered(<eps>, u) vs eps {ident:.3e} of max "
            f"|eps| (limit 1e-5)")
        assert du <= 1e-6 and ident <= 1e-5
        del f, s, u
        torch.cuda.empty_cache()

        # ---- 3. the recovery chains against their twins
        for n, dt in ((256, "float32"), (48, "float64")):
            for mode in ("elasticity", "heat", "viscosity"):
                s = sphere_solver(n, dt, "cuda", mode,
                                  error_estimator="residual", tol=1e-6,
                                  check_every=8)
                assert not s.run()
                f = ft.FG(device="cuda")
                f.solver = s
                rec = (f._viscosity_velocity_pressure if mode == "viscosity"
                       else lambda: (f._displacement_field(),))
                out, got = counted(rec)
                with plain_chains():
                    ref, twin = counted(rec)
                assert twin == {}, twin
                want = {"elasticity": {"g0_staggered_chain": 1},
                        "heat": {"g0_staggered_heat_chain": 1},
                        "viscosity": {"g0_staggered_chain": 1,
                                      "g0_staggered_heat_chain": 1}}[mode]
                assert got == want, (mode, got)
                label = f"recover-{mode}"
                if n == 256:
                    path_launches[label] = got
                errs = [rel_err(o, r) for o, r in zip(out, ref)]
                tol = 1e-5 if dt == "float32" else 1e-12
                what = {"elasticity": ("u",), "heat": ("T",),
                        "viscosity": ("u", "p")}[mode]
                torch.cuda.synchronize()
                ms = cuda_ms(rec, reps=5, warm=1)
                log(f"  {label} {n}^3 {dt}: "
                    + ", ".join(f"{w} max rel diff to the twin {e[0]:.3e}"
                                for w, e in zip(what, errs))
                    + f" (limit {tol:g}); launches {got}; {ms:.3f} ms")
                assert all(e[0] <= tol for e in errs), (label, errs)
                del s, f, out, ref
            torch.cuda.empty_cache()

        # ---- 4. the mesh demos (float32)
        runs = (("fg-stl", {}), ("fg-stl", {"solver..n": 128}),
                ("fg-tetmesh", {}),
                ("fg-tetmesh", {"solver..nx": 192, "solver..ny": 192,
                                "solver..nz": 16}),
                ("fg-normals", {}))
        for name, kv in runs:
            f = mesh_fg(name, "cuda", "float", kv)
            if name == "fg-normals":
                f.set("actions.write_vtk..filename",
                      os.path.join(tmp, "normals.vtk"))
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            fail, got = run_counted(f.solver, f"{name} {kv}", name, f.run)
            wall = time.perf_counter() - t0
            assert fail == 0
            path_launches[name] = {k: path_launches.get(name, {}).get(k, 0)
                                   + v for k, v in got.items()}
            s = f.solver
            prims = sum(len(getattr(p, "tets", ())) or
                        len(getattr(p, "V0", ())) or 1
                        for p in f.gen.all_fibers())
            phase_s = f.phase_time if name != "fg-normals" else \
                f.geometry_time
            log(f"  {name} {s.grid.shape}: {prims} primitives, "
                f"{'init_phase' if name != 'fg-normals' else 'geometry fields'}"
                f" {phase_s:.4f} s ({1e3 * phase_s / prims:.3f} ms a "
                f"primitive), solve_time {s.solve_time:.4f} s "
                f"({len(s.residuals)} iterations), wall {wall:.3f} s, peak "
                f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
                f" GiB, distance evaluations {f.get_distance_evals()}")
            if name == "fg-stl":
                v = f.get_volume_fraction("blob")
                flux = f.get_mean_stress()
                log(f"    blob volume fraction {v:.5f}, flux {flux}")
                assert abs(v - 0.115) < 0.03 and flux[0] > 1.0
            elif name == "fg-tetmesh":
                v = f.get_volume_fraction("core")
                sig = f.get_mean_stress()
                log(f"    core volume fraction {v:.5f}, mean stress {sig}")
                assert 0.1 < v < 0.6 and sig[0] > 0 and sig[5] > 0
                if s.grid.nz == 16:
                    # ---- 6. get_fft_time after this staggered elasticity
                    # solve
                    t_fft = f.get_fft_time()
                    log(f"    get_fft_time {t_fft:.4f} s of solve_time "
                        f"{s.solve_time:.4f} s (chain applications "
                        f"{s._chain_calls})")
                    assert 0.0 < t_fft <= s.solve_time
            else:
                header, records = vtkio.read_vtk(
                    os.path.join(tmp, "normals.vtk"))
                n = dict((nm, a) for k, nm, a in records if k == "VECTORS")
                ln = np.sqrt((n["normals"].astype(np.float64) ** 2).sum(0))
                dist = dict((nm, a) for k, nm, a in records)["distance"]
                m = np.abs(dist) < 0.1
                log(f"    normals.vtk: {[nm for _, nm, _ in records]}, unit "
                    f"normals near the interface: mean |n| {ln[m].mean():.6f}")
                assert abs(ln[m].mean() - 1.0) < 1e-3
            del f, s
            torch.cuda.empty_cache()

        # ---- 5. the card against the CPU in float64
        crop = write_rasters(tmp, "rock32", quartz[:32, :32, :32],
                             calcite[:32, :32, :32])
        runs = {}
        for dev in ("cpu", "cuda"):
            f = rocks_fg(crop, 32, dev, "double", load_case=True,
                         solver__tol=1e-10)
            assert f.run() == 0
            runs[dev] = f
        c, g = runs["cpu"], runs["cuda"]
        its = (len(c.get_residuals()), len(g.get_residuals()))
        ds = rel_max(g.get_mean_stress(), c.get_mean_stress())
        du = rel_max(g.get_field("u"), c.get_field("u"))
        ck = os.path.join(tmp, "rock32.npz")
        g.solver.save_state(ck)
        r = rocks_fg(crop, 32, "cpu", "double", load_case=True)
        r.erase("actions.run_load_case")
        assert r.run() == 0
        r.solver.load_state(ck)
        dr = rel_max(r.get_mean_stress(), g.get_mean_stress())
        log(f"  32^3 crop float64 cuda vs cpu: iterations {its}, mean "
            f"stress max rel diff {ds:.3e}, u {du:.3e} (limit 1e-10); the "
            f"card's checkpoint resumed on the CPU: mean stress {dr:.3e} "
            f"(limit 1e-10)")
        assert its[0] == its[1] and ds <= 1e-10 and du <= 1e-10 \
            and dr <= 1e-10
        phis = {}
        for dev in ("cpu", "cuda"):
            f = mesh_fg("fg-stl", dev, "double", {"solver..n": 16})
            assert f.run() == 0
            phis[dev] = f.get_field("phi")
        dphi = float(np.abs(phis["cuda"] - phis["cpu"]).max())
        log(f"  fg-stl n = 16 float64 cuda vs cpu: phi max abs diff "
            f"{dphi:.3e} (limit 1e-12)")
        assert dphi <= 1e-12
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"  phase 12 in {time.perf_counter() - t_phase:.1f} s")


def mesh_fg(name, device, datatype, settings):
    """ft.FG on the mesh demo MESH_DEMOS[name] with ``settings`` applied,
    its solver built."""
    import fibergen_tpu_torch as ft
    path, kv = MESH_DEMOS[name]
    f = ft.FG(os.path.join(DEMO_DIR, path, "project.xml"), device=device)
    f.set("datatype", datatype)
    for k, v in dict(kv, **settings).items():
        f.set(k, v)
    f._init_python()
    f.init_lss()
    return f


def rel_max(x, y):
    """max |x - y| / max |y| of two arrays."""
    import numpy as np
    x, y = np.asarray(x, dtype=np.float64), np.asarray(y, dtype=np.float64)
    return float(np.abs(x - y).max() / np.abs(y).max())


def sync_all():
    import torch
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


# phase 13: the remaining methods and schemes.  path -> (mode, gamma_scheme,
# options, the phase-4 solve it is held to, the limit on the mean stress's
# max-abs relative difference).  The fixed-point methods (nesterov,
# basic+el, polarization) and the sigma estimator stop a few 1e-5 away
# from CG, as phase 4's polarization does; Willot and freq_hack are other
# discretizations (freq_hack differs at the Nyquist bins only); Maximum
# runs on phase 10's partial-volume sphere, which it turns into the sharp
# sphere of phase 4's Newton solve up to the voxels cut in half.  On an
# even grid the collocated Gamma is not symmetric at the Nyquist bins, and
# nl_cg's gradient there levels off (near 2e-5 of its first value at 24^3
# float64): nl_cg stops at 1e-4 (P11 within 2e-5 of Newton's at 48^3
# float64) and is compared on an odd grid.  The epsilon estimator of the
# hyperelastic basic scheme weighs the change of F against |F| ~ sqrt(3)
# and stops it 3 % off at 1e-6; it runs on the sigma estimator.
_FIXED = dict(error_estimator="epsilon", tol=1e-6, maxiter=4000)
_CG = dict(error_estimator="residual", tol=1e-6, check_every=8, maxiter=4000)
METHOD_PATHS = {
    "elasticity-nesterov": ("elasticity", "staggered",
                            dict(_FIXED, method="nesterov"), "elasticity",
                            5e-4),
    "elasticity-nesterov-collocated": ("elasticity", "collocated",
                                       dict(_FIXED, method="nesterov"),
                                       "elasticity-collocated", 5e-4),
    "elasticity-basic-el": ("elasticity", "staggered",
                            dict(_FIXED, method="basic+el"), "elasticity",
                            5e-4),
    "elasticity-basic-el-collocated": ("elasticity", "collocated",
                                       dict(_FIXED, method="basic+el"),
                                       "elasticity-collocated", 5e-4),
    "elasticity-cg-reinit": ("elasticity", "staggered",
                             dict(_CG, cg_reinit=8), "elasticity", 1e-5),
    "elasticity-sigma": ("elasticity", "staggered",
                         dict(_CG, error_estimator="sigma"), "elasticity",
                         5e-4),
    "elasticity-willot": ("elasticity", "willot", _CG, "elasticity", 2e-2),
    "viscosity-willot": ("viscosity", "willot", _CG, "viscosity", 2e-2),
    "elasticity-freq-hack": ("elasticity", "collocated",
                             dict(_CG, freq_hack=True),
                             "elasticity-collocated", 1e-2),
    "viscosity-polarization": ("viscosity", "collocated",
                               dict(_FIXED, method="polarization"),
                               "viscosity-collocated", 5e-4),
    "hyperelasticity-nl-cg": ("hyperelasticity", "staggered",
                              dict(method="nl_cg", tol=1e-4, maxiter=2000),
                              "hyperelasticity", 5e-4),
    "hyperelasticity-nl-cg-collocated": (
        "hyperelasticity", "collocated",
        dict(method="nl_cg", tol=1e-4, maxiter=2000),
        "hyperelasticity-collocated", 5e-4),
    "hyperelasticity-basic": ("hyperelasticity", "staggered",
                              dict(method="basic", error_estimator="sigma",
                                   tol=1e-5, maxiter=2000),
                              "hyperelasticity", 5e-4),
    "hyperelasticity-maximum": ("hyperelasticity", "staggered",
                                dict(HYPER_OPT, rule="maximum"),
                                "hyperelasticity", 5e-3),
}


def method_solver(n, dtype, device, path, **opt):
    """The bench's RVE (the SVK sphere in hyperelasticity) on ``path`` of
    METHOD_PATHS at n^3 in ``dtype``; ``opt`` overrides the path's
    options.  The Maximum path takes phase 10's partial-volume sphere."""
    import fibergen_tpu_torch as ft
    mode, scheme, popt, _, _ = METHOD_PATHS[path]
    o = dict(popt, **opt)
    rule = o.pop("rule", None)
    if rule is None:
        return sphere_solver(n, dtype, device, mode, scheme, **o)
    c = RVE[mode]
    phi, _ = smooth_sphere(n, "float32" if dtype == "float32" else "float64")
    mat = ft.convert.material_from_numpy(
        [("fiber", *c["fiber"], phi), ("matrix", *c["matrix"], 1.0 - phi)],
        dim=c["dim"], device=device, law=c["law"], rule=rule)
    s = ft.LSSolver(ft.Grid(n, n, n), mat, ft.SolverOptions(
        mode=mode, gamma_scheme=scheme, dtype=dtype, **o), device=device)
    s.set_strain(c["load"])
    return s


def remaining_methods(run_counted, res32, hyper, path_launches, n=256,
                      nc=48, nh=31):
    """Phase 13: the remaining methods and schemes (METHOD_PATHS) at n^3
    float32, each solve once (its kernels warmed by the earlier phases)
    with its iterations, wall, peak memory, launches (its path's kernels
    and no other) and its mean stress against phase 4's solve of the same
    cell (``res32``; ``hyper``'s Newton P11 in hyperelasticity); then each
    path in float64 on the card against the CPU: the linear ones at nc^3
    (tol 1e-8; 1e-6 on the epsilon estimator), the hyperelastic ones at
    the odd nh^3 at their own tol: the same
    iterations, histories within 1e-9 relative or 1e-14 absolute (1e-7
    relative for basic+el, whose step length carries the rounding of its
    reductions from one iteration to the next), mean stress within
    1e-10."""
    import numpy as np
    import torch
    t_phase = time.perf_counter()
    log(f"phase 13: the remaining methods and schemes, {n}^3 float32")
    for path, (mode, scheme, popt, ref, limit) in METHOD_PATHS.items():
        s = method_solver(n, "float32", "cuda", path)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        fail, got = run_counted(s, f"{n}^3 float32 {path}", path)
        wall = time.perf_counter() - t0
        path_launches[path] = got
        S = s.calc_mean_stress()
        if mode == "hyperelasticity":
            S0 = hyper[(ref, "exact")][2]
            d = abs(float(S[0]) - float(S0[0])) / abs(float(S0[0]))
            what = f"P11 {S[0]:.6f} vs Newton's {S0[0]:.6f}"
        else:
            S0 = res32[ref][1]
            d = float(np.max(np.abs(S - S0)) / np.max(np.abs(S0)))
            what = f"mean stress {S.tolist()}"
        its = len(s.residuals)
        log(f"  {n}^3 float32 {path}: {its} iterations, wall {wall:.4f} s "
            f"({1e3 * wall / its:.2f} ms an iteration), peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, {what}; "
            f"rel diff to phase 4's {ref} {d:.3e} (limit {limit:g})")
        assert not fail and its < popt.get("maxiter", 4000), path
        assert np.all(np.isfinite(S)) and d <= limit, (path, d)
        if mode != "hyperelasticity":
            res32[path] = (its, S)
        del s
        torch.cuda.empty_cache()
    log(f"  phase 13 at {n}^3 in {time.perf_counter() - t_phase:.1f} s")
    for path, (mode, _, popt, _, _) in METHOD_PATHS.items():
        hyper_path = mode == "hyperelasticity"
        m = nh if hyper_path else nc
        tol = popt["tol"] if hyper_path else {
            "residual": 1e-8, "sigma": 1e-8}.get(
                popt.get("error_estimator"), 1e-6)
        s_cpu = method_solver(m, "float64", "cpu", path, tol=tol)
        s_gpu = method_solver(m, "float64", "cuda", path, tol=tol)
        assert not s_cpu.run()
        assert not run_counted(s_gpu, f"{m}^3 float64 {path}", path)[0]
        rc, rg = np.asarray(s_cpu.residuals), np.asarray(s_gpu.residuals)
        same = len(rc) == len(rg)
        res_rel = float(np.max(np.abs(rg - rc) / np.abs(rc))) if same \
            else float("inf")
        Sc, Sg = s_cpu.calc_mean_stress(), s_gpu.calc_mean_stress()
        s_rel = float(np.max(np.abs(Sg - Sc)) / np.max(np.abs(Sc)))
        log(f"  {m}^3 float64 {path}: iterations cpu {len(rc)} cuda "
            f"{len(rg)}, residual history max rel diff {res_rel:.3e}, mean "
            f"stress max rel diff {s_rel:.3e}")
        rtol = 1e-7 if popt.get("method") == "basic+el" else 1e-9
        assert same, f"{path}: iteration counts differ"
        assert np.all(np.abs(rg - rc) <= rtol * np.abs(rc) + 1e-14), path
        assert s_rel <= 1e-10, (path, s_rel)
        del s_cpu, s_gpu
    log(f"  phase 13 in {time.perf_counter() - t_phase:.1f} s")


# phase 14: mixed-precision refinement, the low-memory CG, the multigrid G0
# and the sweep harness.  REF_OPT: the options of its CG solves; LM6_BIG:
# the grid the plain layout cannot hold, run on the lm6 route when its
# reckoned peak stays under LM6_BUDGET bytes; HASHIN_K64: the JAX package's
# float64 k_eff of the hashin demo at n = 64 (PARITY.md:648-654)
REF_OPT = dict(error_estimator="residual", check_every=8, maxiter=4000)
LM6_BIG = (1024, 1024, 512)
LM6_BUDGET = 72e9
HASHIN_K64 = 4.306751
SWEEP_XML = """<settings>
  <solver n="64">
    <materials><matrix mu="1" lambda="1" /><fiber mu="10" lambda="5" /></materials>
    <mode>elasticity</mode><tol>1e-4</tol>
  </solver>
  <actions>
    <select_material name="fiber" />
    <place_fiber R="0.3" />
    <run_load_case e11="1" />
  </actions>
</settings>"""


def box_sphere(shape, dtype):
    """bench.py's sphere of radius 0.3 in the unit cell on a grid of any
    ``shape`` (a numpy array)."""
    import numpy as np
    a = [((np.arange(n) + 0.5) / n - 0.5) ** 2 for n in shape]
    return ((a[0][:, None, None] + a[1][None, :, None] + a[2][None, None, :])
            < 0.09).astype(dtype)


def reckoned_gb(grid, route, material_planes, itemsize=4):
    """The peak of a staggered elasticity CG the code reckons
    (solvers/lowmem.py): the material's planes and the step's fields."""
    import math
    from fibergen_tpu_torch.solvers import lowmem
    step = lowmem.lm6_solve_bytes(grid, itemsize) if route == "lm6" else \
        lowmem.plain_solve_bytes(grid, 6, itemsize)
    return (material_planes * math.prod(grid.shape) * itemsize + step) / 1e9


def mixed_precision_low_memory(run_counted, path_launches, n=256, nl=512,
                               nm=64, nc=32):
    """Phase 14: refinement, the low-memory CG, the multigrid G0 and the
    sweep harness on the card, each solve's launches counted (a path
    launches its kernels and no other):

    a. the bench's sphere at n^3 float32 refined to tol 1e-10 on the
       staggered (K1, K3, K2) and the collocated grid (K5): sweeps, inner
       iterations, the final float64 residual, the mean stress within 1e-9
       of a float64 solve on the card to 1e-11;
    b. the hashin demo at its shipped tol 1e-10 through ft.FG in float32
       (refined) against float64: k_eff within 1e-8;
    c. lm6 (low_mem="on") at nl^3 float32 in elasticity and viscosity (K3
       alone) against the plain route: iterations within 1, mean stress
       within 1e-5, a lower peak (torch.cuda.max_memory_allocated), both
       peaks beside the code's reckoning;
    d. lm6 on LM6_BIG, which the plain layout cannot hold, where its
       reckoned peak stays under LM6_BUDGET (K3 first held to its twin on
       the grid's axis lengths);
    e. the multigrid G0 (no kernel) at nm^3 float32 against the FFT G0:
       mean stress within 1e-5;
    f. a three-point tol sweep of ft.experiment.Experiment on the card,
       its .dat table printed;
    g. nc^3 float64 on the card against the CPU: lm6 in elasticity and
       viscosity, the stacked low-memory step, the multigrid G0 (the same
       iterations, histories within 1e-9, mean stress within 1e-10), and
       the float32 refinement (both within 1e-9 of each other)."""
    import tempfile
    import types
    import numpy as np
    import torch
    import fibergen_tpu_torch as ft
    t_phase = time.perf_counter()
    log(f"phase 14: mixed-precision refinement, the low-memory CG, the "
        f"multigrid G0, the sweep harness")

    def free():
        torch.cuda.empty_cache()

    # a. refinement on the sphere
    for scheme, path in (("staggered", "elasticity-refined"),
                         ("collocated", "elasticity-collocated-refined")):
        s64 = sphere_solver(n, "float64", "cuda", scheme=scheme, tol=1e-11,
                            **REF_OPT)
        assert not s64.run()
        S64, its64 = s64.calc_mean_stress(), len(s64.residuals)
        del s64
        free()
        s = sphere_solver(n, "float32", "cuda", scheme=scheme, tol=1e-10,
                          **REF_OPT)
        t0 = time.perf_counter()
        fail, got = run_counted(s, f"{n}^3 float32 {path}", path)
        wall = time.perf_counter() - t0
        path_launches[path] = got
        S = s.calc_mean_stress()
        r_true = s._refiner.residual(s.eps64, s.E)[1]
        d = rel_max(S, S64)
        log(f"  {n}^3 float32 {scheme}, tol 1e-10: "
            f"{len(s.residuals) - s.refine_sweeps} float32 iterations to "
            f"1e-6, {s.refine_sweeps} sweeps, {s.refine_inner_iters} inner "
            f"iterations, wall {wall:.3f} s; final float64 residual "
            f"sqrt(<r, r>) {r_true:.3e} (|E| 1); mean stress {S.tolist()}, "
            f"rel diff to the float64 solve to 1e-11 ({its64} iterations) "
            f"{d:.3e} (limit 1e-9)")
        for k, (rel, rn, inner) in enumerate(s.refine_log, 1):
            log(f"    sweep {k}: correction rel {rel:.3e}, float64 residual "
                f"before it {rn:.3e}, {inner} inner iterations")
        assert not fail and s.eps64 is not None and s.refine_sweeps >= 1
        assert s.residuals[-1] <= 1e-10 and d <= 1e-9, (path, d)
        del s
        free()

    # b. the hashin demo at its shipped tol, float32 refined against float64
    ks = {}
    for dt in ("float", "double"):
        f = ft.FG(os.path.join(DEMO_DIR, "elasticity/hashin/project.xml"),
                  device="cuda")
        f.set("datatype", dt)
        f._init_python()
        f.init_lss()
        t0 = time.perf_counter()
        fail, got = run_counted(f.solver, f"fg-hashin {dt}",
                                "fg-hashin-refined", f.run)
        wall = time.perf_counter() - t0
        if dt == "float":
            path_launches["fg-hashin-refined"] = got
        s = f.solver
        ks[dt] = np.array(f.get_mean_stress())[:3].sum() / 9.0
        log(f"  fg-hashin {dt}, tol {s.opt.tol:g}, grid {s.grid.shape}: "
            f"{len(s.residuals)} entries, {s.refine_sweeps} sweeps, wall "
            f"{wall:.3f} s, k_eff {ks[dt]:.10f}")
        assert fail == 0 and (dt == "double" or s.eps64 is not None)
        del f, s
        free()
    d = abs(ks["float"] - ks["double"]) / abs(ks["double"])
    log(f"  fg-hashin k_eff float32 refined vs float64 rel {d:.3e} (limit "
        f"1e-8); the JAX package's float64 k_eff at n = 64 {HASHIN_K64} "
        f"(PARITY.md)")
    assert d <= 1e-8

    # c. lm6 at nl^3 against the plain route
    lm6_S = None
    for mode in ("elasticity", "viscosity"):
        res = {}
        for lm in ("off", "on"):
            path = f"{mode}-lm6" if lm == "on" else mode
            s = sphere_solver(nl, "float32", "cuda", mode=mode, low_mem=lm,
                              tol=1e-6, **REF_OPT)
            free()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            fail, got = run_counted(s, f"{nl}^3 float32 {path}", path)
            wall = time.perf_counter() - t0
            if lm == "on":
                path_launches[path] = got
                assert s._route == "lm6"
            res[lm] = (len(s.residuals), s.calc_mean_stress(),
                       torch.cuda.max_memory_allocated(), wall)
            assert not fail and s.residuals[-1] <= 1e-6, path
            del s
            free()
        (i0, S0, p0, w0), (i1, S1, p1, w1) = res["off"], res["on"]
        g = ft.Grid(nl, nl, nl)
        d = rel_max(S1, S0)
        log(f"  {nl}^3 float32 {mode}: plain {i0} iterations, wall "
            f"{w0:.3f} s, peak {p0 / 1e9:.2f} GB (reckoned "
            f"{reckoned_gb(g, 'plain', 4):.2f}); lm6 {i1} iterations, wall "
            f"{w1:.3f} s, peak {p1 / 1e9:.2f} GB (reckoned "
            f"{reckoned_gb(g, 'lm6', 4):.2f}); mean stress rel diff {d:.3e}")
        assert abs(i1 - i0) <= 1 and d <= 1e-5 and p1 < p0, (mode, d)
        if mode == "elasticity":
            lm6_S = S1

    # d. lm6 on a grid the plain layout cannot hold
    g = ft.Grid(*LM6_BIG)
    plain_gb, lm6_gb = reckoned_gb(g, "plain", 2), reckoned_gb(g, "lm6", 2)
    log(f"  {LM6_BIG} float32 (the moduli alone kept): reckoned peak plain "
        f"{plain_gb:.1f} GB, lm6 {lm6_gb:.1f} GB (budget "
        f"{LM6_BUDGET / 1e9:.0f} GB, card "
        f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.1f} GB)")
    if lm6_gb * 1e9 <= LM6_BUDGET:
        nx, ny, nz = LM6_BIG
        for shape in ((nx, 64, 32), (64, ny, 32), (64, 32, nz)):
            check_kernels(shape, torch.float32, timed=False)
        free()
        phi = box_sphere(LM6_BIG, np.float32)
        mat = ft.convert.material_from_numpy(
            [("fiber", 10.0, 5.0, phi), ("matrix", 1.0, 1.0, 1.0 - phi)],
            device="cuda")
        del phi
        mat._all_iso()
        mat.drop_phi()
        s = ft.LSSolver(g, mat, ft.SolverOptions(
            low_mem="on", dtype="float32", tol=1e-6, **REF_OPT),
            device="cuda")
        s.set_strain([1.0, 0, 0, 0, 0, 0])
        free()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        fail, got = run_counted(s, f"{LM6_BIG} float32 lm6", "elasticity-lm6")
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        S = s.calc_mean_stress()
        d = rel_max(S, lm6_S)
        log(f"  {LM6_BIG} float32 lm6: {len(s.residuals)} iterations, wall "
            f"{wall:.3f} s ({1e3 * wall / len(s.residuals):.1f} ms an "
            f"iteration), peak {peak / 1e9:.2f} GB, mean stress {S.tolist()}, "
            f"rel diff to {nl}^3 {d:.3e}")
        assert not fail and s._route == "lm6" and s.residuals[-1] <= 1e-6
        assert np.all(np.isfinite(S)) and d <= 2e-2
        del s, mat
        free()
    else:
        m = nl
        while reckoned_gb(ft.Grid(m + 64, m + 64, m + 64), "lm6", 2) * 1e9 \
                <= LM6_BUDGET:
            m += 64
        log(f"  not run: the largest m^3 grid (m a multiple of 64) under the "
            f"budget has m = {m}")

    # e. the multigrid G0 against the FFT G0
    res = {}
    for g0 in ("multigrid", "fft"):
        path = "elasticity-multigrid" if g0 == "multigrid" else "elasticity"
        s = sphere_solver(nm, "float32", "cuda", g0_solver=g0, tol=1e-6,
                          **REF_OPT)
        t0 = time.perf_counter()
        fail, got = run_counted(s, f"{nm}^3 float32 {g0}", path)
        res[g0] = (len(s.residuals), s.calc_mean_stress(),
                   time.perf_counter() - t0)
        assert not fail, g0
    d = rel_max(res["multigrid"][1], res["fft"][1])
    log(f"  {nm}^3 float32 multigrid G0: {res['multigrid'][0]} iterations, "
        f"wall {res['multigrid'][2]:.3f} s; FFT G0 {res['fft'][0]} "
        f"iterations, wall {res['fft'][2]:.3f} s; mean stress rel diff "
        f"{d:.3e} (limit 1e-5)")
    assert d <= 1e-5

    # f. the sweep harness
    with tempfile.TemporaryDirectory() as tmp:
        ex = ft.experiment.Experiment(
            SWEEP_XML, results_dat=os.path.join(tmp, "sweep.json"),
            cache_dir=os.path.join(tmp, "cache"), device="cuda")
        ex.add_param("solver.tol", [1e-3, 1e-5, 1e-7])
        ex.add_results(["num_iterations", "mean_stress"])
        t0 = time.perf_counter()
        rows, got = run_counted(types.SimpleNamespace(par=None),
                                "experiment sweep", "fg-experiment", ex.run)
        wall = time.perf_counter() - t0
        path_launches["fg-experiment"] = got
        dat = os.path.join(tmp, "sweep.dat")
        ft.experiment.write_dat(dat, rows)
        with open(dat) as fh:
            text = fh.read()
        log(f"  experiment: {len(rows)} points in {wall:.3f} s, "
            f"{len(os.listdir(os.path.join(tmp, 'cache')))} cache files; "
            f"sweep.dat:")
        for line in text.strip().splitlines():
            log(f"    {line}")
        its = [r["num_iterations"] for r in rows]
        assert len(rows) == 3 and its == sorted(its) and its[0] < its[-1]
        assert all(np.all(np.isfinite(r["mean_stress"])) for r in rows)

    # g. float64 on the card against the CPU
    cases = {
        "elasticity-lm6": dict(low_mem="on", check_every=4),
        "viscosity-lm6": dict(mode="viscosity", low_mem="on", check_every=4),
        "elasticity-lowmem-stacked": dict(low_mem="on", check_every=1),
        "elasticity-multigrid": dict(g0_solver="multigrid", check_every=4),
    }
    for path, o in cases.items():
        kw = dict(dict(error_estimator="residual", tol=1e-8,
                       maxiter=1000), **o)
        s_cpu = sphere_solver(nc, "float64", "cpu", **kw)
        s_gpu = sphere_solver(nc, "float64", "cuda", **kw)
        assert not s_cpu.run()
        assert not run_counted(s_gpu, f"{nc}^3 float64 {path}", path)[0]
        assert s_gpu._route == s_cpu._route
        rc, rg = np.asarray(s_cpu.residuals), np.asarray(s_gpu.residuals)
        same = len(rc) == len(rg)
        res_rel = float(np.max(np.abs(rg - rc) / np.abs(rc))) if same \
            else float("inf")
        s_rel = rel_max(s_gpu.calc_mean_stress(), s_cpu.calc_mean_stress())
        log(f"  {nc}^3 float64 {path}: iterations cpu {len(rc)} cuda "
            f"{len(rg)}, residual history max rel diff {res_rel:.3e}, mean "
            f"stress max rel diff {s_rel:.3e}")
        assert same and res_rel <= 1e-9 and s_rel <= 1e-10, path
    out = {}
    for dev in ("cpu", "cuda"):
        s = sphere_solver(nc, "float32", dev, tol=1e-10, **REF_OPT)
        if dev == "cuda":
            assert not run_counted(s, f"{nc}^3 float32 refined",
                                   "elasticity-refined")[0]
        else:
            assert not s.run()
        out[dev] = (s.refine_sweeps, s.calc_mean_stress())
    d = rel_max(out["cuda"][1], out["cpu"][1])
    log(f"  {nc}^3 float32 refined to 1e-10: sweeps cpu {out['cpu'][0]} "
        f"cuda {out['cuda'][0]}, mean stress rel diff {d:.3e} (limit 1e-9)")
    assert d <= 1e-9
    log(f"  phase 14 in {time.perf_counter() - t_phase:.1f} s")


# phase 15: the linear paths new on the x-slabs.  path -> the key of
# SHARDED_KERNELS its sharded solve launches; each is held to its
# unsharded solve of an earlier phase (phase 4's staggered viscosity,
# phase 8's uniaxial stress and B = 6 stiffness, phase 9's tiso fibre and
# Reuss, phase 10's Maximum viscosity, laminate and doubly-fine sphere,
# phase 13's Willot and freq_hack), which res32 keeps under the same name
SLAB_PATHS = {
    "viscosity": "viscosity",
    "viscosity-generic": "viscosity-generic",
    "elasticity [mixed BC]": "elasticity",
    "elasticity-collocated [mixed BC]": "elasticity-collocated",
    "elasticity [batched]": "elasticity",
    "elasticity-willot": "elasticity-willot",
    "elasticity-freq-hack": "elasticity-freq-hack",
    "elasticity-general": "elasticity-general",
    "elasticity-reuss": "elasticity-reuss",
    "elasticity-laminate": "elasticity-laminate",
    "elasticity-full-staggered": "elasticity-full-staggered",
}


def slab_path_solver(name, n, dtype, device, mesh=None, **opt):
    """(solver, its run) of phase 15's path ``name`` (SLAB_PATHS) at n^3 in
    ``dtype``, sharded into x-slabs over ``mesh`` when given: the solver
    its earlier phase builds, uniaxial stress under ``[mixed BC]``
    (phase 8: strain xx prescribed, every other stress zero), the six unit
    strains in one run_batched under ``[batched]``."""
    import numpy as np
    base = name.split(" [")[0]
    if base in GENERAL_PATHS:
        s = general_path_solver(n, dtype, device, base, mesh=mesh, **opt)
    elif base in INTERFACE_PATHS:
        s = interface_solver(n, dtype, device, base, mesh=mesh, **opt)
    elif base in METHOD_PATHS:
        s = method_solver(n, dtype, device, base, mesh=mesh, **opt)
    else:
        s = path_solver(n, dtype, device, base, mesh=mesh, **opt)
    if name.endswith("[mixed BC]"):
        P = np.zeros((6, 6))
        P[0, 0] = 1.0
        s.set_bc_projector(P)
        s.set_strain([0.01, 0, 0, 0, 0, 0])
        s.set_stress(np.zeros(6))
    if name.endswith("[batched]"):
        return s, lambda: s.run_batched(np.eye(6))
    return s, s.run


def slab_means(s, name):
    """The mean stress of phase 15's solve (the (B, dim) means of a
    batched one)."""
    return s.calc_mean_stress_batched() if name.endswith("[batched]") \
        else s.calc_mean_stress()


def sharded_paths(run_counted, res32, path_launches, n=256, nc=48):
    """Phase 15: each path of SLAB_PATHS sharded into four x-slabs of one
    card at n^3 float32 (residual tol 1e-6, check_every 8), warm, with its
    wall, peak device memory and launches (its slab kernels and no
    other), held to its unsharded solve of an earlier phase (res32):
    iterations within one, mean stress within 1e-5 of its max; then each
    at nc^3 float64 on four slabs of the card against four CPU slabs
    (phase 6's limits: the same iterations, histories within 1e-9, mean
    stress within 1e-10); with two or more cards, staggered viscosity and
    uniaxial stress over min(4, count) cards."""
    import numpy as np
    import torch
    t_phase = time.perf_counter()
    mesh = ["cuda:0"] * SLABS
    opt = dict(error_estimator="residual", tol=1e-6, check_every=8,
               maxiter=4000)
    log(f"phase 15: the linear paths new on the x-slabs, mesh {mesh}, "
        f"{n}^3 float32, residual tol 1e-6, check_every 8")
    meshes = [mesh]
    ncards = torch.cuda.device_count()
    if ncards >= 2:
        meshes.append([f"cuda:{i}" for i in range(min(4, ncards))])
    for m in meshes:
        names = SLAB_PATHS if m is mesh else ("viscosity",
                                              "elasticity [mixed BC]")
        for name in names:
            s, run = slab_path_solver(name, n, "float32", "cuda", m, **opt)
            assert not run()                     # warm-up
            torch.cuda.reset_peak_memory_stats()
            label = f"{n}^3 float32 {name} [sharded x{len(m)}]"
            t0 = time.perf_counter()
            fail, got = run_counted(s, label, SLAB_PATHS[name], run)
            wall = time.perf_counter() - t0
            if m is mesh:
                path_launches[f"{name} [sharded]"] = got
            its, S = len(s.residuals), slab_means(s, name)
            its0, S0 = res32[name]
            d = float(np.max(np.abs(S - S0)) / np.max(np.abs(S0)))
            log(f"  {label}: {its} iterations (unsharded {its0}), wall "
                f"{wall:.4f} s ({1e3 * wall / its:.2f} ms an iteration), "
                f"final_rel {s.residuals[-1]:.3e}, peak device memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, mean "
                f"stress rel diff to unsharded {d:.3e}")
            assert not fail and s.residuals[-1] <= 1e-6, label
            assert np.all(np.isfinite(S)) and abs(its - its0) <= 1, label
            assert d <= 1e-5, (label, d)
            del s, run
            torch.cuda.empty_cache()
    log(f"  phase 15 at {n}^3 in {time.perf_counter() - t_phase:.1f} s")
    copt = dict(error_estimator="residual", tol=1e-8, check_every=4,
                maxiter=1000)
    for name, kpath in SLAB_PATHS.items():
        (s_cpu, run_cpu), (s_gpu, run_gpu) = (
            slab_path_solver(name, nc, "float64", dev, [dev] * SLABS, **copt)
            for dev in ("cpu", "cuda:0"))
        assert not run_cpu()
        assert not run_counted(s_gpu, f"{nc}^3 float64 {name} [sharded]",
                               kpath, run_gpu)[0]
        rc, rg = np.asarray(s_cpu.residuals), np.asarray(s_gpu.residuals)
        res_rel = float(np.max(np.abs(rg - rc) / np.abs(rc))) \
            if len(rc) == len(rg) else float("inf")
        Sc, Sg = slab_means(s_cpu, name), slab_means(s_gpu, name)
        s_rel = float(np.max(np.abs(Sg - Sc)) / np.max(np.abs(Sc)))
        log(f"  {nc}^3 float64 {name} [sharded]: iterations cpu {len(rc)} "
            f"cuda {len(rg)}, residual history max rel diff {res_rel:.3e}, "
            f"mean stress max rel diff {s_rel:.3e}")
        assert len(rc) == len(rg), f"{name}: iteration counts differ"
        assert res_rel <= 1e-9 and s_rel <= 1e-10, name
        del s_cpu, s_gpu, run_cpu, run_gpu
    log(f"  phase 15 in {time.perf_counter() - t_phase:.1f} s")


# phase 16: the GUI's inline project (two loadsteps, a <view> block that
# records each loadstep's viewed field)
GUI_XML = """<settings>
  <datatype>{datatype}</datatype>
  <solver n="{n}">
    <materials><matrix mu="1" lambda="1" /><fiber mu="10" lambda="5" /></materials>
    <mode>elasticity</mode><tol>{tol}</tol><loadsteps>2</loadsteps>
  </solver>
  <actions>
    <select_material name="fiber" />
    <place_fiber R="0.3" />
    <run_load_case e11="0.01" />
  </actions>
  <view>
    <field>sigma0</field>
    <slice_dim>z</slice_dim>
    <slice_index>0.5</slice_index>
    <record_loadstep>1</record_loadstep>
  </view>
</settings>"""


def rest_of_port(run_counted, res32, path_launches, opt4, n=256, nm=32,
                 ng=64, nc=24, dev="cuda:0"):
    """Phase 16: what the port added last, its launches counted:

    a. the multigrid G0 on four x-slabs of one card at nm^3 in float32 and
       float64 (levels nm -> ... -> 4, the last gathered) against the
       unsharded multigrid solve on the card: the same iterations, mean
       stress within 1e-6 (float32) or 1e-12 (float64) of its max, no
       kernel launched; one float64 G0 application on the card's slabs
       against four CPU slabs (1e-12).  The solves stop at tol 1e-3: the
       slab V-cycle is launch-bound (some 1e5 small PyTorch ops per G0
       application);
    b. sharding_fallback="warn": the n^3 float32 sphere on a three-slab
       mesh of the card (n % 3 != 0) warns, then solves whole on the card:
       iterations, mean stress and launches equal to phase 4's staggered
       CG (``res32``, ``path_launches``; ``opt4`` its options); under
       "error" the SolverError;
    c. the GUI: gui.app.run_project_and_view(show=False) on the card with
       GUI_XML at ng^3 float32: the viewed slice's shape and range, the
       snapshots, the kernels; at nc^3 float64 on the card and the CPU:
       current_slice() within 1e-10.
    ``dev`` the card (the CPU for a dry run of the code at small sizes)."""
    import io
    import tempfile
    import types
    import numpy as np
    import torch
    import fibergen_tpu_torch as ft
    from fibergen_tpu_torch.gui.app import run_project_and_view
    from fibergen_tpu_torch.solvers import multigrid
    from fibergen_tpu_torch.solvers.ls import SolverError
    from fibergen_tpu_torch.utils.logging import LOG
    t_phase = time.perf_counter()
    log("phase 16: the multigrid G0 on x-slabs, sharding_fallback='warn', "
        "the GUI")

    # a. the multigrid G0 on four slabs of the card
    hier = multigrid._SlabHierarchy(ft.Grid(nm, nm, nm), multigrid.MGOptions(),
                                    [torch.device(dev)] * SLABS)
    levels = " -> ".join(str(g.nx) for g in hier.whole.levels)
    log(f"  multigrid levels {levels}: {hier.n_split} split over {SLABS} "
        f"slabs, from {hier.whole.levels[hier.n_split].nx} gathered")
    mopt = dict(g0_solver="multigrid", error_estimator="residual", tol=1e-3,
                check_every=1, maxiter=1000)
    for dtype, lim in (("float32", 1e-6), ("float64", 1e-12)):
        out = {}
        for where, kw in (("whole", dict(device=dev)),
                          ("slabs", dict(device=None, mesh=[dev] * SLABS))):
            s = sphere_solver(nm, dtype, **kw, **mopt)
            t0 = time.perf_counter()
            fail, got = run_counted(s, f"{nm}^3 {dtype} multigrid G0 "
                                    f"[{where}]", "elasticity-multigrid")
            out[where] = (len(s.residuals), s.calc_mean_stress(),
                          time.perf_counter() - t0)
            assert not fail and not any(got.values()), got
        (iw, Sw, tw), (i_s, Ss, ts) = out["whole"], out["slabs"]
        d = rel_max(Ss, Sw)
        log(f"  {nm}^3 {dtype} multigrid G0 on {SLABS} slabs: {i_s} "
            f"iterations, wall {ts:.3f} s; unsharded {iw} iterations, wall "
            f"{tw:.3f} s; mean stress max rel diff {d:.3e} (limit {lim:g})")
        assert i_s == iw and d <= lim
        torch.cuda.empty_cache()
    gen = torch.Generator().manual_seed(16)
    f = torch.randn((3, nm, nm, nm), generator=gen, dtype=torch.float64)
    u = {}
    for d in (dev, "cpu"):
        mesh = ft.parallel.make_mesh([d] * SLABS)
        t0 = time.perf_counter()
        u[d] = ft.parallel.gather_field(multigrid.g0_multigrid_staggered(
            ft.Grid(nm, nm, nm), 1.3, 0.4,
            ft.parallel.shard_field(f.to(d), mesh), -1.0), "cpu")
        u[d + " s"] = time.perf_counter() - t0
    dc = float((u[dev] - u["cpu"]).abs().max() / u["cpu"].abs().max())
    log(f"  one {nm}^3 float64 G0 application on {SLABS} slabs: card "
        f"{u[dev + ' s']:.3f} s, cpu {u['cpu s']:.3f} s, max rel diff "
        f"{dc:.3e} (limit 1e-12)")
    assert dc <= 1e-12

    # b. sharding_fallback="warn" on three slabs of the card
    mesh3 = [dev] * 3
    buf = io.StringIO()
    LOG.enabled, LOG.stream = True, buf
    s = path_solver(n, "float32", None, "elasticity", mesh=mesh3,
                    sharding_fallback="warn", **opt4)
    LOG.enabled, LOG.stream = False, None
    warning = buf.getvalue().strip()
    for line in warning.splitlines():
        log(f"  {line}")
    assert "cannot use the slab FFT: nx=" in warning and \
        f"whole on its first device, {dev}" in warning
    assert s.par is None and s.device == torch.device(dev)
    t0 = time.perf_counter()
    fail, got = run_counted(s, f"{n}^3 float32 elasticity [fallback, 3 "
                            f"slabs]", "elasticity")
    wall = time.perf_counter() - t0
    its, S = len(s.residuals), s.calc_mean_stress()
    its4, S4 = res32["elasticity"]
    same = bool(np.array_equal(S, S4))
    log(f"  {n}^3 float32 elasticity [fallback]: {its} iterations (phase "
        f"4: {its4}), wall {wall:.3f} s, mean stress bitwise phase 4's: "
        f"{same}, launches phase 4's: {got == path_launches['elasticity']}")
    assert not fail and its == its4 and same
    assert got == path_launches["elasticity"]
    path_launches["elasticity [fallback]"] = got
    del s
    torch.cuda.empty_cache()
    try:
        path_solver(n, "float32", None, "elasticity", mesh=mesh3, **opt4)
        raise AssertionError("sharding_fallback='error' solved")
    except SolverError as e:
        log(f"  sharding_fallback='error': SolverError: {str(e)[:80]}...")
    torch.cuda.empty_cache()

    # c. the GUI, headless on the card
    tmp = tempfile.mkdtemp(prefix="fg_gui_")
    paths = {}
    for tag, kw in (("f32", dict(datatype="float", n=ng, tol=1e-6)),
                    ("f64", dict(datatype="double", n=nc, tol=1e-10))):
        paths[tag] = os.path.join(tmp, f"{tag}.xml")
        with open(paths[tag], "w") as f:
            f.write(GUI_XML.format(**kw))
    res = {}
    t0 = time.perf_counter()

    def view():
        res["f32"] = run_project_and_view(paths["f32"], show=False,
                                          device=dev)
    _, got = run_counted(types.SimpleNamespace(par=None),
                         f"{ng}^3 float32 GUI run", "elasticity", view)
    wall = time.perf_counter() - t0
    fg, v = res["f32"]
    path_launches["fg-gui"] = got
    sl = v.current_slice()
    log(f"  {ng}^3 float32 GUI run: viewed {v.field}[{v.component}] "
        f"{v.slice_dim}-slice {sl.shape}, range [{float(sl.min()):.6g}, "
        f"{float(sl.max()):.6g}], {len(v.loadsteps)} loadstep snapshots, "
        f"{len(fg.get_residuals())} residuals, wall {wall:.3f} s (the "
        f"voxelization included), kernels "
        f"{json.dumps({k: c for k, c in got.items() if c})}")
    assert sl.shape == (ng, ng) and np.all(np.isfinite(sl))
    assert len(v.loadsteps) == 3        # loadsteps 0, 1 and 2
    assert "matplotlib" not in sys.modules
    slices = {where: run_project_and_view(paths["f64"], show=False,
                                          device=where)[1].current_slice()
              for where in (dev, "cpu")}
    d = float(np.max(np.abs(slices[dev] - slices["cpu"]))
              / np.max(np.abs(slices["cpu"])))
    log(f"  {nc}^3 float64 GUI run, card vs cpu current_slice(): max rel "
        f"diff {d:.3e} (limit 1e-10)")
    assert d <= 1e-10
    log(f"  phase 16 in {time.perf_counter() - t_phase:.1f} s")


# phase 17: the solver's spans in the benchmark's two cells (fgbench/)
SPAN_CELLS = ("elastic-cases", "elastic-tensor")
FLAGGED = "syncdebug.flagged"


def flagged_syncs(solver, entry, loads, cuda):
    """One request of ``entry`` traced with every synchronisation that
    ``torch.cuda.set_sync_debug_mode("warn")`` flags marked in the trace
    (a zero-length host event ``FLAGGED`` where its warning reaches
    Python, inside the call that synchronised).  Returns (the profile's
    events, the flagged calls' innermost frames in order)."""
    import traceback
    import warnings
    import torch
    from torch.profiler import ProfilerActivity, profile
    from fgbench.harness import program
    sites = []

    def hook(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" in str(message):
            with torch._C._profiler._RecordFunctionFast(FLAGGED):
                pass
            frames = [f for f in traceback.extract_stack()[:-1]
                      if not f.filename.endswith("warnings.py")]
            sites.append(" < ".join(
                f"{os.path.basename(f.filename)}:{f.lineno} {f.name}"
                for f in reversed(frames[-6:])))

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        with profile(activities=acts) as prof:
            if cuda:
                torch.cuda.set_sync_debug_mode("warn")
            try:
                program.call(solver, entry, loads)
            finally:
                if cuda:
                    torch.cuda.set_sync_debug_mode(0)
    return prof.profiler.kineto_results.events(), sites


def solver_spans(dev="cuda:0", n=None, seconds=51.0, seed=2 ** 31 + 17):
    """Phase 17: the solver's spans (``utils.logging.span``, listed in
    ``solvers/ls.py``) on the card, in the benchmark's two cells as
    ``fgbench/`` drives them (``n``: a smaller grid than the cells'):

    a. after a warm-up request, one request of each cell traced under
       ``torch.cuda.set_sync_debug_mode("warn")``: every synchronisation
       the mode flags lies inside an ``fg.sync.*`` span, and their count
       equals the ``fg.sync.*`` spans other than ``fg.sync.end`` (an
       explicit ``torch.cuda.synchronize``, which the mode does not flag);
       no device event bears an ``fg.`` name (the spans are host-scope
       record functions, which the profiler does not mirror onto the
       device);
    b. the cost of the spans while a profiler records: the cases a second
       of a traced window of ``seconds`` of each cell with the spans and
       with ``span()`` stubbed out, in turns (on, off, off, on), and the
       per-layer metrics of each window.
    ``dev`` the CPU for a dry run of the code at small sizes (no
    synchronisation is flagged there, and nothing is asserted)."""
    t_phase = time.perf_counter()
    log(f"phase 17: the solver's spans in {', '.join(SPAN_CELLS)}, seed "
        f"{seed}")
    span_syncs(dev, n, seed)
    span_cost(dev, n, seconds, seed)
    log(f"  phase 17 in {time.perf_counter() - t_phase:.1f} s")


def span_syncs(dev, n, seed):
    """Phase 17 a (``solver_spans``)."""
    import torch
    from fgbench.harness import cell, manifest, problem, program
    from fgbench.harness import traffic as trafficmod
    device = torch.device(dev)
    cuda = device.type == "cuda"
    ft = cell.import_program(manifest.ROOT)
    man = manifest.load_manifest()
    for name in SPAN_CELLS:
        _, config, traffic = manifest.cell(man, name)
        shape = (n,) * 3 if n else tuple(config["grid"])
        rng = problem.rng_of(seed)
        shift = problem.shift_of(config, rng, shape)
        loads = problem.load_cases(config, traffic)
        cases = list(next(trafficmod.requests(traffic, len(loads), rng)))
        solver = program.build(ft, config, problem.phase_field(
            config, shift, shape, device), device)
        program.call(solver, traffic["entry"], loads[cases])    # warm-up
        if cuda:
            torch.cuda.synchronize(device)
        events, sites = flagged_syncs(solver, traffic["entry"], loads[cases],
                                      cuda)
        host = [(int(e.start_ns()), int(e.start_ns()) + int(e.duration_ns()),
                 e.name()) for e in events
                if not str(e.device_type()).endswith("CUDA")]
        on_device = sorted({e.name() for e in events
                            if str(e.device_type()).endswith("CUDA")
                            and e.name().startswith("fg.")})
        syncs = [h for h in host if h[2].startswith("fg.sync.")]
        marks = sorted(h[0] for h in host if h[2] == FLAGGED)
        spans_by = collections.Counter(w for _, _, w in syncs)
        flagged_by = collections.Counter()
        outside = []
        for t, site in zip(marks, sites):
            within = [h for h in syncs if h[0] <= t <= h[1]]
            if within:
                flagged_by[max(within)[2]] += 1
            else:
                outside.append(site)
        log(f"  {name} ({traffic['entry']}, {len(cases)} case(s), "
            f"{len(solver.residuals)} iterations): {len(marks)} syncs "
            f"flagged; fg.sync spans {json.dumps(spans_by, sort_keys=True)}"
            f", flagged in them {json.dumps(flagged_by, sort_keys=True)}; "
            f"fg. names on the device: {on_device}")
        for site in outside:
            log(f"    flagged outside every fg.sync span: {site}")
        if cuda:
            end = "fg.sync.end"
            assert len(marks) == len(sites) and not outside, name
            assert all(flagged_by[w] == c for w, c in spans_by.items()
                       if w != end), (name, flagged_by, spans_by)
            assert flagged_by[end] in (0, spans_by[end]), name
            assert not on_device, on_device
        del solver, events
        if cuda:
            torch.cuda.empty_cache()


def span_cost(dev, n, seconds, seed):
    """Phase 17 b (``solver_spans``)."""
    import io
    from fgbench.harness import cell
    from fibergen_tpu_torch.utils import logging as fglog

    def window(name, stub):
        saved = fglog._RecordFunctionFast
        if stub:
            fglog._RecordFunctionFast = lambda _name: fglog._OFF
        try:
            rc, res = cell.execute(name, seed, seconds, True,
                                   t_process=time.perf_counter(),
                                   device=dev, shape=None if not n else
                                   (n,) * 3, log=io.StringIO())
        finally:
            fglog._RecordFunctionFast = saved
        assert rc == 0 and res["correct"], (name, stub, rc, res)
        rate = res["attempted"] / res["device"]["window_s"]
        layers = {k: v["value"] for k, v in res["metrics"].items()}
        log(f"  {name} traced {seconds:g} s, spans "
            f"{'stubbed' if stub else 'on'}: {rate!r} cases/s "
            f"({res['attempted']} in {res['device']['window_s']!r} s), "
            f"{json.dumps(layers)}")
        return rate

    for name in SPAN_CELLS:
        rates = {False: [], True: []}
        for stub in (False, True, True, False):
            rates[stub].append(window(name, stub))
        on, off = (sum(rates[k]) / 2 for k in (False, True))
        log(f"  {name}: the spans' cost while traced "
            f"{100 * (off / on - 1):.3f} % (cases/s stubbed {off!r}, on "
            f"{on!r})")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    import numpy as np
    import fibergen_tpu_torch as ft
    from fibergen_tpu_torch.ops import _build
    from fibergen_tpu_torch.ops import material_kernels as mk
    from fibergen_tpu_torch.ops import spectral_kernels as spk
    from fibergen_tpu_torch.ops import stencil_kernels as sk
    from fibergen_tpu_torch.ops import vector_kernels as vk
    from fibergen_tpu_torch.utils.logging import LOG

    t_start = time.perf_counter()
    LOG.enabled = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = card.splitlines()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    # ---- phase 1: build
    t0 = time.perf_counter()
    out = _build.build_all()
    log(f"phase 1: kernels in {out}, {len(_build.ptxas_log)} sources "
        f"compiled in this run, {time.perf_counter() - t0:.1f} s")
    for src, text in sorted(_build.ptxas_log.items()):
        regs = [int(w) for w in re.findall(r"Used (\d+) registers", text)]
        spills = [line.strip() for line in text.splitlines()
                  if "spill" in line and not line.strip().startswith("0 ")]
        log(f"  {src}: {len(regs)} kernels, at most {max(regs, default=0)} "
            f"registers a thread, {len(spills)} with spills")

    update_launches = {}    # label -> the CG update's launches in it

    def run_counted(solver, label, path, fn=None, batched=False):
        """Run one solve (``fn``, the solver's run by default) with every
        launch count set to 0 just before it; fail unless each kernel of
        ``path`` launched in it and no other.  ``batched``: ``fn`` is a
        whole-field run_batched, which launches the path's chain batched
        (BATCHED_CHAIN) and never its single chain."""
        for table in (sk.launches, spk.launches, vk.launches, mk.launches):
            for name in table:
                table[name] = 0
        fail = (fn or solver.run)()
        sync_all()
        got = dict(sk.launches, **spk.launches, **mk.launches)
        log(f"  {label} launches: {json.dumps(got)}, the CG's vector "
            f"update {vk.launches['cg_update']}")
        want = PATH_KERNELS[path] if solver.par is None else \
            SHARDED_KERNELS[path]
        if batched and solver.par is None:
            want = tuple(BATCHED_CHAIN.get(k, k) for k in want)
        assert all((got[k] > 0) == (k in want) for k in got), (label, got)
        update_launches[label] = vk.launches["cg_update"]
        return fail, got

    # ---- phase 2: kernels against their twins
    log("phase 2: kernels vs plain twins")
    main_nums = check_kernels((256, 256, 256), torch.float32, timed=True)
    check_kernels((33, 17, 29), torch.float64, timed=False)
    # power-of-two axes: the chains' register line FFT in float64
    check_kernels((64, 32, 16), torch.float64, timed=False)
    # phase 10's 64^3 shapes: Nunan-Keller (float32) and the mixed-BC
    # viscosity solve (float64), length 64 on every axis
    check_kernels((64, 64, 64), torch.float32, timed=False)
    check_kernels((64, 64, 64), torch.float64, timed=False)
    # phase 11's heat demo (128 x 128 x 1, float32 and its float64 check
    # against the CPU) and an odd grid, on the one-voxel z axis the chains
    # take by their direct-DFT z lines
    check_kernels((128, 128, 1), torch.float32, timed=False)
    check_kernels((128, 128, 1), torch.float64, timed=False)
    check_kernels((33, 17, 1), torch.float64, timed=False)
    # the CG's vector update: timed at 256^3 float32, checked on an odd
    # grid (the scalar tail) in both precisions
    main_nums.update(check_cg_update((256, 256, 256), torch.float32,
                                     timed=True))
    for dt in (torch.float32, torch.float64):
        check_cg_update((33, 17, 29), dt, timed=False)
    # the dim-3 laminate: timed on the fibre mat's 4096 x 4096 x 1 in
    # float32, checked on an odd grid (the scalar path) in both precisions
    main_nums.update(check_laminate_heat((4096, 4096, 1), torch.float32,
                                         timed=True))
    for dt in (torch.float32, torch.float64):
        check_laminate_heat((33, 17, 29), dt, timed=False)
    torch.cuda.empty_cache()
    # the batched chains (run_batched's): bitwise B single launches and
    # their twins on every shape above in float32 and float64 (256^3 in
    # float32), timed at 256^3 with phase 8's batch sizes and, for K3, at
    # phase 10's 64^3 Nunan-Keller batch (B = 5)
    log("phase 2: batched chains vs single launches and plain twins")
    main_nums.update(check_batched_chains(
        (256, 256, 256), torch.float32, timed=True,
        sizes={k: v[3] for k, v in BATCHED.items()}))
    for shape in ((33, 17, 29), (64, 32, 16), (64, 64, 64), (128, 128, 1),
                  (33, 17, 1)):
        for dt in (torch.float64, torch.float32):
            check_batched_chains(shape, dt, timed=False)
    check_batched_chains((64, 64, 64), torch.float32, timed=True,
                         sizes={"g0_staggered_chain_batched": 5})

    # ---- phase 3: kernel path vs plain path on the same solve
    log("phase 3: 48^3 float64 solves, cuda kernels vs cpu twins")
    opt = dict(error_estimator="residual", tol=1e-8, check_every=4,
               maxiter=1000)
    for path in LINEAR_PATHS:
        # the epsilon estimator of the polarization scheme subtracts two
        # norms: at 1e-8 their rounding would show in the 1e-9 comparison
        popt = dict(opt, tol=1e-6) if PATHS[path][2] == "polarization" \
            else opt
        s_cpu = path_solver(48, "float64", "cpu", path, **popt)
        s_gpu = path_solver(48, "float64", "cuda", path, **popt)
        assert not s_cpu.run()
        assert not run_counted(s_gpu, f"48^3 float64 {path}", path)[0]
        rc, rg = np.asarray(s_cpu.residuals), np.asarray(s_gpu.residuals)
        res_rel = float(np.max(np.abs(rg - rc) / np.abs(rc))) \
            if len(rc) == len(rg) else float("inf")
        Sc, Sg = s_cpu.calc_mean_stress(), s_gpu.calc_mean_stress()
        s_rel = float(np.max(np.abs(Sg - Sc)) / np.max(np.abs(Sc)))
        log(f"  {path}: iterations cpu {len(rc)} cuda {len(rg)}, residual "
            f"history max rel diff {res_rel:.3e}, mean stress max rel diff "
            f"{s_rel:.3e}")
        assert len(rc) == len(rg), f"{path}: iteration counts differ"
        assert res_rel <= 1e-9 and s_rel <= 1e-10, path
        del s_cpu, s_gpu

    def newton_cuda_vs_cpu(path, slabs=None):
        """A 24^3 float64 Newton solve of ``path`` on the card against the
        same solve on the CPU (with ``slabs``, on that many slabs of
        cuda:0 against as many CPU slabs): the same outer and inner
        iterations; the history holds the inner residual and the outer
        epsilon entries, and an epsilon entry, a difference of two norms,
        compares within 1e-9 relative or 1e-14 absolute; mean PK1 within
        1e-10."""
        hopt = dict(HYPER_OPT, tol=1e-6, check_every=4)
        tag = "" if slabs is None else " [sharded]"
        mesh = lambda d: None if slabs is None else [d] * slabs
        s_cpu = path_solver(24, "float64", "cpu", path, mesh=mesh("cpu"),
                            **hopt)
        s_gpu = path_solver(24, "float64", "cuda", path,
                            mesh=mesh("cuda:0"), **hopt)
        assert not s_cpu.run()
        assert not run_counted(s_gpu, f"24^3 float64 {path}{tag}", path)[0]
        rc, rg = np.asarray(s_cpu.residuals), np.asarray(s_gpu.residuals)
        same = len(rc) == len(rg) and \
            s_cpu.newton_iterations == s_gpu.newton_iterations
        res_rel = float(np.max(np.abs(rg - rc) / np.abs(rc))) if same \
            else float("inf")
        Sc, Sg = s_cpu.calc_mean_stress(), s_gpu.calc_mean_stress()
        s_rel = float(np.max(np.abs(Sg - Sc)) / np.max(np.abs(Sc)))
        log(f"  {path}{tag}: iterations cpu {len(rc)} "
            f"{s_cpu.newton_iterations} cuda {len(rg)} "
            f"{s_gpu.newton_iterations} (outer, inner), residual history "
            f"max rel diff {res_rel:.3e}, mean PK1 max rel diff "
            f"{s_rel:.3e}")
        assert same, f"{path}{tag}: iteration counts differ"
        assert np.all(np.abs(rg - rc) <= 1e-9 * np.abs(rc) + 1e-14), path
        assert s_rel <= 1e-10, path

    for path in HYPER_PATHS:
        newton_cuda_vs_cpu(path)

    # ---- phase 4: the paths at full size
    log("phase 4: bench sphere RVE, residual tol 1e-6, check_every 8")
    opt = dict(error_estimator="residual", tol=1e-6, check_every=8,
               maxiter=4000)
    path_launches, res32 = {}, {}
    for path in LINEAR_PATHS:
        s32 = path_solver(256, "float32", "cuda", path, **opt)
        assert not s32.run()                     # warm-up
        fail, got = run_counted(s32, f"256^3 float32 {path}", path)
        path_launches[path] = got
        its = len(s32.residuals)
        # one launch of the path's chain per step, one more at CG init
        steps = got[PATH_KERNELS[path][-1]] - (PATHS[path][2] == "cg")
        final_rel = float(s32.residuals[-1])
        S32 = s32.calc_mean_stress()
        log(f"  256^3 float32 {path}: {its} iterations ({steps} steps "
            f"run), solve_time {s32.solve_time:.4f} s, "
            f"{its / s32.solve_time:.2f} iter/s, "
            f"{steps / s32.solve_time:.2f} steps/s, final_rel "
            f"{final_rel:.3e}, mean stress {S32.tolist()}")
        assert not fail and its < opt["maxiter"] and final_rel <= 1e-6
        assert np.all(np.isfinite(S32))
        res32[path] = (its, S32)
        del s32
        torch.cuda.empty_cache()
    # polarization and collocated CG solve the same discretization; the
    # epsilon estimator stops the polarization scheme a few 1e-5 away
    d = float(np.max(np.abs(res32["elasticity-polarization"][1]
                            - res32["elasticity-collocated"][1]))
              / np.max(np.abs(res32["elasticity-collocated"][1])))
    log(f"  polarization vs collocated CG mean stress: rel diff {d:.3e}")
    assert d <= 5e-4
    its, S32 = res32["elasticity"]

    s64 = sphere_solver(256, "float64", "cuda", **opt)
    assert not run_counted(s64, "256^3 float64", "elasticity")[0]
    S64 = s64.calc_mean_stress()
    d = float(np.max(np.abs(S64 - S32)) / np.max(np.abs(S64)))
    log(f"  256^3 float64: {len(s64.residuals)} iterations, solve_time "
        f"{s64.solve_time:.4f} s, final_rel {s64.residuals[-1]:.3e}, mean "
        f"stress {S64.tolist()}, rel diff to float32 {d:.3e}")
    assert abs(len(s64.residuals) - its) <= 2 and d <= 1e-5
    del s64
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    s512 = sphere_solver(512, "float32", "cuda", **opt)
    t0 = time.perf_counter()
    assert not run_counted(s512, "512^3 float32", "elasticity")[0]
    wall = time.perf_counter() - t0
    S512 = s512.calc_mean_stress()
    log(f"  512^3 float32: {len(s512.residuals)} iterations, wall {wall:.3f}"
        f" s (solve_time {s512.solve_time:.4f} s, first run), final_rel "
        f"{s512.residuals[-1]:.3e}, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, mean stress "
        f"{S512.tolist()}")
    assert s512.residuals[-1] <= 1e-6 and np.all(np.isfinite(S512))
    del s512
    torch.cuda.empty_cache()

    log("phase 4: hyperelastic bench, 256^3 SVK sphere at 2 % stretch, "
        "tol 1e-5, residual inner / epsilon outer, check_every 8")
    hyper = {}
    for path, tangent in (("hyperelasticity", "exact"),
                          ("hyperelasticity-collocated", "exact"),
                          ("hyperelasticity", "frozen_iso")):
        label = f"256^3 float32 {path} [{tangent}]"
        s = path_solver(256, "float32", "cuda", path, newton_tangent=tangent,
                        **HYPER_OPT)
        if tangent == "exact":
            assert not s.run()                   # warm-up
        torch.cuda.reset_peak_memory_stats()
        fail, got = run_counted(s, label, path)
        if tangent == "exact":
            path_launches[path] = got
        outer, inner = s.newton_iterations
        P = s.calc_mean_stress()
        detf = s.calc_min_det_f()
        log(f"  {label}: {len(s.residuals)} entries ({outer} outer, {inner} "
            f"inner iterations, {got[PATH_KERNELS[path][0]]} chain "
            f"launches), solve_time {s.solve_time:.4f} s, "
            f"{inner / s.solve_time:.2f} inner it/s, min det F {detf:.6f}, "
            f"peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, mean PK1 "
            f"{P.tolist()}")
        assert not fail and len(s.residuals) < HYPER_OPT["maxiter"]
        assert np.all(np.isfinite(P)) and np.isfinite(detf) and detf > 0
        hyper[(path, tangent)] = (outer, inner, P)
        del s
        torch.cuda.empty_cache()
    for key, (_, _, P) in hyper.items():
        d = abs(P[0] - HYPER_P11) / HYPER_P11
        log(f"  {key[0]} [{key[1]}] P11 {P[0]:.6f} vs the JAX package's "
            f"{HYPER_P11} (rel {d:.3e})")
    assert abs(hyper[("hyperelasticity", "exact")][2][0] - HYPER_P11) \
        <= 5e-4 * HYPER_P11

    # ---- phase 5: analytic oracles
    shape = (64, 16, 16)
    x = (np.arange(shape[0]) + 0.5) / shape[0]
    phi = np.broadcast_to((x < 0.5)[:, None, None], shape).astype(np.float64)
    (mu1, lam1), (mu2, lam2) = (1.0, 2.0), (10.0, 5.0)
    for scheme, path in (("staggered", "elasticity"),
                         ("collocated", "elasticity-collocated")):
        mat = ft.convert.material_from_numpy(
            [("a", mu1, lam1, phi), ("b", mu2, lam2, 1.0 - phi)])
        s = ft.LSSolver(ft.Grid(*shape), mat, ft.SolverOptions(
            gamma_scheme=scheme, tol=1e-10, error_estimator="residual",
            check_every=4, maxiter=500))
        s.set_strain([1.0, 0, 0, 0, 0, 0])
        assert not run_counted(s, f"{scheme} laminate", path)[0]
        c11 = float(s.calc_mean_stress()[0])
        exact = 1.0 / (0.5 / (lam1 + 2 * mu1) + 0.5 / (lam2 + 2 * mu2))
        log(f"phase 5: {scheme} laminate C11 {c11:.12f} vs exact "
            f"{exact:.12f} (rel {abs(c11 - exact) / exact:.3e}, "
            f"{len(s.residuals)} its)")
        assert abs(c11 - exact) <= 1e-8 * exact
    # series conduction: the harmonic mean of the conductivities
    k1, k2 = 1.0, 10.0
    for scheme, path in (("staggered", "heat"),
                         ("collocated", "heat-collocated")):
        mat = ft.convert.material_from_numpy(
            [("a", k1, phi), ("b", k2, 1.0 - phi)], dim=3, law="scalar")
        s = ft.LSSolver(ft.Grid(*shape), mat, ft.SolverOptions(
            mode="heat", gamma_scheme=scheme, tol=1e-10,
            error_estimator="residual", check_every=4, maxiter=500))
        s.set_strain([1.0, 0, 0])
        assert not run_counted(s, f"{scheme} heat laminate", path)[0]
        k = float(s.calc_mean_stress()[0])
        exact = 2 * k1 * k2 / (k1 + k2)
        log(f"phase 5: {scheme} heat laminate conductivity {k:.12f} vs "
            f"exact {exact:.12f} (rel {abs(k - exact) / exact:.3e}, "
            f"{len(s.residuals)} its)")
        assert abs(k - exact) <= 1e-8 * exact
    # SVK at a small strain h: P11 / h is the linear laminate's C11
    h = 1e-5
    mat = ft.convert.material_from_numpy(
        [("a", mu1, lam1, phi), ("b", mu2, lam2, 1.0 - phi)], dim=9,
        law="svk")
    s = ft.LSSolver(ft.Grid(*shape), mat, ft.SolverOptions(
        mode="hyperelasticity", tol=1e-8, error_estimator="residual",
        outer_error_estimator="epsilon", check_every=4, maxiter=500))
    s.set_strain([1.0 + h, 1, 1, 0, 0, 0, 0, 0, 0])
    assert not run_counted(s, "SVK laminate", "hyperelasticity")[0]
    c11 = float(s.calc_mean_stress()[0]) / h
    exact = 1.0 / (0.5 / (lam1 + 2 * mu1) + 0.5 / (lam2 + 2 * mu2))
    log(f"phase 5: SVK laminate at strain {h:g}: P11/h {c11:.9f} vs linear "
        f"C11 {exact:.9f} (rel {abs(c11 - exact) / exact:.3e}, "
        f"{s.newton_iterations} outer/inner)")
    assert abs(c11 - exact) <= 1e-3 * exact

    # ---- phase 6: the x-slab sharded solve on four slabs of one card
    mesh = ["cuda:0"] * SLABS
    log(f"phase 6: sharded x-slab solve, mesh {mesh}")
    slab_nums = check_slab_kernels((256, 256, 256), torch.float32, mesh,
                                   timed=True)
    check_slab_kernels((48, 48, 48), torch.float64, mesh, timed=False)
    check_slab_kernels((64, 64, 64), torch.float64, mesh, timed=False)
    check_slab_kernels((33, 16, 29), torch.float64, ["cuda:0"], timed=False)
    torch.cuda.empty_cache()
    opt = dict(error_estimator="residual", tol=1e-8, check_every=4,
               maxiter=1000)
    for path in SHARDED_PATHS:
        popt = dict(opt, tol=1e-6) if PATHS[path][2] == "polarization" \
            else opt
        s_cpu = path_solver(48, "float64", "cpu", path, mesh=["cpu"] * SLABS,
                            **popt)
        s_gpu = path_solver(48, "float64", "cuda", path, mesh=mesh, **popt)
        assert not s_cpu.run()
        assert not run_counted(s_gpu, f"48^3 float64 {path} [sharded]",
                               path)[0]
        rc, rg = np.asarray(s_cpu.residuals), np.asarray(s_gpu.residuals)
        res_rel = float(np.max(np.abs(rg - rc) / np.abs(rc))) \
            if len(rc) == len(rg) else float("inf")
        Sc, Sg = s_cpu.calc_mean_stress(), s_gpu.calc_mean_stress()
        s_rel = float(np.max(np.abs(Sg - Sc)) / np.max(np.abs(Sc)))
        log(f"  {path} [sharded]: iterations cpu {len(rc)} cuda {len(rg)}, "
            f"residual history max rel diff {res_rel:.3e}, mean stress max "
            f"rel diff {s_rel:.3e}")
        assert len(rc) == len(rg), f"{path}: iteration counts differ"
        assert res_rel <= 1e-9 and s_rel <= 1e-10, path
        del s_cpu, s_gpu
    for path in HYPER_PATHS:
        newton_cuda_vs_cpu(path, SLABS)
    opt = dict(error_estimator="residual", tol=1e-6, check_every=8,
               maxiter=4000)
    meshes = [mesh]
    ncards = torch.cuda.device_count()
    if ncards >= 2:
        meshes.append([f"cuda:{i}" for i in range(min(4, ncards))])
    for m in meshes:
        log(f"  256^3 float32 sharded solves on the mesh {m} "
            f"({len(set(m))} card(s), {len(m)} slabs)")
        for path in SHARDED_PATHS if m is mesh else ("elasticity",):
            s = path_solver(256, "float32", "cuda", path, mesh=m, **opt)
            assert not s.run()                   # warm-up
            torch.cuda.reset_peak_memory_stats()
            label = f"256^3 float32 {path} [sharded x{len(m)}]"
            fail, got = run_counted(s, label, path)
            if m is mesh:
                path_launches[f"{path} [sharded]"] = got
            its, S = len(s.residuals), s.calc_mean_stress()
            its0, S0 = res32[path]
            d = float(np.max(np.abs(S - S0)) / np.max(np.abs(S0)))
            log(f"  {label}: {its} iterations (unsharded {its0}), solve_time "
                f"{s.solve_time:.4f} s, {its / s.solve_time:.2f} iter/s, "
                f"final_rel {s.residuals[-1]:.3e}, peak device memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, mean "
                f"stress rel diff to unsharded {d:.3e}")
            assert not fail and s.residuals[-1] <= 1e-6
            assert abs(its - its0) <= 1
            assert d <= (1e-5 if its == its0 else 5e-4), (path, d)
            del s
            torch.cuda.empty_cache()
        # the hyperelastic bench on the slabs against phase 4's unsharded
        # solve, warm as that one is
        for path in HYPER_PATHS if m is mesh else ("hyperelasticity",):
            label = f"256^3 float32 {path} [exact, sharded x{len(m)}]"
            s = path_solver(256, "float32", "cuda", path, mesh=m,
                            **HYPER_OPT)
            assert not s.run()                   # warm-up
            torch.cuda.reset_peak_memory_stats()
            fail, got = run_counted(s, label, path)
            if m is mesh:
                path_launches[f"{path} [sharded]"] = got
            outer, inner = s.newton_iterations
            P = s.calc_mean_stress()
            o0, i0, P0 = hyper[(path, "exact")]
            d = float(np.max(np.abs(P - P0)) / np.max(np.abs(P0)))
            log(f"  {label}: {outer} outer, {inner} inner iterations "
                f"(unsharded {o0}, {i0}), {got[SHARDED_KERNELS[path][0]]} "
                f"slab chain launches, solve_time {s.solve_time:.4f} s, "
                f"{inner / s.solve_time:.2f} inner it/s, peak device memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, P11 "
                f"{P[0]:.6f} (the JAX package's {HYPER_P11}), mean PK1 rel "
                f"diff to unsharded {d:.3e}")
            assert not fail and np.all(np.isfinite(P))
            assert abs(outer - o0) <= 1 and abs(inner - i0) <= 1, label
            assert abs(P[0] - HYPER_P11) <= 5e-4 * HYPER_P11, label
            assert d <= (1e-5 if (outer, inner) == (o0, i0) else 5e-4), \
                (label, d)
            del s
            torch.cuda.empty_cache()

    # ---- phase 8: load cases
    load_cases(run_counted, res32, path_launches)

    # ---- phase 9: general linear materials
    general_materials(run_counted, res32, path_launches)

    # ---- phase 10: interface laminates, the doubly-fine grid, the generic
    # staggered Delta path
    interfaces_and_dfg(run_counted, res32, path_launches)

    # ---- phase 11: the XML front end
    front_end(run_counted, path_launches)

    # ---- phase 12: meshes and file I/O
    meshes_and_io(run_counted, path_launches, card)

    # ---- phase 13: the remaining methods and schemes
    remaining_methods(run_counted, res32, hyper, path_launches)

    # ---- phase 14: refinement, the low-memory CG, the multigrid G0, the
    # sweep harness
    mixed_precision_low_memory(run_counted, path_launches)

    # ---- phase 15: the linear paths new on the x-slabs
    sharded_paths(run_counted, res32, path_launches)

    # ---- phase 16: the multigrid G0 on x-slabs, the fallback, the GUI
    rest_of_port(run_counted, res32, path_launches,
                 dict(error_estimator="residual", tol=1e-6, check_every=8,
                      maxiter=4000))

    # ---- phase 17: the solver's spans in the benchmark's cells
    solver_spans()

    # ---- phase 7: launches and per-kernel numbers.  The per-kernel list
    # takes the key "kernels"; the launch counts of each path's timed 256^3
    # float32 solve print on their own line as "kernel_launches".  A mode's
    # row takes its launches from the path that runs that mode, plus those
    # of the phase-9 paths that run it (more_paths).
    log(json.dumps({"kernel_launches": path_launches}))
    k1, k2, ch = ("fibergen_tpu_torch/csrc/stress_div_beta.cu",
                  "fibergen_tpu_torch/csrc/eps_from_u_dot.cu",
                  "fibergen_tpu_torch/csrc/g0_staggered_chain.cu")
    rows = [("cg_update", "cg_update", "elasticity",
             "fibergen_tpu_torch/csrc/cg_update.cu",
             "fibergen_tpu/solvers/ls.py:679 (an XLA fusion)"),
            ("stress_div_beta", "stress_div_beta", "elasticity", k1,
             "fibergen_tpu/ops/pallas_sweep.py:301"),
            ("stress_div_beta[tau_sum]", "stress_div_beta", "viscosity", k1,
             "fibergen_tpu/ops/pallas_sweep.py:301"),
            ("eps_from_u_dot", "eps_from_u_dot", "elasticity", k2,
             "fibergen_tpu/ops/pallas_sweep.py:517"),
            ("eps_from_u_dot[delta]", "eps_from_u_dot", "viscosity", k2,
             "fibergen_tpu/ops/pallas_sweep.py:517"),
            ("g0_staggered_chain", "g0_staggered_chain", "elasticity", ch,
             "fibergen_tpu/ops/pallas_chain.py:212"),
            ("g0_staggered_heat_chain", "g0_staggered_heat_chain", "heat",
             ch, "fibergen_tpu/ops/pallas_chain.py:212"),
            ("gamma_collocated_chain", "gamma_collocated_chain",
             "elasticity-collocated", ch,
             "fibergen_tpu/ops/pallas_chain.py:385"),
            ("gamma_collocated_chain[heat]", "gamma_collocated_chain",
             "heat-collocated", ch, "fibergen_tpu/ops/pallas_chain.py:385"),
            ("gamma_collocated_zt_chain", "gamma_collocated_zt_chain",
             "viscosity-collocated", ch,
             "fibergen_tpu/ops/pallas_chain.py:430"),
            ("gamma_collocated_chain[hyper]", "gamma_collocated_chain",
             "hyperelasticity-collocated", ch,
             "fibergen_tpu/ops/pallas_chain.py:385"),
            ("g0_staggered_chain[hyper]", "g0_staggered_chain",
             "hyperelasticity", ch, "fibergen_tpu/ops/pallas_chain.py:212"),
            ("laminate_heat", "laminate_heat", "heat-laminate",
             "fibergen_tpu_torch/csrc/laminate_heat.cu",
             "none: plain jnp, fibergen_tpu/materials/laminate.py")]
    pk_, pc_ = ("fibergen_tpu/ops/pallas_kernels.py",
                "fibergen_tpu/ops/pallas_chain.py")
    slab_rows = [
        ("stress_div_beta[halo]", "stress_div_beta_halo", k1, f"{pk_}:268"),
        ("stress_div_beta[halo,init]", "stress_div_beta_halo", k1,
         f"{pk_}:191"),
        ("eps_from_u_dot[halo]", "eps_from_u_dot_halo", k2, f"{pk_}:392"),
        ("eps_from_u_dot[halo,nodot]", "eps_from_u_dot_halo", k2,
         f"{pk_}:331"),
        ("g0_staggered_chain_slab", "g0_staggered_chain_slab", ch,
         f"{pc_}:470"),
        ("g0_staggered_heat_chain_slab", "g0_staggered_heat_chain_slab", ch,
         f"{pc_}:470"),
        ("gamma_collocated_chain_slab", "gamma_collocated_chain_slab", ch,
         f"{pc_}:470"),
        ("gamma_collocated_chain_slab[heat]", "gamma_collocated_chain_slab",
         ch, f"{pc_}:470"),
        ("gamma_collocated_zt_chain_slab", "gamma_collocated_zt_chain_slab",
         ch, f"{pc_}:470")]
    slab_path = {"stress_div_beta_halo": "elasticity",
                 "eps_from_u_dot_halo": "elasticity",
                 "g0_staggered_chain_slab": "elasticity",
                 "g0_staggered_heat_chain_slab": "heat",
                 "gamma_collocated_chain_slab": "elasticity-collocated",
                 "gamma_collocated_zt_chain_slab": "viscosity-collocated"}
    rows += [(name, counter, f"{slab_path[counter]} [sharded]", src, rep)
             for name, counter, src, rep in slab_rows]
    # the batched chains (run_batched's, #7 under vmap), from phase 8
    rows += [("g0_staggered_chain_batched", "g0_staggered_chain_batched",
              "elasticity [batched]", ch, f"{pc_}:212"),
             ("g0_staggered_heat_chain_batched",
              "g0_staggered_heat_chain_batched", "heat [batched]", ch,
              f"{pc_}:212"),
             ("gamma_collocated_chain_batched",
              "gamma_collocated_chain_batched",
              "elasticity-collocated [batched]", ch, f"{pc_}:212"),
             ("gamma_collocated_chain_batched[heat]",
              "gamma_collocated_chain_batched", "heat-collocated [batched]",
              ch, f"{pc_}:212"),
             ("gamma_collocated_zt_chain_batched",
              "gamma_collocated_zt_chain_batched",
              "viscosity-collocated [batched]", ch, f"{pc_}:212")]
    rows += [("gamma_collocated_chain_slab[hyper]",
              "gamma_collocated_chain_slab",
              "hyperelasticity-collocated [sharded]", ch, f"{pc_}:470"),
             ("g0_staggered_chain_slab[hyper]", "g0_staggered_chain_slab",
              "hyperelasticity [sharded]", ch, f"{pc_}:470"),
             ("stress_div_beta[halo,tau_sum]", "stress_div_beta_halo",
              "viscosity [sharded]", k1,
              "fibergen_tpu/ops/pallas_sweep.py:301"),
             ("eps_from_u_dot[halo,delta]", "eps_from_u_dot_halo",
              "viscosity [sharded]", k2,
              "fibergen_tpu/ops/pallas_sweep.py:517")]
    k1k2_paths = ("elasticity-nesterov", "elasticity-basic-el",
                  "elasticity-cg-reinit", "elasticity-sigma",
                  "elasticity-refined", "fg-hashin-refined", "fg-experiment",
                  "elasticity [fallback]", "fg-gui")
    more_paths = {
        "stress_div_beta": ("elasticity-reuss", "fg-hashin",
                            "fg-digital-rocks") + k1k2_paths,
        "eps_from_u_dot": ("elasticity-reuss", "fg-hashin",
                           "fg-digital-rocks") + k1k2_paths,
        "g0_staggered_chain": ("elasticity-general", "elasticity-tiso-field",
                               "elasticity-reuss",
                               "elasticity-full-staggered",
                               "elasticity-laminate", "viscosity-generic",
                               "viscosity-lambda", "viscosity-fluidity",
                               "fg-hashin", "fg-transverse-isotropy",
                               "fg-digital-rocks", "fg-tetmesh",
                               "recover-elasticity", "recover-viscosity",
                               "elasticity-lm6", "viscosity-lm6")
        + k1k2_paths,
        "g0_staggered_heat_chain": ("heat-aniso", "heat-laminate",
                                    "fg-stl", "recover-heat",
                                    "recover-viscosity"),
        "g0_staggered_chain_batched": ("elasticity-general [batched]",
                                       "viscosity-nunan-keller",
                                       "fg-nunan-keller"),
        "g0_staggered_heat_chain_batched": ("fg-heat",),
        "laminate_heat": ("fg-heat",),
        "gamma_collocated_chain": ("elasticity-general-collocated",
                                   "elasticity-laminate-collocated",
                                   "elasticity-nesterov-collocated",
                                   "elasticity-basic-el-collocated",
                                   "elasticity-collocated-refined"),
        "gamma_collocated_chain[heat]": ("heat-aniso-collocated",),
        "gamma_collocated_zt_chain": ("viscosity-fluidity-collocated",
                                      "viscosity-polarization"),
        "gamma_collocated_chain[hyper]": (
            "hyperelasticity-nl-cg-collocated",),
        "g0_staggered_chain[hyper]": ("hyperelasticity-nl-cg",
                                      "hyperelasticity-basic",
                                      "hyperelasticity-maximum")}
    # phase 15's sharded paths, in the slab rows of their kernels' modes
    k1k2_slab = ("elasticity [mixed BC] [sharded]",
                 "elasticity [batched] [sharded]",
                 "elasticity-reuss [sharded]")
    more_paths.update({
        "stress_div_beta[halo]": k1k2_slab,
        "stress_div_beta[halo,init]": k1k2_slab,
        "eps_from_u_dot[halo]": k1k2_slab,
        "eps_from_u_dot[halo,nodot]": k1k2_slab,
        "g0_staggered_chain_slab": ("viscosity [sharded]",
                                    "viscosity-generic [sharded]",
                                    "elasticity-general [sharded]",
                                    "elasticity-laminate [sharded]",
                                    "elasticity-full-staggered [sharded]")
        + k1k2_slab,
        "gamma_collocated_chain_slab": (
            "elasticity-collocated [mixed BC] [sharded]",)})
    main_nums = dict(main_nums, **slab_nums)
    log(f"total {time.perf_counter() - t_start:.1f} s, the build included")
    kernels = []
    for name, counter, path, src, replaces in rows:
        m = main_nums[name]
        counts = dict(path_launches[path], cg_update=update_launches.get(
            f"256^3 float32 {path}", 0))      # phase 4's solve of the path
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": counts[counter] + sum(
                path_launches[p][counter] for p in more_paths.get(name, ())),
            "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m.get("library_ms")})
    print(json.dumps({"kernels": kernels}))
    print(f"{card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
