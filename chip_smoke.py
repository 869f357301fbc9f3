#!/usr/bin/env python3
"""Smoke run of fibergen_tpu_torch (the PyTorch/CUDA port) on one card.

    python3 chip_smoke.py

Nine paths run on the card (PATHS), six more of general linear
materials (GENERAL_PATHS, phase 9), eight of the interface rules, the
doubly-fine grid and the generic staggered Delta path (INTERFACE_PATHS,
phase 10) and four demo projects through the XML front end (FRONT_END,
phase 11).  Staggered CG: elasticity (K1, K3,
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
   cuFFT times from CUDA events;
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
   (``make_mesh(["cuda:0"] * 4)``): each slab kernel (K1, K2 in halo mode;
   the kz-slab K3, K4, K5 and K6 chains, and the finite-strain K5 at C = 9
   and K3 with the full-gradient constants, these two also against their
   whole-field chains) against its twin at 256^3 float32 with times and
   the time of the two spectrum exchanges, K1/K2 halo mode bitwise against
   the periodic kernels on one slab; a 48^3 float64 sharded solve of each
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
   traceless cases), each ``run_batched`` against its sequential
   ``run()`` solves; uniaxial stress under a mixed-BC projector on both
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
   the CPU (phi and the geometry fields, iterations, the result).

The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device
the script exits non-zero before printing any result.
"""
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
    "heat-laminate": ("g0_staggered_heat_chain",),
    "viscosity-generic": ("g0_staggered_chain",),
    "viscosity-lambda": ("g0_staggered_chain",),
    "viscosity-fluidity": ("g0_staggered_chain",),
    "viscosity-fluidity-collocated": ("gamma_collocated_zt_chain",),
    "viscosity-nunan-keller": ("g0_staggered_chain",),
    "viscosity-mixed-bc": ("g0_staggered_chain",),
    # phase 11: the XML front end (FRONT_END)
    "fg-hashin": ("stress_div_beta", "eps_from_u_dot", "g0_staggered_chain"),
    "fg-transverse-isotropy": ("g0_staggered_chain",),
    "fg-heat": ("g0_staggered_heat_chain",),
    "fg-nunan-keller": ("g0_staggered_chain",),
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


def general_solver(n, dtype, device, fibre, mode="elasticity",
                   scheme="staggered", rule="voigt", blur=None, **opt):
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
    (a logistic profile), for the rules that treat them apart."""
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
    mat = ft.convert.material_from_numpy(
        [("fiber", f, phi), ("matrix", matrix, 1.0 - phi)], dim=dim,
        device=device, rule=rule)
    s = ft.LSSolver(ft.Grid(n, n, n), mat, ft.SolverOptions(
        mode=mode, gamma_scheme=scheme, dtype=dtype, **opt), device=device)
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
                     **opt):
    """The material of ``path`` (INTERFACE_PATHS; its rule replaced by
    ``rule``) on the bench's sphere at n^3 in ``dtype``, loaded as the
    bench loads its mode.  ``geometry`` (phi, normals) replaces the
    path's phi (both solvers of a comparison then read the same arrays;
    on the doubly-fine grid phi is 2n^3)."""
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
    mat = ft.convert.material_from_numpy(
        [("fiber", fibre, phi), ("matrix", matrix, 1.0 - phi)],
        dim=c["dim"], device=device, rule=rule,
        normals=normals if takes_normals else None)
    if kind == "fine":
        mat = ft.DfgMaterial(mat)
    s = ft.LSSolver(ft.Grid(n, n, n), mat, ft.SolverOptions(
        mode=mode, gamma_scheme=scheme, dtype=dtype, **opt), device=device)
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
}
# a slab kernel does the same work as its whole-field kernel (the halo
# planes and the exchanged spectrum are the decomposition's own traffic)
WORK.update({
    "stress_div_beta[halo]": WORK["stress_div_beta"],
    "stress_div_beta[halo,init]": WORK["stress_div_beta[init]"],
    "eps_from_u_dot[halo]": WORK["eps_from_u_dot"],
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

    if d == 1:
        # one slab wraps its own halo: bitwise the periodic kernels
        f0, p0 = sk.stress_div_beta(g, r, pp, (gam, gam_prev), mu, lam, mu0,
                                    lam0)
        fi0, _ = sk.stress_div_beta(g, r, None, None, mu, lam, mu0, lam0)
        w0, dot0 = sk.eps_from_u_dot(g, E, u, pp)
        wn0, _ = sk.eps_from_u_dot(g, E, u)
        same = all(torch.equal(a, b) for a, b in (
            (f[0], f0), (p[0], p0), (fi[0], fi0), (w[0], w0), (wn[0], wn0),
            (dot[0], dot0)))
        log(f"  K1/K2 halo mode on one slab bitwise equal to the periodic "
            f"kernels: {same}")
        assert same, "K1/K2 halo mode differs from the periodic kernels"

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
    fn)`` runs ``fn`` (the solver's run by default) with every launch count
    set to 0 and checks the path's kernels; ``res32`` holds phase 4's
    pure-strain iterations per path.  Each batched path runs batched,
    sequential, sequential, batched (the two pairs in turns)."""
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
                             lambda: t_b.append(batched()))
        peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else 0.0
        path_launches[f"{path} [batched]"] = got
        its_b, Sb = len(s.residuals), s.calc_mean_stress_batched()
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
                            lambda: s.run_batched(np.eye(6)))
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
        "viscosity-nunan-keller", lambda: s.run_batched(Es))
    wall = time.perf_counter() - t0
    assert not fail
    res = ft.api.effective_viscosity(s.calc_mean_stress_batched(), 0.5)
    its_b, S_seq, its_seq = len(s.residuals), np.zeros((5, 6)), []
    for i, E in enumerate(Es):
        s.set_strain(E)
        assert not s.run()
        S_seq[i] = s.calc_mean_stress()
        its_seq.append(len(s.residuals))
    seq = ft.api.effective_viscosity(S_seq, 0.5)
    ea = abs(res.alpha - NUNAN_KELLER["alpha"]) / NUNAN_KELLER["alpha"]
    eb = abs(res.beta - NUNAN_KELLER["beta"]) / NUNAN_KELLER["beta"]
    log(f"  Nunan-Keller, n = {nk} ({2 * nk}^3 fine phases, V = "
        f"{float(phi.mean()):.5f}): batched {its_b} iterations, wall "
        f"{wall:.4f} s; alpha {res.alpha:.6f} (paper "
        f"{NUNAN_KELLER['alpha']}, rel {ea:.2e}), beta {res.beta:.6f} "
        f"(paper {NUNAN_KELLER['beta']}, rel {eb:.2e}); sequential "
        f"iterations per case {its_seq}, alpha {seq.alpha:.6f} beta "
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
            assert np.all(np.diag(K) > 1.0) and np.all(np.diag(K) < 10.0)
            heat32 = (K, len(s.residuals))   # held to the CPU below
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


def sync_all():
    import torch
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    import numpy as np
    import fibergen_tpu_torch as ft
    from fibergen_tpu_torch.ops import _build
    from fibergen_tpu_torch.ops import spectral_kernels as spk
    from fibergen_tpu_torch.ops import stencil_kernels as sk
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

    def run_counted(solver, label, path, fn=None):
        """Run one solve (``fn``, the solver's run by default) with every
        launch count set to 0 just before it; fail unless each kernel of
        ``path`` launched in it and no other."""
        for table in (sk.launches, spk.launches):
            for name in table:
                table[name] = 0
        fail = (fn or solver.run)()
        sync_all()
        got = dict(sk.launches, **spk.launches)
        log(f"  {label} launches: {json.dumps(got)}")
        want = PATH_KERNELS[path] if solver.par is None else \
            SHARDED_KERNELS[path]
        assert all((got[k] > 0) == (k in want) for k in got), (label, got)
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
    torch.cuda.empty_cache()

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

    # ---- phase 7: launches and per-kernel numbers.  The per-kernel list
    # takes the key "kernels"; the launch counts of each path's timed 256^3
    # float32 solve print on their own line as "kernel_launches".  A mode's
    # row takes its launches from the path that runs that mode, plus those
    # of the phase-9 paths that run it (more_paths).
    log(json.dumps({"kernel_launches": path_launches}))
    k1, k2, ch = ("fibergen_tpu_torch/csrc/stress_div_beta.cu",
                  "fibergen_tpu_torch/csrc/eps_from_u_dot.cu",
                  "fibergen_tpu_torch/csrc/g0_staggered_chain.cu")
    rows = [("stress_div_beta", "stress_div_beta", "elasticity", k1,
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
             "hyperelasticity", ch, "fibergen_tpu/ops/pallas_chain.py:212")]
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
    rows += [("gamma_collocated_chain_slab[hyper]",
              "gamma_collocated_chain_slab",
              "hyperelasticity-collocated [sharded]", ch, f"{pc_}:470"),
             ("g0_staggered_chain_slab[hyper]", "g0_staggered_chain_slab",
              "hyperelasticity [sharded]", ch, f"{pc_}:470")]
    more_paths = {
        "stress_div_beta": ("elasticity-reuss", "fg-hashin"),
        "eps_from_u_dot": ("elasticity-reuss", "fg-hashin"),
        "g0_staggered_chain": ("elasticity-general", "elasticity-tiso-field",
                               "elasticity-reuss",
                               "elasticity-full-staggered",
                               "elasticity-laminate", "viscosity-generic",
                               "viscosity-lambda", "viscosity-fluidity",
                               "viscosity-nunan-keller", "fg-hashin",
                               "fg-transverse-isotropy", "fg-nunan-keller"),
        "g0_staggered_heat_chain": ("heat-aniso", "heat-laminate",
                                    "fg-heat"),
        "gamma_collocated_chain": ("elasticity-general-collocated",
                                   "elasticity-laminate-collocated"),
        "gamma_collocated_chain[heat]": ("heat-aniso-collocated",),
        "gamma_collocated_zt_chain": ("viscosity-fluidity-collocated",)}
    main_nums = dict(main_nums, **slab_nums)
    log(f"total {time.perf_counter() - t_start:.1f} s, the build included")
    kernels = []
    for name, counter, path, src, replaces in rows:
        m = main_nums[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": path_launches[path][counter] + sum(
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
