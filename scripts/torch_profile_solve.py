#!/usr/bin/env python3
"""Where a CG solve of the PyTorch/CUDA port spends its time on one card.

    python3 scripts/torch_profile_solve.py [n] [mode] [scheme] [method]
        [--slabs=D | --batched] [--material=FIBRE]
    python3 scripts/torch_profile_solve.py [n] hyperelasticity [scheme] cg
        [exact|frozen_iso]
    python3 scripts/torch_profile_solve.py --fg=RUN

Solves the bench's sphere RVE (n^3, default 256, float32, residual tol
1e-6, check_every 8; chip_smoke.RVE) in ``mode`` (elasticity, the default,
heat or viscosity) on the ``scheme`` grid (staggered, the default, or
collocated) with ``method`` (cg, the default, basic or polarization; the
latter two stop on the epsilon estimator); in hyperelasticity the
hyperelastic bench (the SVK sphere at 2 % stretch with
chip_smoke.HYPER_OPT, Newton-Krylov with the exact tangent or the frozen
one) twice without the profiler and
reports the second run's wall time, then once under torch.profiler and
reports the device time by kernel, by kind (the port's kernels, the
chains' passes included, cuFFT, cuSOLVER's batched eigensolver, PyTorch
elementwise and reduction kernels) and the device's idle share of the
unprofiled wall time; in hyperelasticity also the wall time of one
reference-material pass (the tangent eigenvalue bounds at 256^3).
``--slabs=D`` solves sharded into D x-slabs of one card (the mesh
["cuda:0"] * D); the spectrum exchanges then show as ``torch.cat`` (a kind
of its own, with ``torch.stack``) and the halo planes as copy kernels.
``--batched`` runs the mode's effective-property load cases in one
``run_batched`` (np.eye(dim), viscosity the five traceless cases of
chip_smoke.EFF_VISC) instead of one solve.  ``--material=FIBRE`` solves
a general linear material of ``chip_smoke.general_solver`` instead of the
bench's (``tiso``, ``tiso-field``, ``general-iso`` or ``tiso-iso`` in
elasticity, ``aniso`` in heat); ``--material=PATH`` with a path of
``chip_smoke.INTERFACE_PATHS`` (``elasticity-full-staggered``,
``elasticity-laminate``, ``viscosity-fluidity``, ...) solves that path's
material, mode and scheme (the interface rules, the doubly-fine grid, the
generic staggered Delta path).  ``--fg=RUN`` profiles one run of
``chip_smoke.FRONT_END`` (``fg-hashin``, ``fg-transverse-isotropy``,
``fg-heat``, ``fg-nunan-keller``) through ``ft.FG`` in float32, a fresh FG
each time: the whole ``f.run()`` (fibre generation, ``init_phase``, the
solve) is the wall time, and ``init_phase``'s and the solve's shares of it
are printed beside the device time by kind.
Prints one JSON line last.
"""
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def kind_of(name):
    n = name.lower()
    for k in ("stress_div_beta", "eps_from_u", "sum_partials", "z_fwd", "z_inv",
              "y_line", "x_apply"):
        if k in n:
            return "port kernels"
    if "fft" in n:
        return "cuFFT"
    if "gemm" in n or "cutlass" in n:
        return "cuBLAS (einsum)"
    if any(k in n for k in ("sytrd", "stedc", "laed", "lansy", "lascl",
                            "steqr", "syev")):
        return "cuSOLVER eigvalsh"
    if "catarray" in n:
        return "torch.cat/stack"
    if "reduce" in n:
        return "torch reductions"
    if "elementwise" in n or "copy" in n or "fill" in n:
        return "torch elementwise"
    return "other"


def main():
    import torch
    from torch.profiler import ProfilerActivity, profile

    import numpy as np

    from chip_smoke import (EFF_VISC, HYPER_OPT, INTERFACE_PATHS, demo_fg,
                            general_solver, interface_solver, sphere_solver)
    from fibergen_tpu_torch.utils.logging import LOG

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    LOG.enabled = False
    slabs = [int(a.split("=", 1)[1]) for a in sys.argv
             if a.startswith("--slabs=")]
    slabs = slabs[0] if slabs else None
    batched = "--batched" in sys.argv
    material = [a.split("=", 1)[1] for a in sys.argv
                if a.startswith("--material=")]
    material = material[0] if material else None
    fg_run = [a.split("=", 1)[1] for a in sys.argv if a.startswith("--fg=")]
    fg_run = fg_run[0] if fg_run else None
    sys.argv = [a for a in sys.argv
                if not a.startswith(("--slabs=", "--material=", "--fg="))
                and a != "--batched"]
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    mode = sys.argv[2] if len(sys.argv) > 2 else "elasticity"
    scheme = sys.argv[3] if len(sys.argv) > 3 else "staggered"
    method = sys.argv[4] if len(sys.argv) > 4 else "cg"
    if mode == "hyperelasticity":
        tangent = sys.argv[5] if len(sys.argv) > 5 else "exact"
        opt = dict(HYPER_OPT, newton_tangent=tangent)
    else:
        est = "residual" if method == "cg" else "epsilon"
        opt = dict(error_estimator=est, tol=1e-6, check_every=8,
                   maxiter=4000)
    fg = []
    if fg_run is not None:
        s = demo_fg(fg_run).solver
        n, mode, scheme, method = s.grid.nx, s.mode, s.scheme, s.opt.method
    elif material in INTERFACE_PATHS:
        s = interface_solver(n, "float32", "cuda", material, method=method,
                             **opt)
        mode, scheme = s.mode, s.scheme
    elif material is not None:
        s = general_solver(n, "float32", "cuda", material, mode, scheme,
                           method=method, **opt)
    else:
        s = sphere_solver(n, "float32", "cuda", mode, scheme, method,
                          mesh=None if slabs is None else ["cuda:0"] * slabs,
                          **opt)
    Es = EFF_VISC if mode == "viscosity" else np.eye(s.dim)

    def solve():
        nonlocal s
        if fg_run is None:
            assert not (s.run_batched(Es) if batched else s.run())
            return
        f = demo_fg(fg_run)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        assert f.run() == 0
        torch.cuda.synchronize()
        fg[:] = [f, time.perf_counter() - t0]
        s = f.solver

    solve()
    solve()
    wall = s.solve_time if fg_run is None else fg[1]
    shares = None if fg_run is None else {
        "init_phase": fg[0].phase_time / wall,
        "solve": s.solve_time / wall}
    its = len(s.residuals)
    ref_ms = None
    if mode == "hyperelasticity":
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.calc_ref_material()
        torch.cuda.synchronize()
        ref_ms = 1e3 * (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        solve()
        torch.cuda.synchronize()

    # device-side kernel events only: operator events carry their kernels'
    # time too, and summing both would count it twice
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    kinds = {}
    for us, _, name in rows:
        kinds[kind_of(name)] = kinds.get(kind_of(name), 0.0) + us / 1e3
    card = torch.cuda.get_device_name(0)
    if fg_run is not None:
        print(f"{card}: {fg_run} through FG, grid {s.grid.shape}: "
              f"init_phase {fg[0].phase_time:.4f} s ({shares['init_phase']:.1%}"
              f" of the run's wall), solve_time {s.solve_time:.4f} s "
              f"({shares['solve']:.1%})")
    print(f"{card}: {n}^3 float32 {mode} {scheme} {method}"
          f"{'' if material is None else f' {s.mat}, fibre {material}'}"
          f"{'' if slabs is None else f' on {slabs} slabs'}"
          f"{f' run_batched B={len(Es)}' if batched else ''}, {its} "
          f"iterations (Newton outer, inner: {s.newton_iterations}), "
          f"unprofiled wall "
          f"{1e3 * wall:.3f} ms, device busy {busy_ms:.3f} ms, idle share "
          f"{1 - busy_ms / (1e3 * wall):.3f}")
    if ref_ms is not None:
        print(f"  one reference-material pass (tangent eigenvalue bounds): "
              f"{ref_ms:.3f} ms wall")
    for us, count, name in rows[:16]:
        print(f"  {us / 1e3:9.3f} ms {count:6d}x  {name[:90]}")
    for k, ms in sorted(kinds.items(), key=lambda kv: -kv[1]):
        print(f"  {k:18s} {ms:9.3f} ms  {ms / busy_ms:6.1%} of busy")
    print(json.dumps({"n": n, "mode": mode, "scheme": scheme,
                      "method": method, "slabs": slabs,
                      "material": material, "fg": fg_run,
                      "shares_of_wall": shares,
                      "batched": len(Es) if batched else None,
                      "iterations": its,
                      "newton_iterations": s.newton_iterations,
                      "ref_material_ms": ref_ms,
                      "wall_ms": 1e3 * wall,
                      "device_busy_ms": busy_ms,
                      "idle_share": 1 - busy_ms / (1e3 * wall),
                      "by_kind_ms": kinds, "device": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
