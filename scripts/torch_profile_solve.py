#!/usr/bin/env python3
"""Where a CG solve of the PyTorch/CUDA port spends its time on one card.

    python3 scripts/torch_profile_solve.py [n] [mode] [scheme] [method]
        [--slabs=D | --batched] [--material=FIBRE]
    python3 scripts/torch_profile_solve.py [n] hyperelasticity [scheme] cg
        [exact|frozen_iso]
    python3 scripts/torch_profile_solve.py --fg=RUN
    python3 scripts/torch_profile_solve.py [n] --slab-path=PATH [--slabs=D]
    python3 scripts/torch_profile_solve.py [n] --g0=multigrid [--slabs=D]
        [--tol=T]
    python3 scripts/torch_profile_solve.py [n] --fallback=D
    python3 scripts/torch_profile_solve.py [n] --gui

Solves the bench's sphere RVE (n^3, default 256, float32, residual tol
1e-6, check_every 8; chip_smoke.RVE) in ``mode`` (elasticity, the default,
heat or viscosity) on the ``scheme`` grid (staggered, the default, or
collocated) with ``method`` (cg, the default, basic or polarization; the
latter two stop on the epsilon estimator); in hyperelasticity the
hyperelastic bench (the SVK sphere at 2 % stretch with
chip_smoke.HYPER_OPT, Newton-Krylov with the exact tangent or the frozen
one) twice without the profiler and
reports the second run's wall time and the two runs' peak device memory
(``torch.cuda.max_memory_allocated``), then once under torch.profiler and
reports the device time by kernel and by kind (``fgbench``'s
``kind_of``: the port's kernels, the chains' passes included, cuFFT,
cuSOLVER's batched eigensolver, PyTorch elementwise and reduction
kernels); no idle share (a sum of kernel times is not the device's busy
time: the benchmark's ``device_idle_share`` reads the union of device
operations in one traced window); in hyperelasticity also the wall time of one
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
are printed beside the device time by kind.  ``--slab-path=PATH`` solves
a path of ``chip_smoke.SLAB_PATHS`` (the linear paths of phase 15:
``viscosity``, ``viscosity-generic``, ``elasticity [mixed BC]``,
``elasticity [batched]``, ``elasticity-willot``, ...) as phase 15 builds
it, unsharded or with ``--slabs=D`` on D x-slabs of the card.
``--g0=multigrid`` applies the staggered G0 by the multigrid Poisson
solves (on the slabs with ``--slabs=D``); ``--tol=T`` stops the linear
solves at T instead of 1e-6 (the multigrid G0 is launch-bound: about a
second an iteration on four slabs).  ``--fallback=D`` solves on a
mesh of D slabs of the card under ``sharding_fallback="warn"`` (whole on
the card when n % D != 0).  ``--gui`` profiles
``gui.app.run_project_and_view(show=False)`` on ``chip_smoke.GUI_XML`` at
n^3 float32 (two loadsteps, the viewed field recorded): the whole run is
the wall time, as with ``--fg``.
Prints one JSON line last.
"""
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from fgbench.harness.trace import kind_of  # noqa: E402


def main():
    import torch
    from torch.profiler import ProfilerActivity, profile

    import numpy as np

    from chip_smoke import (EFF_VISC, GUI_XML, HYPER_OPT, INTERFACE_PATHS,
                            demo_fg, general_solver, interface_solver,
                            slab_path_solver, sphere_solver)
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
    slab_path = [a.split("=", 1)[1] for a in sys.argv
                 if a.startswith("--slab-path=")]
    slab_path = slab_path[0] if slab_path else None
    g0 = [a.split("=", 1)[1] for a in sys.argv if a.startswith("--g0=")]
    tol = [float(a.split("=", 1)[1]) for a in sys.argv
           if a.startswith("--tol=")]
    fallback = [int(a.split("=", 1)[1]) for a in sys.argv
                if a.startswith("--fallback=")]
    fallback = fallback[0] if fallback else None
    gui = "--gui" in sys.argv
    sys.argv = [a for a in sys.argv
                if not a.startswith(("--slabs=", "--material=", "--fg=",
                                     "--slab-path=", "--g0=", "--fallback=",
                                     "--tol="))
                and a not in ("--batched", "--gui")]
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
    if g0:
        opt["g0_solver"] = g0[0]
    if tol:
        opt["tol"] = tol[0]
    fg = []
    run = None
    if gui:
        import tempfile
        from fibergen_tpu_torch.gui.app import run_project_and_view
        gui_xml = str(Path(tempfile.mkdtemp()) / "project.xml")
        Path(gui_xml).write_text(GUI_XML.format(datatype="float", n=n,
                                                tol=1e-6))
        fg_run = "gui"

        def fresh_fg():
            return run_project_and_view(gui_xml, show=False,
                                        device="cuda")[0]
    else:
        def fresh_fg():
            f = demo_fg(fg_run)
            torch.cuda.synchronize()
            return f
    if fallback is not None:
        s = sphere_solver(n, "float32", None, mode, scheme, method,
                          mesh=["cuda:0"] * fallback,
                          sharding_fallback="warn", **opt)
    elif slab_path is not None:
        s, run = slab_path_solver(
            slab_path, n, "float32", "cuda",
            None if slabs is None else ["cuda:0"] * slabs, **opt)
        mode, scheme, method = s.mode, s.scheme, s.opt.method
        batched = slab_path.endswith("[batched]")
    elif fg_run is not None:
        s = fresh_fg().solver
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
        if run is not None:
            assert not run()
            return
        if fg_run is None:
            assert not (s.run_batched(Es) if batched else s.run())
            return
        # --fg: the run of a fresh FG; --gui: the whole headless GUI run
        t0 = time.perf_counter()
        f = fresh_fg()
        if not gui:
            t0 = time.perf_counter()
            assert f.run() == 0
        torch.cuda.synchronize()
        fg[:] = [f, time.perf_counter() - t0]
        s = f.solver

    torch.cuda.reset_peak_memory_stats()
    solve()
    solve()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
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
    device_ms = sum(r[0] for r in rows) / 1e3
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
          f"{'' if not g0 else f' G0 {g0[0]}'}"
          f"{'' if fallback is None else f' fallback mesh {fallback}'}"
          f"{'' if slab_path is None else f' path {slab_path}'}"
          f"{'' if material is None else f' {s.mat}, fibre {material}'}"
          f"{'' if slabs is None else f' on {slabs} slabs'}"
          f"{f' run_batched B={len(Es)}' if batched else ''}, {its} "
          f"iterations (Newton outer, inner: {s.newton_iterations}), "
          f"unprofiled wall "
          f"{1e3 * wall:.3f} ms, device time (kernels summed) "
          f"{device_ms:.3f} ms, peak {peak_gib:.2f} GiB")
    if ref_ms is not None:
        print(f"  one reference-material pass (tangent eigenvalue bounds): "
              f"{ref_ms:.3f} ms wall")
    for us, count, name in rows[:16]:
        print(f"  {us / 1e3:9.3f} ms {count:6d}x  {name[:90]}")
    for k, ms in sorted(kinds.items(), key=lambda kv: -kv[1]):
        print(f"  {k:18s} {ms:9.3f} ms  {ms / device_ms:6.1%} of the "
              f"device time")
    print(json.dumps({"n": n, "mode": mode, "scheme": scheme,
                      "method": method, "slabs": slabs,
                      "material": material, "fg": fg_run,
                      "slab_path": slab_path,
                      "g0": g0[0] if g0 else None, "fallback": fallback,
                      "tol": opt.get("tol"),
                      "shares_of_wall": shares,
                      "batched": len(Es) if batched else None,
                      "iterations": its,
                      "newton_iterations": s.newton_iterations,
                      "ref_material_ms": ref_ms,
                      "wall_ms": 1e3 * wall,
                      "device_ms": device_ms,
                      "peak_gib": peak_gib,
                      "by_kind_ms": kinds, "device": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
