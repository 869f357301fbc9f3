#!/usr/bin/env python3
"""Smoke run of fibergen_tpu_torch (the PyTorch/CUDA port) on one card.

    python3 chip_smoke.py

Three paths run on the card: elasticity (K1, K3, K2), heat conduction
(the scalar K4 chain; porous flow is the same path) and viscosity (K1
tau-sum mode, K3 with the dual constants, K2 Delta mode).  Phases, each
failing loudly:

1. the card's name and power limit; build the CUDA kernels from ``csrc/``;
2. every kernel in every mode against its plain PyTorch twin at the paths'
   shapes (256^3 float32) and on an odd float64 grid, with kernel, twin
   and cuFFT times from CUDA events;
3. the kernel path (cuda) against the plain path (cpu) on one 48^3
   float64 solve of each path;
4. the paths at full size: the bench's 256^3 sphere RVE solved to 1e-6 in
   float32 in each mode (timed second run, kernel launches counted around
   each), the elasticity solve also in float64 and at 512^3;
5. the x-laminates' analytic C11 and conductivity on the card;
6. the launch counts and one JSON line per kernel and mode with its
   numbers.

The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device
the script exits non-zero before printing any result.
"""
import json
import math
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
PATHS = {
    "elasticity": dict(dim=6, law="isotropic", fiber=(10.0, 5.0),
                       matrix=(1.0, 1.0), load=[1.0, 0, 0, 0, 0, 0]),
    "heat": dict(dim=3, law="scalar", fiber=(10.0,), matrix=(1.0,),
                 load=[1.0, 0, 0]),
    "viscosity": dict(dim=6, law="scalar", fiber=(0.1,), matrix=(1.0,),
                      load=[0, 0, 0, 0, 1.0, 0]),
}
# the kernels each path must launch
PATH_KERNELS = {
    "elasticity": ("stress_div_beta", "eps_from_u_dot", "g0_staggered_chain"),
    "heat": ("g0_staggered_heat_chain",),
    "viscosity": ("stress_div_beta", "eps_from_u_dot", "g0_staggered_chain"),
}


def sphere_solver(n, dtype, device, mode="elasticity", **opt):
    """The bench's RVE in ``mode`` (PATHS) on an n^3 grid."""
    import fibergen_tpu_torch as ft
    c = PATHS[mode]
    phi = sphere_phi(n, "float32" if dtype == "float32" else "float64")
    mat = ft.convert.material_from_numpy(
        [("fiber", *c["fiber"], phi), ("matrix", *c["matrix"], 1.0 - phi)],
        dim=c["dim"], device=device, law=c["law"])
    s = ft.LSSolver(ft.Grid(n, n, n), mat, ft.SolverOptions(
        mode=mode, method="cg", gamma_scheme="staggered", dtype=dtype,
        **opt), device=device)
    s.set_strain(c["load"])
    return s


# per-voxel values moved and flops of each kernel's work on the paths:
# K1 step reads r, p_prev, mu, lam and writes f, p; K1 init reads eps, mu,
# lam and writes f; the tau sum adds six per-block partials (no per-voxel
# values); K2 dot reads u, p and writes w; K2 no-dot reads u and writes w;
# K2 Delta also reads mu; the chains read f and write u (C values each, C
# = 3 for K3, 1 for K4), and their flops are those of a C-component rfftn +
# irfftn pair (2.5 N log2 N each per component) plus those of the G0 apply
# per half-spectrum bin (about 56 for K3, 6 for K4).
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
}


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
    dot_rel = abs(float(d) - float(dr)) / abs(float(dr))
    report("eps_from_u_dot", [rel_err(w, wr), (dot_rel, dot_rel)], k2, p2, n)
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
    dot_rel = abs(float(d) - float(dr)) / abs(float(dr))
    report("eps_from_u_dot[delta]", [rel_err(w, wr), (dot_rel, dot_rel)], k2d,
           p2d, n)

    # K3: the whole chain against rfftn -> plain G0 apply -> irfftn
    k3 = lambda: spk.g0_staggered_chain(g, f, c10, c20)
    p3 = lambda: spk.g0_staggered_chain_plain(g, f, c10, c20)
    report("g0_staggered_chain", [rel_err(k3(), p3())], k3, p3, n)
    # K4: the scalar chain (heat) on one component
    f1 = f[:1].contiguous()
    h10 = 1.0 / (2.0 * mu0)
    k4 = lambda: spk.g0_staggered_heat_chain(g, f1, h10)
    p4 = lambda: spk.g0_staggered_heat_chain_plain(g, f1, h10)
    report("g0_staggered_heat_chain", [rel_err(k4(), p4())], k4, p4, n)
    if timed:
        for name, x in (("g0_staggered_chain", f),
                        ("g0_staggered_heat_chain", f1)):
            out[name]["library_ms"] = cuda_ms(
                lambda: fft.ifftn(fft.fftn(x), g.shape))
            log(f"  cuFFT rfftn+irfftn ({x.shape[0]}, {shape}) "
                f"{str(dtype)[6:]}: {out[name]['library_ms']:.4f} ms")
    return out


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
        for line in text.splitlines():
            if "Used" in line or "spill" in line:
                log(f"  {src}: {line.strip()}")

    def run_counted(solver, label):
        """Run one solve with every launch count set to 0 just before it;
        fail unless each kernel of the solver's path launched in it."""
        for table in (sk.launches, spk.launches):
            for name in table:
                table[name] = 0
        fail = solver.run()
        torch.cuda.synchronize()
        got = dict(sk.launches, **spk.launches)
        log(f"  {label} launches: {json.dumps(got)}")
        assert all(got[k] > 0 for k in PATH_KERNELS[solver.mode]), \
            (label, got)
        return fail, got

    # ---- phase 2: kernels against their twins
    log("phase 2: kernels vs plain twins")
    main_nums = check_kernels((256, 256, 256), torch.float32, timed=True)
    check_kernels((33, 17, 29), torch.float64, timed=False)
    torch.cuda.empty_cache()

    # ---- phase 3: kernel path vs plain path on the same solve
    log("phase 3: 48^3 float64 solves, cuda kernels vs cpu twins")
    opt = dict(error_estimator="residual", tol=1e-8, check_every=4,
               maxiter=1000)
    for mode in PATHS:
        s_cpu = sphere_solver(48, "float64", "cpu", mode, **opt)
        s_gpu = sphere_solver(48, "float64", "cuda", mode, **opt)
        assert not s_cpu.run()
        assert not run_counted(s_gpu, f"48^3 float64 {mode}")[0]
        rc, rg = np.asarray(s_cpu.residuals), np.asarray(s_gpu.residuals)
        res_rel = float(np.max(np.abs(rg - rc) / np.abs(rc))) \
            if len(rc) == len(rg) else float("inf")
        Sc, Sg = s_cpu.calc_mean_stress(), s_gpu.calc_mean_stress()
        s_rel = float(np.max(np.abs(Sg - Sc)) / np.max(np.abs(Sc)))
        log(f"  {mode}: iterations cpu {len(rc)} cuda {len(rg)}, residual "
            f"history max rel diff {res_rel:.3e}, mean stress max rel diff "
            f"{s_rel:.3e}")
        assert len(rc) == len(rg), f"{mode}: iteration counts differ"
        assert res_rel <= 1e-9 and s_rel <= 1e-10, mode
        del s_cpu, s_gpu

    # ---- phase 4: the paths at full size
    log("phase 4: bench sphere RVE, residual tol 1e-6, check_every 8")
    opt = dict(error_estimator="residual", tol=1e-6, check_every=8,
               maxiter=4000)
    path_launches, res32 = {}, {}
    for mode in PATHS:
        s32 = sphere_solver(256, "float32", "cuda", mode, **opt)
        assert not s32.run()                     # warm-up
        fail, got = run_counted(s32, f"256^3 float32 {mode}")
        path_launches[mode] = got
        its = len(s32.residuals)
        # one launch of the path's chain per CG step, one at CG init
        steps = got[PATH_KERNELS[mode][-1]] - 1
        final_rel = float(s32.residuals[-1])
        S32 = s32.calc_mean_stress()
        log(f"  256^3 float32 {mode}: {its} iterations ({steps} CG steps "
            f"run), solve_time {s32.solve_time:.4f} s, "
            f"{its / s32.solve_time:.2f} iter/s, "
            f"{steps / s32.solve_time:.2f} steps/s, final_rel "
            f"{final_rel:.3e}, mean stress {S32.tolist()}")
        assert not fail and its < opt["maxiter"] and final_rel <= 1e-6
        assert np.all(np.isfinite(S32))
        res32[mode] = (its, S32)
        del s32
        torch.cuda.empty_cache()
    its, S32 = res32["elasticity"]

    s64 = sphere_solver(256, "float64", "cuda", **opt)
    assert not run_counted(s64, "256^3 float64")[0]
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
    assert not run_counted(s512, "512^3 float32")[0]
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

    # ---- phase 5: analytic oracles
    shape = (64, 16, 16)
    x = (np.arange(shape[0]) + 0.5) / shape[0]
    phi = np.broadcast_to((x < 0.5)[:, None, None], shape).astype(np.float64)
    (mu1, lam1), (mu2, lam2) = (1.0, 2.0), (10.0, 5.0)
    mat = ft.convert.material_from_numpy(
        [("a", mu1, lam1, phi), ("b", mu2, lam2, 1.0 - phi)])
    s = ft.LSSolver(ft.Grid(*shape), mat, ft.SolverOptions(
        tol=1e-10, error_estimator="residual", check_every=4, maxiter=500))
    s.set_strain([1.0, 0, 0, 0, 0, 0])
    assert not run_counted(s, "laminate")[0]
    c11 = float(s.calc_mean_stress()[0])
    exact = 1.0 / (0.5 / (lam1 + 2 * mu1) + 0.5 / (lam2 + 2 * mu2))
    log(f"phase 5: laminate C11 {c11:.12f} vs exact {exact:.12f} "
        f"(rel {abs(c11 - exact) / exact:.3e}, {len(s.residuals)} its)")
    assert abs(c11 - exact) <= 1e-8 * exact
    # series conduction: the harmonic mean of the conductivities
    k1, k2 = 1.0, 10.0
    mat = ft.convert.material_from_numpy(
        [("a", k1, phi), ("b", k2, 1.0 - phi)], dim=3, law="scalar")
    s = ft.LSSolver(ft.Grid(*shape), mat, ft.SolverOptions(
        mode="heat", tol=1e-10, error_estimator="residual", check_every=4,
        maxiter=500))
    s.set_strain([1.0, 0, 0])
    assert not run_counted(s, "heat laminate")[0]
    k = float(s.calc_mean_stress()[0])
    exact = 2 * k1 * k2 / (k1 + k2)
    log(f"phase 5: heat laminate conductivity {k:.12f} vs exact "
        f"{exact:.12f} (rel {abs(k - exact) / exact:.3e}, "
        f"{len(s.residuals)} its)")
    assert abs(k - exact) <= 1e-8 * exact

    # ---- phase 6: launches and per-kernel numbers.  The per-kernel list
    # takes the key "kernels"; the launch counts of each path's timed 256^3
    # float32 solve print on their own line as "kernel_launches".  A mode's
    # row takes its launches from the path that runs that mode.
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
             ch, "fibergen_tpu/ops/pallas_chain.py:212")]
    kernels = []
    for name, counter, path, src, replaces in rows:
        m = main_nums[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": path_launches[path][counter],
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
