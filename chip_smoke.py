#!/usr/bin/env python3
"""Smoke run of fibergen_tpu_torch (the PyTorch/CUDA port) on one card.

    python3 chip_smoke.py

Phases, each failing loudly:

1. the card's name and power limit; build the CUDA kernels from ``csrc/``;
2. every kernel of the main path against its plain PyTorch twin at the
   main path's shapes (256^3 float32) and on an odd float64 grid, with
   kernel, twin and cuFFT times from CUDA events;
3. the kernel path (cuda) against the plain path (cpu) on one solve;
4. the main path: the bench's 256^3 sphere RVE solved to 1e-6 in float32
   (timed second run, kernel launches counted), the same solve in float64,
   and one 512^3 float32 solve;
5. the x-laminate's analytic C11 on the card;
6. the launch counts and one JSON line per kernel with its numbers.

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


def sphere_solver(n, dtype, device, **opt):
    """The bench's RVE (bench.py make_problem): fibre mu=10 lam=5, matrix
    mu=1 lam=1, e_xx = 1."""
    import fibergen_tpu_torch as ft
    phi = sphere_phi(n, "float32" if dtype == "float32" else "float64")
    mat = ft.convert.material_from_numpy(
        [("fiber", 10.0, 5.0, phi), ("matrix", 1.0, 1.0, 1.0 - phi)],
        device=device)
    s = ft.LSSolver(ft.Grid(n, n, n), mat, ft.SolverOptions(
        mode="elasticity", method="cg", gamma_scheme="staggered",
        dtype=dtype, **opt), device=device)
    s.set_strain([1.0, 0, 0, 0, 0, 0])
    return s


# per-voxel values moved and flops of each kernel's work on the main path:
# K1 step reads r, p_prev, mu, lam and writes f, p; K1 init reads eps, mu,
# lam and writes f; K2 dot reads u, p and writes w; K2 no-dot reads u and
# writes w; K3 reads f and writes u (3 values each), and its flops are those
# of a 3-component rfftn + irfftn pair (2.5 N log2 N each per component)
# plus about 56 per half-spectrum bin for the G0 apply.
WORK = {
    "stress_div_beta": dict(values=14 + 9, flops=51),
    "stress_div_beta[init]": dict(values=8 + 3, flops=39),
    "eps_from_u_dot": dict(values=9 + 6, flops=51),
    "eps_from_u_dot[nodot]": dict(values=3 + 6, flops=30),
    "g0_staggered_chain": dict(values=3 + 3, flops=None),
}


def bound_ms(name, count, itemsize):
    w = WORK[name]
    peak = H100_F32_FLOPS if itemsize == 4 else H100_F64_FLOPS
    flops = w["flops"]
    if flops is None:
        flops = 3 * 2 * 2.5 * math.log2(count) + 56 / 2
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

    # K3: the whole chain against rfftn -> plain G0 apply -> irfftn
    k3 = lambda: spk.g0_staggered_chain(g, f, c10, c20)
    p3 = lambda: spk.g0_staggered_chain_plain(g, f, c10, c20)
    report("g0_staggered_chain", [rel_err(k3(), p3())], k3, p3, n)
    if timed:
        out["g0_staggered_chain"]["library_ms"] = cuda_ms(
            lambda: fft.ifftn(fft.fftn(f), g.shape))
        log(f"  cuFFT rfftn+irfftn (3, {shape}) {str(dtype)[6:]}: "
            f"{out['g0_staggered_chain']['library_ms']:.4f} ms")
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
        fail unless each kernel of the path launched in it."""
        for table in (sk.launches, spk.launches):
            for name in table:
                table[name] = 0
        fail = solver.run()
        torch.cuda.synchronize()
        got = dict(sk.launches, **spk.launches)
        log(f"  {label} launches: {json.dumps(got)}")
        assert all(v > 0 for v in got.values()), (label, got)
        return fail, got

    # ---- phase 2: kernels against their twins
    log("phase 2: kernels vs plain twins")
    main_nums = check_kernels((256, 256, 256), torch.float32, timed=True)
    check_kernels((33, 17, 29), torch.float64, timed=False)
    torch.cuda.empty_cache()

    # ---- phase 3: kernel path vs plain path on the same solve
    log("phase 3: 48^3 float64 solve, cuda kernels vs cpu twins")
    opt = dict(error_estimator="residual", tol=1e-8, check_every=4,
               maxiter=1000)
    s_cpu = sphere_solver(48, "float64", "cpu", **opt)
    s_gpu = sphere_solver(48, "float64", "cuda", **opt)
    assert not s_cpu.run()
    assert not run_counted(s_gpu, "48^3 float64")[0]
    rc, rg = np.asarray(s_cpu.residuals), np.asarray(s_gpu.residuals)
    res_rel = float(np.max(np.abs(rg - rc) / np.abs(rc))) \
        if len(rc) == len(rg) else float("inf")
    Sc, Sg = s_cpu.calc_mean_stress(), s_gpu.calc_mean_stress()
    s_rel = float(np.max(np.abs(Sg - Sc)) / np.max(np.abs(Sc)))
    log(f"  iterations cpu {len(rc)} cuda {len(rg)}, residual history max "
        f"rel diff {res_rel:.3e}, mean stress max rel diff {s_rel:.3e}")
    assert len(rc) == len(rg), "iteration counts differ"
    assert res_rel <= 1e-9 and s_rel <= 1e-10
    del s_cpu, s_gpu

    # ---- phase 4: the main path at full size
    log("phase 4: bench sphere RVE, residual tol 1e-6, check_every 8")
    opt = dict(error_estimator="residual", tol=1e-6, check_every=8,
               maxiter=4000)
    s32 = sphere_solver(256, "float32", "cuda", **opt)
    assert not s32.run()                     # warm-up
    fail, launches = run_counted(s32, "256^3 float32")
    its = len(s32.residuals)
    steps = launches["eps_from_u_dot"] - 1   # one no-dot launch at CG init
    final_rel = float(s32.residuals[-1])
    S32 = s32.calc_mean_stress()
    log(f"  256^3 float32: {its} iterations ({steps} CG steps run), "
        f"solve_time {s32.solve_time:.4f} s, {its / s32.solve_time:.2f} "
        f"iter/s, {steps / s32.solve_time:.2f} steps/s, final_rel "
        f"{final_rel:.3e}, mean stress {S32.tolist()}")
    assert not fail and its < opt["maxiter"] and final_rel <= 1e-6
    assert np.all(np.isfinite(S32))
    del s32
    torch.cuda.empty_cache()

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

    # ---- phase 5: analytic oracle
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

    # ---- phase 6: launches and per-kernel numbers.  The per-kernel list
    # takes the key "kernels"; the launch counts of the timed 256^3 float32
    # solve print on their own line as "kernel_launches".
    log(json.dumps({"kernel_launches": launches}))
    rows = [("stress_div_beta", "fibergen_tpu_torch/csrc/stress_div_beta.cu",
             "fibergen_tpu/ops/pallas_sweep.py:301"),
            ("eps_from_u_dot", "fibergen_tpu_torch/csrc/eps_from_u_dot.cu",
             "fibergen_tpu/ops/pallas_sweep.py:517"),
            ("g0_staggered_chain",
             "fibergen_tpu_torch/csrc/g0_staggered_chain.cu",
             "fibergen_tpu/ops/pallas_chain.py:212")]
    kernels = []
    for name, src, replaces in rows:
        m = main_nums[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
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
