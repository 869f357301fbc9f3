#!/usr/bin/env python3
"""Device time of a spectral chain of the PyTorch/CUDA port, pass by pass.

    python3 scripts/torch_time_chain.py [n] [float32|float64]
        [--chain g0|heat|collocated6|collocated3|zt|hyper|all|<a,b,...>]
        [--slabs=D]

Times a chain on a random (C, n, n, n) field (default 256, float32; chain
``g0``, the K3 G0 chain) and cuFFT's rfftn + irfftn pair on the same field,
and checks the chain against its plain twin.  The chains: ``g0`` K3 (C =
3), ``heat`` K4 (C = 1), ``collocated6`` and ``collocated3`` K5 (C = 6,
3), ``zt`` K6 (C = 5 transformed, a traceless 6-component field) and
``hyper`` K5 at C = 9.  ``chain_ms`` and ``cufft_pair_ms`` are the mean of
20 calls after 5 warm-up calls, from CUDA events.  Then 20 more calls
(after 5 warm-ups) run under ``torch.profiler`` and each pass reports its
mean device time by kernel: ``z_fwd``, ``y_line`` forward, ``x_apply``,
``y_line`` inverse, ``z_inv`` and, for K6, the trailing ``torch.add`` and
``neg_`` that form component 0; each beside its byte bound (each value the
pass reads and writes once, at 3.35 TB/s).  Prints a table per chain and
one JSON line per chain, the card's name and power limit in each.
``--slabs=D`` also times the chain on D x-slabs of the card (the kz-slab
chain with its two spectrum exchanges, ``slab_chain_ms``, CUDA events as
above) and checks it against the whole-field chain.

Imports the package beside this script, so a checkout elsewhere (a
``git archive`` of another commit with this script copied into its
``scripts/``) times its own kernels: run both in one call on one card to
compare them.  Exits non-zero without a card or if a chain misses its
twin's tolerance (1e-5 float32, 1e-12 float64).
"""
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
CHAINS = {"g0": 3, "heat": 1, "collocated6": 6, "collocated3": 3, "zt": 5,
          "hyper": 9}


def card():
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def pass_bytes(ncomp, shape, itemsize):
    """Bytes each pass must move: the real field is read or written once,
    the half spectrum read and written once by each pass that holds it."""
    nx, ny, nz = shape
    real = ncomp * nx * ny * nz * itemsize
    spec = ncomp * nx * ny * (nz // 2 + 1) * 2 * itemsize
    out = {"z_fwd": real + spec, "y_line fwd": 2 * spec, "x_apply": 2 * spec,
           "y_line inv": 2 * spec, "z_inv": spec + real}
    return out


def label_kernels(names):
    """Pass labels for the kernel names of one or more chain calls in
    launch order; the two y_line launches of a call are told apart by
    order."""
    out, seen_y = [], 0
    for name in names:
        if "z_fwd" in name:
            lab, seen_y = "z_fwd", 0
        elif "y_line" in name:
            lab = "y_line fwd" if seen_y % 2 == 0 else "y_line inv"
            seen_y += 1
        elif "x_apply" in name:
            lab = "x_apply"
        elif "z_inv" in name:
            lab = "z_inv"
        elif "catarray" in name.lower() or "copy" in name.lower():
            lab = "exchange"
        elif "neg" in name.lower():
            lab = "torch neg_"
        elif "add" in name.lower() or "elementwise" in name.lower():
            lab = "torch add"
        else:
            lab = "other"
        out.append(lab)
    return out


def profile_passes(fn, reps=20, warm=5):
    """Mean device time per pass label of ``fn`` over ``reps`` profiled
    calls after ``warm`` calls, and the kernel events."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    kern.sort(key=lambda e: e.time_range.start)
    if not kern:   # the profiler saw no device time: no pass table
        print("torch.profiler recorded no device kernels", file=sys.stderr)
    passes = {}
    for lab, e in zip(label_kernels([e.name for e in kern]), kern):
        passes[lab] = passes.get(lab, 0.0) + e.time_range.elapsed_us() / 1e3
    return {k: v / reps for k, v in passes.items()}, kern


def time_chain(chain, n, dtype, slabs=None):
    import torch

    import fibergen_tpu_torch as ft
    from fibergen_tpu_torch.ops import fft, green
    from fibergen_tpu_torch.ops import spectral_kernels as spk

    g = ft.Grid(n, n, n)
    gen = torch.Generator(device="cuda").manual_seed(7)
    ncomp = CHAINS[chain]
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda",
                                 dtype=dtype)
    mu0 = 2.75
    if chain == "g0":
        f = rnd(3, n, n, n)
        c10, c20 = green.g0_constants(mu0, 0.0)
        run = lambda: spk.g0_staggered_chain(g, f, c10, c20)
        plain = lambda: spk.g0_staggered_chain_plain(g, f, c10, c20)
    elif chain == "heat":
        f = rnd(1, n, n, n)
        run = lambda: spk.g0_staggered_heat_chain(g, f, 0.5 / mu0)
        plain = lambda: spk.g0_staggered_heat_chain_plain(g, f, 0.5 / mu0)
    elif chain in ("collocated6", "collocated3"):
        f, E = rnd(ncomp, n, n, n), rnd(ncomp)
        A, B = green.collocated_constants(mu0, 0.4)
        run = lambda: spk.gamma_collocated_chain(g, f, A, B, E, 0.37)
        plain = lambda: spk.gamma_collocated_chain_plain(g, f, A, B, E, 0.37)
    elif chain == "zt":
        f, E = rnd(6, n, n, n), rnd(6)
        f[0] = -(f[1] + f[2])
        A, B = green.collocated_constants(-mu0, float("inf"))
        run = lambda: spk.gamma_collocated_zt_chain(g, f, A, B, E, -0.2)
        plain = lambda: spk.gamma_collocated_zt_chain_plain(g, f, A, B, E,
                                                            -0.2)
    else:
        f, E = rnd(9, n, n, n), rnd(9)
        A, B = green.hyper_constants(mu0, 0.4)
        run = lambda: spk.gamma_collocated_hyper_chain(g, f, A, B, E, 0.37)
        plain = lambda: spk.gamma_collocated_hyper_chain_plain(g, f, A, B, E,
                                                               0.37)
    x = f[1:] if chain == "zt" else f   # the transformed components
    slab_run = None
    if slabs:
        from fibergen_tpu_torch import parallel
        mesh = parallel.make_mesh(["cuda:0"] * slabs)
        par = parallel.SlabPar(mesh)
        fs = parallel.shard_field(f, mesh)
        if chain == "g0":
            slab_run = lambda: spk.g0_staggered_chain_slab(par, g, fs, c10,
                                                           c20)
        elif chain == "heat":
            slab_run = lambda: spk.g0_staggered_heat_chain_slab(
                par, g, fs, 0.5 / mu0)
        else:
            fn = {"zt": spk.gamma_collocated_zt_chain_slab,
                  "hyper": spk.gamma_collocated_hyper_chain_slab}.get(
                chain, spk.gamma_collocated_chain_slab)
            slab_run = lambda: fn(par, g, fs, A, B, [E] * slabs,
                                  -0.2 if chain == "zt" else 0.37)

    def ms(fn, reps=20, warm=5):
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

    got, ref = run(), plain()
    err = float((got - ref).abs().max() / ref.abs().max())
    del ref
    slab = {}
    if slab_run is not None:
        from fibergen_tpu_torch import parallel
        sl = parallel.gather_field(slab_run())
        slab = {"slabs": slabs, "slab_max_rel_err": float(
            (sl - got).abs().max() / got.abs().max())}
        del sl
    del got
    chain_ms = ms(run)
    cufft_ms = ms(lambda: fft.ifftn(fft.fftn(x), g.shape))
    if slab_run is not None:
        slab["slab_chain_ms"] = ms(slab_run)

    passes, kern = profile_passes(run)
    if slab_run is not None:
        slab["slab_passes_ms"] = profile_passes(slab_run)[0]
    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = pass_bytes(ncomp, g.shape, itemsize)
    if chain == "zt":   # out[0] = -(out[1] + out[2]): add, then neg_
        nbytes["torch add"] = 3 * n ** 3 * itemsize
        nbytes["torch neg_"] = 2 * n ** 3 * itemsize
    bound = {k: 1e3 * v / H100_BYTES_PER_S for k, v in nbytes.items()}
    return {"chain": chain, "n": n, "dtype": str(dtype)[6:],
            "components": ncomp, "chain_ms": chain_ms,
            "cufft_pair_ms": cufft_ms, "max_rel_err": err,
            "passes_ms": passes, "pass_bound_ms": bound,
            "passes_sum_ms": sum(passes.values()),
            "bound_sum_ms": sum(bound.values()),
            "kernel_names": sorted({e.name[:80] for e in kern}), **slab}


def main(argv):
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    chains, slabs = ["g0"], None
    args = []
    it = iter(argv)
    for a in it:
        if a.startswith("--chain"):
            val = a.split("=", 1)[1] if "=" in a else next(it)
            chains = list(CHAINS) if val == "all" else val.split(",")
        elif a.startswith("--slabs="):
            slabs = int(a.split("=", 1)[1])
        else:
            args.append(a)
    bad = [c for c in chains if c not in CHAINS]
    if bad:
        print(f"unknown chain {bad}; one of {sorted(CHAINS)} or all",
              file=sys.stderr)
        return 2
    n = int(args[0]) if args else 256
    dtype = getattr(torch, args[1]) if len(args) > 1 else torch.float32
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    dev = card()
    from fibergen_tpu_torch.ops import spectral_kernels as spk
    ok = True
    for chain in chains:
        rec = time_chain(chain, n, dtype, slabs)
        rec.update(device=torch.cuda.get_device_name(0), card=dev,
                   source=str(Path(spk.__file__).parent))
        print(f"{chain} (C = {rec['components']}) {n}^3 {rec['dtype']} on "
              f"{dev}: chain {rec['chain_ms']:.4f} ms, cuFFT pair "
              f"{rec['cufft_pair_ms']:.4f} ms, max rel err "
              f"{rec['max_rel_err']:.3e}")
        for k, v in rec["passes_ms"].items():
            b = rec["pass_bound_ms"].get(k)
            print(f"  {k:12s} {v:9.4f} ms" + (
                "" if b is None else f"  bound {b:.4f} ms ({b / v:.1%})"))
        print(f"  {'sum':12s} {rec['passes_sum_ms']:9.4f} ms  bound "
              f"{rec['bound_sum_ms']:.4f} ms")
        if slabs:
            print(f"  on {slabs} x-slabs: {rec['slab_chain_ms']:.4f} ms, "
                  f"max rel err against the whole-field chain "
                  f"{rec['slab_max_rel_err']:.3e}; by pass (all slabs): "
                  + ", ".join(f"{k} {v:.4f}" for k, v in
                              rec["slab_passes_ms"].items()))
        print(json.dumps(rec), flush=True)
        ok = ok and rec["max_rel_err"] <= tol and \
            rec.get("slab_max_rel_err", 0.0) <= tol
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
