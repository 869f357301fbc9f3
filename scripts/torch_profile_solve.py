#!/usr/bin/env python3
"""Where a CG solve of the PyTorch/CUDA port spends its time on one card.

    python3 scripts/torch_profile_solve.py [n] [mode]

Solves the bench's sphere RVE (n^3, default 256, float32, residual tol
1e-6, check_every 8) in ``mode`` (elasticity, the default, heat or
viscosity; chip_smoke.PATHS) twice without the profiler and reports the second
run's wall time, then once under torch.profiler and reports the device
time by kernel, by kind (the port's kernels, cuFFT, PyTorch elementwise
and reduction kernels) and the device's idle share of the unprofiled wall
time.  Prints one JSON line last.
"""
import json
import sys
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
    if "reduce" in n:
        return "torch reductions"
    if "elementwise" in n or "copy" in n or "fill" in n:
        return "torch elementwise"
    return "other"


def main():
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import sphere_solver
    from fibergen_tpu_torch.utils.logging import LOG

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    LOG.enabled = False
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    mode = sys.argv[2] if len(sys.argv) > 2 else "elasticity"
    s = sphere_solver(n, "float32", "cuda", mode, error_estimator="residual",
                      tol=1e-6, check_every=8, maxiter=4000)
    assert not s.run()
    assert not s.run()
    wall = s.solve_time
    its = len(s.residuals)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        assert not s.run()
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
    print(f"{card}: {n}^3 float32 {mode}, {its} iterations, unprofiled wall "
          f"{1e3 * wall:.3f} ms, device busy {busy_ms:.3f} ms, idle share "
          f"{1 - busy_ms / (1e3 * wall):.3f}")
    for us, count, name in rows[:16]:
        print(f"  {us / 1e3:9.3f} ms {count:6d}x  {name[:90]}")
    for k, ms in sorted(kinds.items(), key=lambda kv: -kv[1]):
        print(f"  {k:18s} {ms:9.3f} ms  {ms / busy_ms:6.1%} of busy")
    print(json.dumps({"n": n, "mode": mode, "iterations": its,
                      "wall_ms": 1e3 * wall,
                      "device_busy_ms": busy_ms,
                      "idle_share": 1 - busy_ms / (1e3 * wall),
                      "by_kind_ms": kinds, "device": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
