#!/usr/bin/env python3
"""Device time of the K3 G0 chain of the PyTorch/CUDA port on one card.

    python3 scripts/torch_time_chain.py [n] [float32|float64]

Times ``g0_staggered_chain`` on a random (3, n, n, n) field (default 256,
float32) and the cuFFT rfftn + irfftn pair on the same field, each the mean
of 50 calls after 5 warm-up calls, from CUDA events, and checks the chain
against its plain twin.  Imports the package beside this script, so a
checkout elsewhere times its own kernels.  Prints one JSON line.
"""
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    import fibergen_tpu_torch as ft
    from fibergen_tpu_torch.ops import fft, green
    from fibergen_tpu_torch.ops import spectral_kernels as spk

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    dtype = getattr(torch, sys.argv[2]) if len(sys.argv) > 2 else torch.float32
    g = ft.Grid(n, n, n)
    gen = torch.Generator(device="cuda").manual_seed(7)
    f = torch.randn((3, n, n, n), generator=gen, device="cuda", dtype=dtype)
    c10, c20 = green.g0_constants(2.75, 0.0)

    def ms(fn, reps=50, warm=5):
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

    got = spk.g0_staggered_chain(g, f, c10, c20)
    ref = spk.g0_staggered_chain_plain(g, f, c10, c20)
    err = float((got - ref).abs().max() / ref.abs().max())
    rec = {"n": n, "dtype": str(dtype)[6:], "device":
           torch.cuda.get_device_name(0),
           "chain_ms": ms(lambda: spk.g0_staggered_chain(g, f, c10, c20)),
           "cufft_pair_ms": ms(lambda: fft.ifftn(fft.fftn(f), g.shape)),
           "max_rel_err": err, "source": str(Path(spk.__file__).parent)}
    print(json.dumps(rec))
    return 0 if err <= (1e-5 if dtype == torch.float32 else 1e-12) else 1


if __name__ == "__main__":
    sys.exit(main())
