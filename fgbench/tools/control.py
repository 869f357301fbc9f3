"""The output check's control: the plain reference put in the program's
place, computed with its fields in bfloat16 (the precision below the
configuration's float32), its answers judged by the same comparison as a
run's (``harness/check.py``).  A sound check fails it.

    python3 fgbench/tools/control.py --config sphere-elastic-256 --seeds 1 2 3

prints one JSON line per seed: the compared numbers beside the limits and
whether the control failed them.  ``--device cpu --n 16`` runs it small;
``--load-cases`` names the set of load cases (``fgbench/loads/``).
The benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from fgbench.harness import check, manifest, problem  # noqa: E402


def answers(reference, config, geom, loads, cases, store):
    """The reference put in the program's place, computed with its fields
    kept in ``store``: (mean stresses, fields) of ``cases``, as a request
    of the program gives them."""
    means, fields = [], []
    for c in cases:
        sol = reference.solve(config, geom, loads[c], tol=float(
            config["solver"]["tol"]), store=store)
        means.append(sol.mean.cpu().numpy())
        fields.append(sol.field.float())
    return np.stack(means), torch.stack(fields)


def readings(config_name, seed, load_cases, device="cuda", n=None,
             store=None):
    """The control's compared numbers on ``seed``: every load case of the
    set ``load_cases`` (``fgbench/loads/``), each answered by the
    configuration's reference kept in ``store``."""
    store = store or torch.bfloat16
    man = manifest.load_manifest()
    entry = manifest.by_name(man["configs"], config_name, "config")
    config = manifest.load_json(ROOT / entry["file"])
    shape = (n,) * 3 if n else tuple(config["grid"])
    drawn = problem.draw(config, problem.rng_of(seed), shape)
    loads = problem.load_cases(config, {"load_cases": load_cases})
    reference = problem.reference(config)
    geom = problem.fields(config, drawn, shape, torch.device(device),
                          torch.float64)
    cases = tuple(range(len(loads)))
    means, fields = answers(reference, config, geom, loads, cases, store)
    numbers = check.gaps(reference, config, geom, loads, [(cases, means)],
                         cases, fields)
    numbers["failed_cases"] = 0
    return numbers, check.limits_of(config)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=None)
    ap.add_argument("--load-cases", default="unit")
    args = ap.parse_args(argv)
    for seed in args.seeds:
        numbers, limits = readings(args.config, seed, args.load_cases,
                                   args.device, args.n)
        print(json.dumps({"config": args.config, "seed": seed,
                          "numbers": numbers, "limits": limits,
                          "control_fails": not check.verdict(numbers,
                                                             limits)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
