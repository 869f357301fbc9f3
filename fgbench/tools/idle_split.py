"""The device's idle time under the port's own spans, from one traced run
of a cell, split by the innermost span open over it.

    python3 fgbench/tools/idle_split.py --workload elastic-cases --seed 7

runs the cell (``--seconds``, 51 by default) as ``fgbench/run.py --trace
1`` does and prints its result line, then one JSON line:
``idle_ms_per_case``, the device's idle gaps of at least 20 us while
``fg.run``, ``fg.run_batched`` or ``fg.mean_stress`` is open
(``solver_idle_ms_per_case``) by the innermost ``fg.*`` span over them
(``harness/spans.py``); ``entry_own_idle_ms_per_case``, its part under an
entry span's own time (no child span open) by the innermost host
operation open where each piece begins; ``spans_per_case``, the
program's spans in the window by name.  ``--device cpu --n 16`` runs it small (no device
operation: no idle).  The benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import collections
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from fgbench.harness import cell, spans  # noqa: E402
from fgbench.harness import trace as tracemod  # noqa: E402


def traced_run(workload, seed, seconds, device="cuda", shape=None):
    """(exit code, result line, the window's trace.Trace) of one traced
    run of ``workload``."""
    kept = []
    stop = tracemod.Capture.stop

    def keep(capture):
        tr = stop(capture)
        kept.append(tr)
        return tr

    tracemod.Capture.stop = keep
    try:
        rc, result = cell.execute(workload, seed, seconds, True,
                                  t_process=time.perf_counter(),
                                  device=device, shape=shape)
    finally:
        tracemod.Capture.stop = stop
    return rc, result, kept[0] if kept else None


def entries_own_idle(tr) -> dict:
    """The idle under an entry span's own time (no child span open) by
    the innermost host operation open where each piece of it begins
    (``trace.Trace``'s naming of idle gaps): ns by name."""
    out: dict = {}
    for a, b, name in spans.idle_pieces(tr):
        if name in spans.ENTRIES:
            op = tr._open_at(a, tr.host_start, tr.host_end, tr.host_name,
                             256)
            key = f"{name} > {op}"
            out[key] = out.get(key, 0) + b - a
    return out


def split(tr, cases: int) -> dict:
    """The solver's idle ms a case by innermost span, the part under the
    entries' own time by host operation, and the program's spans a case
    by name."""
    idle = spans.idle_under_spans(tr) if tr.n_device_ops else {}
    own = entries_own_idle(tr) if tr.n_device_ops else {}
    names = collections.Counter(n for _, _, n in spans.program_spans(tr))

    def per_case(d):
        return {n: 1e-6 * v / cases
                for n, v in sorted(d.items(), key=lambda kv: -kv[1])[:16]}

    return {"idle_ms_per_case": per_case(idle),
            "entry_own_idle_ms_per_case": per_case(own),
            "spans_per_case": {n: c / cases
                               for n, c in sorted(names.items())}}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="fgbench/tools/idle_split.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=None)
    args = ap.parse_args(argv)
    import torch
    torch.set_num_threads(1)
    shape = (args.n,) * 3 if args.n else None
    rc, result, tr = traced_run(args.workload, args.seed, args.seconds,
                                args.device, shape)
    if result is None or tr is None:
        return rc or 1
    print(json.dumps(result))
    print(json.dumps(split(tr, result["attempted"])), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
