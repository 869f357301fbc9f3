"""One run of one cell: set-up, warm-up, the measured window, the output
check, the metrics and the result line.

    set-up   the geometry on the device from the seed, the solver, and
             one request of the cell's traffic (which builds the CUDA
             sources on a checkout's first run and fixes the reference
             medium); ``setup_s`` is the process's start to the window's
    window   a closed loop with one client for ``seconds``: it holds whole
             requests and ends at the return of the last one begun before
             the time ran out; with ``trace`` under ``torch.profiler``
    check    the program's peak memory read, its state freed, the plain
             reference solves every load case served (``check.py``)
    metrics  each metric of the cell in ``BENCHMARK.json`` from its reader
             in ``fgbench/metrics/``; a reader that finds nothing to read
             returns None and the metric is left out
"""
from __future__ import annotations

import dataclasses
import gc
import sys
import time
import traceback
from pathlib import Path

import numpy as np

from fgbench.harness import check, imports, manifest, problem, program
from fgbench.harness import trace as tracemod
from fgbench.harness import traffic as trafficmod


@dataclasses.dataclass
class Request:
    cases: tuple
    latency_s: float
    iterations: int
    failed: list
    means: np.ndarray


@dataclasses.dataclass
class Run:
    """What a metric reader (``fgbench/metrics/<name>.py``) reads."""
    workload: dict
    config: dict
    traffic: dict
    shape: tuple
    itemsize: int
    batch: int              # load cases a request carries
    device_type: str
    setup_s: float
    window_s: float
    requests: list
    peak_bytes: int
    calls: dict             # chain applications in the window, (name, C)
    trace: object           # trace.Trace of a traced run, else None
    peaks: object           # the device's row of fgbench/peaks.json
    root: Path

    @property
    def cases_done(self) -> int:
        return sum(len(r.cases) for r in self.requests)

    @property
    def voxels(self) -> int:
        return int(np.prod(self.shape))

    def count(self, operator: str):
        """The byte count of ``operator`` (``fgbench/counts/``), or None."""
        return manifest.plugin("counts", operator, self.root)


def import_program(root: Path):
    """The package under test, from the checkout at ``root`` and nowhere
    else."""
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    import fibergen_tpu_torch as ft
    where = Path(ft.__file__).resolve()
    if not where.is_relative_to(root.resolve()):
        raise RuntimeError(f"fibergen_tpu_torch was loaded from {where}, "
                           f"outside the checkout {root}")
    from fibergen_tpu_torch.utils.logging import LOG
    LOG.enabled = False
    return ft


def _calls():
    from fibergen_tpu_torch.ops import spectral_kernels
    return dict(spectral_kernels.calls)


def _delta(after, before):
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


SETUP = []     # (phase, perf_counter at its end), for the set-up's line;
               # fgbench/run.py adds the interpreter's start and the imports


def _mark(phase: str):
    SETUP.append((phase, time.perf_counter()))


def _setup_line(t_process: float, t_start: float) -> str:
    """Each phase of the set-up with its seconds, in order."""
    out, t = [], t_process
    for phase, t_end in SETUP + [("rest", t_start)]:
        out.append(f"{phase} {t_end - t:.3f}")
        t = t_end
    SETUP.clear()
    return "setup s: " + ", ".join(out)


def _peaks(root, kind):
    table = manifest.load_json(root / "fgbench" / "peaks.json")
    return table.get(kind)


def execute(workload, seed, seconds, trace, *, t_process, device="cuda",
            shape=None, root: Path = manifest.ROOT, log=sys.stderr):
    """Run the cell once; returns (exit code, result dict or None).  Prints
    the compared numbers beside their limits as the last lines on ``log``.
    ``device`` and ``shape`` other than the cell's are for the harness's
    own tests on the CPU."""
    import torch

    man = manifest.load_manifest(root)
    w, config, traffic = manifest.cell(man, workload, root)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.zeros((), device=dev)
        torch.cuda.synchronize(dev)
        _mark("cuda context")
    ft = import_program(root)
    _mark("import program")
    shape = tuple(shape or config["grid"])
    rng = problem.rng_of(seed)
    drawn = problem.draw(config, rng, shape, root)
    loads = problem.load_cases(config, traffic, root)
    entry = traffic["entry"]
    schedule = trafficmod.requests(traffic, len(loads), rng)
    batch = trafficmod.per_request(traffic, len(loads))

    solver = program.build(ft, config, problem.fields(
        config, drawn, shape, dev, root=root), dev, shape, root)
    if cuda:
        torch.cuda.synchronize(dev)
    _mark("solver")
    program.call(solver, entry, loads[list(next(schedule))])   # warm-up
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    _mark("warm-up")
    calls0 = _calls()
    cap = tracemod.Capture(trace, dev.type)
    cap.start()
    requests = []
    t_start = time.perf_counter()
    setup_s = t_start - t_process
    with cap.span(tracemod.WINDOW):
        while True:
            cs = next(schedule)
            t0 = time.perf_counter()
            with cap.span(f"{tracemod.REQUEST} {entry} {cs}"):
                means, bad, iters = program.call(solver, entry,
                                                 loads[list(cs)])
            t_end = time.perf_counter()
            requests.append(Request(cs, t_end - t0, iters, bad, means))
            if t_end - t_start >= seconds:
                break
    tr = cap.stop()
    peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
    run = Run(workload=w, config=config, traffic=traffic, shape=shape,
              itemsize=torch.empty((), dtype=solver.dtype).element_size(),
              batch=batch, device_type=dev.type, setup_s=setup_s,
              window_s=t_end - t_start, requests=requests, peak_bytes=peak,
              calls=_delta(_calls(), calls0), trace=tr,
              peaks=_peaks(root, kind), root=root)
    del cap         # the profiler's own copy of the events

    # the check: the last request's fields kept, the rest of the program
    # freed, then the reference on the same geometry
    last = program.fields(solver, entry)
    del solver
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    reference = problem.reference(config, root)
    geom = problem.fields(config, drawn, shape, dev, torch.float64, root)
    try:
        numbers = check.gaps(reference, config, geom, loads,
                             [(r.cases, r.means) for r in requests],
                             requests[-1].cases, last)
    except ValueError as e:     # a reference refusing the configuration
        print(f"the reference {Path(reference.__file__).name} refuses the "
              f"configuration: {e}", file=log)
        numbers = {"stress_gap": float("nan"), "field_gap": float("nan")}
    del last, geom
    numbers["failed_cases"] = sum(sum(r.failed) for r in requests)
    limits = check.limits_of(config)
    correct = check.verdict(numbers, limits)

    metrics = {}
    for m in manifest.metrics_of(man, workload, trace):
        reader = manifest.plugin("metrics", m["name"], root)
        if reader is None:
            raise RuntimeError(f"no reader fgbench/metrics/{m['name']}.py")
        value = reader.read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": kind,
                   "count": int(w["chips"]), "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": run.cases_done,
              "failed": int(numbers["failed_cases"]), "metrics": metrics,
              "device": device_info}
    if tr is not None:
        device_info["busy_s"] = tr.busy_s
        device_info["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.top_device_ops(),
                               "idle_gaps": tr.idle_gaps()}
    result["check"] = {k: {"value": check.plain(numbers[k]),
                           "limit": limits[k]} for k in check.NAMES}

    print(_setup_line(t_process, t_start), file=log)
    lat = [r.latency_s for r in requests]
    print(f"window {run.window_s!r} s: {len(requests)} requests, "
          f"{run.cases_done} cases, latency first {lat[:3]!r} min "
          f"{min(lat)!r} max {max(lat)!r}", file=log)
    bad = imports.forbidden_loaded()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=log)
        return 3, None
    for k in check.NAMES:
        print(f"check {k} {numbers[k]!r} limit {limits[k]!r}", file=log)
    return 0, result


def main(argv, t_process):
    """The command line: ``--workload --seed --seconds --trace``."""
    import argparse
    ap = argparse.ArgumentParser(prog="fgbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    torch.set_num_threads(1)
    man = manifest.load_manifest()
    chips = int(manifest.by_name(man["workloads"], args.workload,
                                 "workload")["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    try:
        rc, result = execute(args.workload, args.seed, args.seconds,
                             bool(args.trace), t_process=t_process)
    except Exception:
        traceback.print_exc()
        return 1
    if result is not None:
        import json
        sys.stderr.flush()
        print(json.dumps(result), flush=True)
    return rc
