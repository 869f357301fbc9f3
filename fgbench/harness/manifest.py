"""``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, traffic mix, metric, byte
count, geometry, mixing rule, set of load cases or reference lives in a
file of its own, found by name:

    fgbench/configs/<config>.json     (the path is the manifest's ``file``)
    fgbench/traffic/<traffic>.json
    fgbench/metrics/<metric>.py       ``read(run) -> float | None``
    fgbench/counts/<operator>.py      bytes an application moves
    fgbench/geometry/<shape>.py       a configuration's ``inclusion.shape``
    fgbench/mixing/<rule>.py          a configuration's ``mixing``
    fgbench/loads/<set>.py            a traffic mix's ``load_cases``
    fgbench/reference/<name>.py       a configuration's ``reference``, by
                                      default its ``mode``

(``harness/problem.py`` gives the interfaces of the last four), so a new
cell, configuration, metric or count is new files plus manifest entries.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

_modules: dict = {}


def load_manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def by_name(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(manifest: dict, workload: str, root: Path = ROOT):
    """(workload entry, configuration, traffic mix) of a cell."""
    w = by_name(manifest["workloads"], workload, "workload")
    c = by_name(manifest["configs"], w["config"], "config")
    config = load_json(root / c["file"])
    traffic = load_json(root / "fgbench" / "traffic" / f"{w['traffic']}.json")
    return w, config, traffic


def metrics_of(manifest: dict, workload: str, trace: bool) -> list:
    """The metric entries a run of ``workload`` reports: the end-to-end ones
    with ``trace`` off, the per-layer ones with it on; an entry with a
    ``workloads`` key only in the cells it lists."""
    entries = manifest["per_layer" if trace else "end_to_end"]
    return [m for m in entries
            if "workloads" not in m or workload in m["workloads"]]


def plugin(kind: str, name: str, root: Path = ROOT):
    """The module ``fgbench/<kind>/<name>.py``, or None where there is no
    such file."""
    path = root / "fgbench" / kind / f"{name}.py"
    key = str(path)
    if key not in _modules:
        if not path.is_file():
            _modules[key] = None
        else:
            spec = importlib.util.spec_from_file_location(
                f"fgbench_{kind}_{name.replace('-', '_').replace('.', '_')}",
                path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            _modules[key] = mod
    return _modules[key]
