"""Declarative parameter-sweep harness on the port's FG.

Port of fibergen_tpu/experiment.py (the reference's demo/common.py
Experiment class): sweep XML paths over value grids, collect getter
results, cache each run as ``run_<hash>.json`` keyed by the SHA-256 of
the project XML the run solved, and dump the rows as JSON (``results_dat``)
or as a whitespace-separated table (:func:`write_dat`).  The cache keys,
the cached data and both files are those the JAX package writes for the
same sweep, so either package reads the other's cache.  Each run solves
on ``device`` (``cuda`` by default, raising without a card; ``"cpu"``
for the plain PyTorch path).
"""
from __future__ import annotations

import hashlib
import itertools
import json
import os
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from .api import FG
from .utils.logging import LOG

# getter key -> FG accessor
_RESULT_GETTERS: Dict[str, Callable[[FG], object]] = {
    "effective_property": lambda fg: fg.get_effective_property(),
    "mean_stress": lambda fg: fg.get_mean_stress(),
    "mean_strain": lambda fg: fg.get_mean_strain(),
    "mean_energy": lambda fg: fg.get_mean_energy(),
    "mean_cauchy_stress": lambda fg: fg.get_mean_cauchy_stress(),
    "residuals": lambda fg: fg.get_residuals(),
    "num_iterations": lambda fg: len(fg.get_residuals()),
    "solve_time": lambda fg: fg.get_solve_time(),
    "A2": lambda fg: fg.get_A2(),
    "error": lambda fg: fg.get_error(),
}


class Experiment:
    """Parameter sweep over an XML project (a path or the XML text).

    ex = Experiment("project.xml", results_dat="out.json", device="cpu")
    ex.add_param("solver..n", [16, 32, 64])
    ex.add_param("solver.tol", [1e-6])
    ex.add_result("effective_property")
    table = ex.run()
    """

    def __init__(self, project_xml: str, results_dat: Optional[str] = None,
                 cache_dir: Optional[str] = None, device=None):
        self.project_xml = project_xml
        self.results_dat = results_dat
        self.cache_dir = cache_dir
        self.device = device
        self.parameters: List[tuple] = []
        self.results: List[tuple] = []
        self.info: Dict[str, object] = {}

    def add_info(self, key, value):
        self.info[key] = value

    def add_param(self, path: str, values: Sequence, record: bool = True):
        """Sweep ``path`` over ``values`` (outer product with the other
        parameters)."""
        self.parameters.append((path, list(values), record))
        return self

    def add_result(self, key: str, getter: Callable[[FG], object] = None):
        """Record a result per run: one of the standard getters by key, or a
        callable fg -> value."""
        if getter is None:
            if key not in _RESULT_GETTERS:
                raise ValueError(f"Unknown result key '{key}'; pass a getter")
            getter = _RESULT_GETTERS[key]
        self.results.append((key, getter))
        return self

    def add_results(self, keys):
        for k in keys:
            self.add_result(k)
        return self

    # ------------------------------------------------------------------ run
    def _cache_path(self, xml: str):
        if self.cache_dir is None:
            return None
        h = hashlib.sha256(xml.encode()).hexdigest()[:24]
        return os.path.join(self.cache_dir, f"run_{h}.json")

    def run(self, dry: bool = False, cache_only: bool = False) -> List[dict]:
        """Run the whole sweep; returns one dict per run.  A run whose XML
        has a cache file takes its results from it; ``dry`` and
        ``cache_only`` solve nothing."""
        if isinstance(self.project_xml, str) \
                and os.path.exists(self.project_xml):
            with open(self.project_xml) as f:
                base_xml = f.read()
            base_dir = os.path.dirname(os.path.abspath(self.project_xml))
        else:
            base_xml = self.project_xml
            base_dir = None

        grids = [p[1] for p in self.parameters]
        rows = []
        for combo in itertools.product(*grids) if grids else [()]:
            fg = FG(device=self.device)
            fg.set_xml(base_xml)
            if base_dir:
                fg._xml_dir = base_dir
            row = dict(self.info)
            for (path, _, record), value in zip(self.parameters, combo):
                fg.set(path, value)
                if record:
                    row[path] = value
            xml = fg.get_xml()
            cache = self._cache_path(xml)
            if cache and os.path.exists(cache):
                with open(cache) as f:
                    row.update(json.load(f))
                rows.append(row)
                continue
            if dry or cache_only:
                if not cache_only:
                    LOG.info(f"dry run: {row}")
                rows.append(row)
                continue
            fg.run()
            data = {}
            for key, getter in self.results:
                try:
                    data[key] = getter(fg)
                except Exception as e:  # noqa: BLE001
                    data[key] = None
                    LOG.warn(f"result '{key}' failed: {e}")
            if cache:
                os.makedirs(self.cache_dir, exist_ok=True)
                with open(cache, "w") as f:
                    json.dump(data, f)
            row.update(data)
            rows.append(row)

        if self.results_dat:
            with open(self.results_dat, "w") as f:
                json.dump(rows, f, indent=1, default=_jsonable)
        return rows


def _jsonable(v):
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    return str(v)


VOIGT_SUFFIX = [11, 22, 33, 23, 13, 12, 32, 31, 21]


def voigt_index_key(key: str, i: int) -> str:
    """sigma, 0 -> 'sigma_11' (voigt_index_keygen, demo/common.py:160)."""
    return f"{key}_{VOIGT_SUFFIX[i]}"


def expand_voigt(key: str, data, mode: str = "elasticity"):
    """A Voigt vector result as per-component (key_ij, value) items, with
    the mode-dependent renaming of the reference harness (expand_data,
    demo/common.py:163-187): in viscosity the solver's 'stress' is the
    shear rate gamma and its 'strain' the fluid stress."""
    key_map = {"elasticity": {"mean_stress": "sigma",
                              "mean_strain": "epsilon"},
               "hyperelasticity": {"mean_stress": "sigma",
                                   "mean_strain": "epsilon"},
               "viscosity": {"mean_stress": "gamma", "mean_strain": "sigma"}}
    key = key_map.get(mode, {}).get(key, key)
    arr = np.asarray(data)
    if arr.ndim == 0:
        return [(key, float(arr))]
    return [(voigt_index_key(key, i), float(v))
            for i, v in enumerate(arr.ravel())]


def write_dat(path: str, rows):
    """Write a flat tab-separated table (write_dict, demo/common.py:273-281):
    one header line, one line per run, arrays expanded into indexed
    columns, a missing value written as nan."""
    flat_rows = []
    keys: List[str] = []
    for row in rows:
        flat = {}
        for k, v in row.items():
            a = np.asarray(v) if not isinstance(v, (str, type(None))) \
                else None
            if a is not None and a.ndim > 0:
                for i, x in enumerate(a.ravel()):
                    flat[f"{k}_{i}"] = x
            else:
                flat[k] = v
        for k in flat:
            if k not in keys:
                keys.append(k)
        flat_rows.append(flat)
    with open(path, "w") as f:
        f.write("\t".join(keys) + "\n")
        for flat in flat_rows:
            f.write("\t".join(str(flat.get(k, "nan")) for k in keys) + "\n")


def iso_sphere_points(n: int, iterations: int = 200, seed: int = 0):
    """About uniform points on the unit sphere by electrostatic repulsion
    (IsoSpherePointGenerator, demo/common.py:367-435), for orientation
    averages of effective properties; the same points for a seed."""
    rng = np.random.default_rng(seed)
    p = rng.normal(size=(n, 3))
    p /= np.linalg.norm(p, axis=1, keepdims=True)
    if n == 1:
        return p
    step = 0.1
    for _ in range(iterations):
        d = p[:, None, :] - p[None, :, :]
        r2 = (d * d).sum(-1) + np.eye(n)
        f = (d / (r2 ** 1.5)[..., None]).sum(axis=1)
        # the force's part in the tangent plane moves the point
        f -= (f * p).sum(-1, keepdims=True) * p
        p = p + step * f / n
        p /= np.linalg.norm(p, axis=1, keepdims=True)
    return p


def run_experiment(build: Callable[["Experiment"], None], project_xml: str,
                   results_dat: Optional[str] = None, cache_dir=None,
                   cache_only: bool = False, device=None):
    """Convenience wrapper (run_experiment, demo/common.py:437): build(ex)
    configures the sweep, which is run, optionally written, and returned."""
    ex = Experiment(project_xml, results_dat=results_dat, cache_dir=cache_dir,
                    device=device)
    build(ex)
    return ex.run(cache_only=cache_only)
