"""A cell's inputs from its configuration and ``--seed``: the geometry, the
load cases and the order in which they are sent, and the reference that
judges the answers.  Each kind is a file of its own, found by name:

    fgbench/geometry/<inclusion.shape>.py
        draw(config, rng, shape)    every random draw the geometry needs
        fields(config, drawn, shape, device, dtype)
                                    what the material and the reference
                                    are given, from the draws alone
    fgbench/loads/<traffic.load_cases>.py
        cases(config, dim)          the (n, dim) load vectors
    fgbench/reference/<reference>.py   (``reference`` by default ``mode``)
        DIM                         the load vectors' length
        solve(config, geom, load, tol=, maxiter=, store=)

The geometry's draws are the first of the seed's generator and the
traffic's come after them, so a seed fixes both.  What ``fields`` returns
the harness only passes on: to the configuration's mixing rule in float32
and, once the program is freed, to the reference in float64.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from fgbench.harness import manifest


def plugin(kind: str, name: str, root: Path = manifest.ROOT):
    """``fgbench/<kind>/<name>.py``; raises where there is none."""
    mod = manifest.plugin(kind, name, root)
    if mod is None:
        raise FileNotFoundError(f"no fgbench/{kind}/{name}.py")
    return mod


def rng_of(seed: int) -> np.random.Generator:
    return np.random.default_rng(int(seed) % 2 ** 64)


def draw(config: dict, rng: np.random.Generator, shape,
         root: Path = manifest.ROOT):
    return plugin("geometry", config["inclusion"]["shape"], root).draw(
        config, rng, shape)


def fields(config: dict, drawn, shape, device, dtype=torch.float32,
           root: Path = manifest.ROOT):
    return plugin("geometry", config["inclusion"]["shape"], root).fields(
        config, drawn, shape, device, dtype)


# the names phase 17 of chip_smoke.py calls
shift_of, phase_field = draw, fields


def reference(config: dict, root: Path = manifest.ROOT):
    """The plain reference the configuration names, or its mode's."""
    return plugin("reference", config.get("reference", config["mode"]), root)


def dim(config: dict, root: Path = manifest.ROOT) -> int:
    return int(reference(config, root).DIM)


def load_cases(config: dict, traffic: dict,
               root: Path = manifest.ROOT) -> np.ndarray:
    """(n_cases, dim) load vectors of the traffic's ``load_cases``."""
    d = dim(config, root)
    out = np.asarray(plugin("loads", traffic["load_cases"], root).cases(
        config, d), dtype=np.float64)
    if out.ndim != 2 or out.shape[1] != d:
        raise ValueError(f"load cases {traffic['load_cases']!r} give shape "
                         f"{out.shape}, not (n, {d})")
    return out
