"""The plain reference against the port's CPU path on a small sphere in
both modes (heat on the tests' own configuration), and the control, a
lowered-precision result, failing the comparison."""
import ast
from pathlib import Path

import pytest
import torch

from _cpu import heat_config
from fgbench.harness import check, manifest, problem, program
from fgbench.harness.cell import import_program
from fgbench.tools import control

M = manifest.load_manifest()
CONFIGS = [c["name"] for c in M["configs"]]


def _config(name):
    if name == "sphere-heat":
        return heat_config()
    return manifest.load_json(manifest.ROOT / manifest.by_name(
        M["configs"], name, "config")["file"])


@pytest.mark.parametrize("name", CONFIGS + ["sphere-heat"])
def test_reference_agrees_with_the_port_in_float64(name):
    ft = import_program(manifest.ROOT)
    cfg = _config(name)
    cfg["solver"] = dict(cfg["solver"], dtype="float64", tol=1e-12)
    shape = (16, 12, 10)
    geom = problem.fields(cfg, (3, 5, 1), shape, "cpu", torch.float64)
    solver = program.build(ft, cfg, geom, "cpu", shape)
    reference = problem.reference(cfg)
    loads = problem.load_cases(cfg, {"load_cases": "unit"})
    for c in range(len(loads)):
        means, bad, _ = program.call(solver, "run", loads[[c]])
        assert not bad[0]
        numbers = check.gaps(reference, cfg, geom, loads, [((c,), means)],
                             (c,), program.fields(solver, "run"))
        assert numbers["stress_gap"] < 1e-9 and numbers["field_gap"] < 1e-9


@pytest.mark.parametrize("name", CONFIGS)
def test_float32_solve_passes_and_the_bfloat16_control_fails(name):
    ft = import_program(manifest.ROOT)
    cfg = _config(name)
    shape = (16, 16, 16)
    geom = problem.fields(cfg, (1, 2, 3), shape, "cpu")
    solver = program.build(ft, cfg, geom, "cpu", shape)
    loads = problem.load_cases(cfg, {"load_cases": "unit"})
    reference = problem.reference(cfg)
    geom64 = geom.double()
    cases = tuple(range(len(loads)))
    means, _, _ = program.call(solver, "run_batched", loads)
    numbers = check.gaps(reference, cfg, geom64, loads, [(cases, means)],
                         cases, program.fields(solver, "run_batched"))
    numbers["failed_cases"] = 0
    limits = check.limits_of(cfg)
    assert check.verdict(numbers, limits)
    ctl, _ = control.readings(name, 5, "unit", device="cpu", n=16)
    assert not check.verdict(ctl, limits)
    # by a wide margin on the field, the number the control fails
    assert ctl["field_gap"] > 3 * limits["field_gap"]
    assert numbers["field_gap"] < limits["field_gap"] / 30


def _imports(path):
    tree = ast.parse(Path(path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for f in (manifest.ROOT / "fgbench").rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(f)}
        assert not tops & {"jax", "jaxlib", "flax", "fibergen_tpu"}, f


def test_the_reference_takes_nothing_of_the_program():
    for f in (manifest.ROOT / "fgbench" / "reference").glob("*.py"):
        tops = {m.split(".")[0] for m in _imports(f)}
        assert tops <= {"__future__", "dataclasses", "math", "torch",
                        "numpy", "fgbench"}, f
        assert not {m for m in _imports(f)
                    if m.startswith("fgbench.")} - {"fgbench.reference"}, f


def test_the_geometry_takes_nothing_of_the_program():
    for f in (manifest.ROOT / "fgbench" / "geometry").glob("*.py"):
        tops = {m.split(".")[0] for m in _imports(f)}
        assert tops <= {"__future__", "math", "torch", "numpy"}, f
