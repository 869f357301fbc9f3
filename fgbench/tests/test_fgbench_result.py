"""A run's result line and standard error, by the benchmark's contract, on
the CPU at 16^3 (the harness's look for a card skipped)."""
import json
import shutil
import subprocess
import sys

import pytest

from _cpu import ROOT, run_cpu
from fgbench.harness import check, imports, manifest

M = manifest.load_manifest()
CELLS = [w["name"] for w in M["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_result_line_has_the_contract_keys(workload, trace):
    rc, res, modules, err = run_cpu(workload, trace=trace)
    assert rc == 0
    assert list(res) == KEYS + (["breakdown"] if trace else []) + ["check"]
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    if trace:
        assert set(res["device"]) >= {"busy_s", "window_s"}
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in res["breakdown"].values())
    listed = {m["name"]: m["unit"]
              for m in manifest.metrics_of(M, workload, trace)}
    for name, m in res["metrics"].items():     # the CPU reads fewer
        assert m["unit"] == listed[name] and m["value"] > 0
    if not trace:
        assert {"case_s", "setup_s"} <= set(res["metrics"])
    else:
        assert "cg_iterations_per_case" in res["metrics"]
    # the compared numbers, each beside its limit, last in the line and
    # last on standard error
    assert list(res["check"]) == list(check.NAMES)
    tail = err.strip().splitlines()[-len(check.NAMES):]
    for line, name in zip(tail, check.NAMES):
        assert line.startswith(f"check {name} ") and " limit " in line
    assert not imports.forbidden_loaded(modules)


def test_the_command_refuses_without_a_card():
    p = subprocess.run([sys.executable, "fgbench/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300,
                       env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_a_checkout_of_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "fgbench", tmp_path / "fgbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, time; sys.path.insert(0, '.');"
            "from pathlib import Path; from fgbench.harness import cell;"
            "cell.execute('elastic-cases', 1, 1.0, False, t_process="
            "time.perf_counter(), device='cpu', shape=(8, 8, 8), "
            "root=Path('.').resolve())")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and "fibergen_tpu_torch" in p.stderr
    assert p.stdout.strip() == ""


def test_the_seed_gives_the_same_inputs_and_work():
    import itertools

    import torch

    from fgbench.harness import problem, traffic
    _, cfg, mix = manifest.cell(M, CELLS[0])
    shape = (16, 16, 16)

    def inputs(seed):
        rng = problem.rng_of(seed)
        shift = problem.draw(cfg, rng, shape)
        reqs = list(itertools.islice(traffic.requests(mix, 6, rng), 12))
        return shift, reqs, problem.fields(cfg, shift, shape, "cpu")

    a, b, c = inputs(2 ** 33 + 5), inputs(2 ** 33 + 5), inputs(2 ** 31 + 1)
    assert a[0] == b[0] and a[1] == b[1] and torch.equal(a[2], b[2])
    # another seed: the same voxels translated, the same cases in turn
    assert float(a[2].sum()) == float(c[2].sum())
    assert torch.equal(torch.roll(a[2], [s - t for s, t in zip(c[0], a[0])],
                                  dims=(0, 1, 2)), c[2])
    assert sorted(a[1][:6]) == sorted(c[1][:6]) == [(k,) for k in range(6)]
    # and the same answers
    ra = run_cpu(CELLS[0], seed=2 ** 33 + 5, seconds=0.5)[1]
    rc = run_cpu(CELLS[0], seed=2 ** 31 + 1, seconds=0.5)[1]
    assert ra["check"]["stress_gap"]["value"] < 1e-6
    assert rc["check"]["stress_gap"]["value"] < 1e-6


def test_result_line_is_one_json_object():
    rc, res, _, _ = run_cpu(CELLS[1])
    line = json.dumps(res)
    assert "\n" not in line and json.loads(line) == res
