"""The command on a card: each cell for a short window comes out correct,
with the device it ran on.  Skips without a card.

    python -m pytest fgbench/tests/test_fgbench_card.py -q
"""
import json
import subprocess
import sys

import pytest

from _cpu import ROOT
from fgbench.harness import manifest

M = manifest.load_manifest()


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in M["workloads"]])
def test_cell_runs_correct_on_the_card(cuda, workload):
    p = subprocess.run([sys.executable, "fgbench/run.py", "--workload",
                        workload, "--seed", str(2 ** 31 + 99), "--seconds",
                        "2", "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=1500)
    assert p.returncode == 0, p.stderr[-4000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["failed"] == 0
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
