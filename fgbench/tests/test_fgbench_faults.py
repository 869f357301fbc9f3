"""A run with the timed path broken underneath comes out not correct: once
for each fault a cell can have.  The runs skip the look for a card and
drive the rest of a run on the CPU at 16^3.

* a step that returns its state unchanged: every cell;
* half of the batch left out, its other cases answered from the rest: the
  batched cells;
* a load case's answer altered where it is produced (the solved field of
  one request scaled by 1 + 1e-3): every cell.

The exchange between chips cannot be left out: every cell has one chip.
"""
import time

import numpy as np
import pytest
import torch

from fgbench.harness import cell, manifest
from fgbench.harness.cell import import_program

M = manifest.load_manifest()
CELLS = [w["name"] for w in M["workloads"]]
BATCHED = [w["name"] for w in M["workloads"]
           if manifest.cell(M, w["name"])[2]["entry"] == "run_batched"]


def _run(workload):
    rc, res = cell.execute(workload, 2 ** 32 + 3, 0.5, False,
                           t_process=time.perf_counter(), device="cpu",
                           shape=(16, 16, 16))
    assert rc == 0
    return res


@pytest.fixture
def solver_cls():
    ft = import_program(manifest.ROOT)
    return ft.LSSolver


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    assert _run(workload)["correct"] is True


@pytest.mark.parametrize("workload", CELLS)
def test_a_step_that_returns_its_state_unchanged(workload, solver_cls,
                                                 monkeypatch):
    def unchanged(self, eps, r, p, w, denom, gamma, metric=True):
        return eps, r, p, gamma, gamma, None
    monkeypatch.setattr(solver_cls, "_cg_update", unchanged)
    res = _run(workload)
    assert res["correct"] is False


@pytest.mark.parametrize("workload", BATCHED)
def test_half_of_the_batch_left_out(workload, solver_cls, monkeypatch):
    run_batched = solver_cls.run_batched

    def half(self, Es, *a, **k):
        Es = np.asarray(Es)
        h = len(Es) // 2
        out = run_batched(self, Es[:h], *a, **k)
        rest = self.eps_batch
        self.eps_batch = torch.cat([rest] * len(Es))[:len(Es)]
        return out
    monkeypatch.setattr(solver_cls, "run_batched", half)
    res = _run(workload)
    assert res["correct"] is False


@pytest.mark.parametrize("workload", CELLS)
def test_an_answer_altered_where_it_is_produced(workload, solver_cls,
                                                monkeypatch):
    entry = manifest.cell(M, workload)[2]["entry"]
    original = getattr(solver_cls, entry)
    seen = []

    def altered(self, *a, **k):
        out = original(self, *a, **k)
        seen.append(1)
        if len(seen) == 2:          # the window's first request
            field = self.eps if entry == "run" else self.eps_batch
            field.mul_(1.0 + 1e-3)
        return out
    monkeypatch.setattr(solver_cls, entry, altered)
    res = _run(workload)
    assert res["correct"] is False
    assert res["check"]["stress_gap"]["value"] > \
        res["check"]["stress_gap"]["limit"]
