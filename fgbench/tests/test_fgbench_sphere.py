"""The sphere's geometry file draws and makes what the harness made before
the geometry became a file of its own: the same translation, the same
float32 and float64 fields and the same order of requests for a seed.  The
oracle below is that earlier formula, kept here as it was."""
import itertools

import numpy as np
import pytest
import torch

from fgbench.harness import manifest, problem, traffic

M = manifest.load_manifest()
SEEDS = (2 ** 31 + 7, 2 ** 33 + 5, 3000000017)
SHAPE = (16, 16, 16)


def oracle_shift(rng, shape):
    return tuple(int(rng.integers(0, n)) for n in shape)


def oracle_field(radius, shift, shape, dtype):
    r2 = float(radius) ** 2
    a2 = [((torch.arange(n, dtype=torch.float64) + 0.5) / n - 0.5) ** 2
          for n in shape]
    inside = (a2[0][:, None, None] + a2[1][None, :, None]
              + a2[2][None, None, :]) < r2
    return torch.roll(inside.to(dtype), shifts=tuple(shift), dims=(0, 1, 2))


@pytest.mark.parametrize("workload", [w["name"] for w in M["workloads"]])
@pytest.mark.parametrize("seed", SEEDS)
def test_the_sphere_moved_bit_for_bit(workload, seed):
    _, cfg, mix = manifest.cell(M, workload)
    assert cfg["inclusion"]["shape"] == "sphere"
    sphere = manifest.plugin("geometry", "sphere")
    rng, old = problem.rng_of(seed), np.random.default_rng(seed % 2 ** 64)
    drawn, shift = problem.draw(cfg, rng, SHAPE), oracle_shift(old, SHAPE)
    assert drawn == shift == sphere.draw(cfg, problem.rng_of(seed), SHAPE)
    for dtype in (torch.float32, torch.float64):
        new = sphere.fields(cfg, drawn, SHAPE, "cpu", dtype)
        ref = oracle_field(cfg["inclusion"]["radius"], shift, SHAPE, dtype)
        assert new.dtype == dtype and torch.equal(new, ref)
        assert torch.equal(problem.fields(cfg, drawn, SHAPE, "cpu", dtype),
                           ref)
    n = len(problem.load_cases(cfg, mix))
    assert n == 6
    assert list(itertools.islice(traffic.requests(mix, n, rng), 8)) == \
        list(itertools.islice(traffic.requests(mix, n, old), 8))
