"""The modules a run loads: nothing of JAX or the JAX package, by whole
top-level names."""
import pytest

from _cpu import run_cpu
from fgbench.harness import imports, manifest

M = manifest.load_manifest()


def test_whole_top_level_names_are_compared():
    assert imports.forbidden_loaded(["fibergen_tpu_torch",
                                     "fibergen_tpu_torch.ops"]) == []
    assert imports.forbidden_loaded(["fibergen_tpu.ops"]) == ["fibergen_tpu"]
    assert imports.forbidden_loaded(["jaxlib.xla", "flax", "jaxtyping"]) \
        == ["flax", "jaxlib"]


@pytest.mark.parametrize("workload", [w["name"] for w in M["workloads"]])
def test_a_run_loads_no_forbidden_module(workload):
    rc, res, modules, _ = run_cpu(workload, seconds=0.3)
    assert rc == 0 and "fibergen_tpu_torch" in modules
    assert not imports.forbidden_loaded(modules)
