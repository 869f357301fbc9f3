"""Run a cell of the harness on the CPU at a small size, in a fresh
interpreter, and read what it printed."""
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def heat_config() -> dict:
    """The elasticity configuration's sphere in heat conduction (10 in 1),
    for the tests of the heat reference and of a configuration added as a
    file: no cell of ``BENCHMARK.json`` runs heat."""
    cfg = json.loads((ROOT / "fgbench/configs/sphere-elastic-256.json")
                     .read_text())
    cfg.update(name="sphere-heat", mode="heat",
               solver=dict(cfg["solver"], mode="heat"),
               phases=[{"name": "fiber", "region": "inside", "law": "scalar",
                        "mu": 10.0},
                       {"name": "matrix", "region": "outside",
                        "law": "scalar", "mu": 1.0}])
    return cfg

SCRIPT = """
import json, sys, time
t = time.perf_counter()
sys.path.insert(0, {root!r})
from fgbench.harness import cell, imports
rc, res = cell.execute({workload!r}, {seed!r}, {seconds!r}, {trace!r},
                       t_process=t, device="cpu", shape={shape!r},
                       root=__import__("pathlib").Path({root!r}))
sys.stderr.flush()
print(json.dumps({{"rc": rc, "result": res,
                  "modules": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


def run_cpu(workload, seed=2 ** 31 + 7, seconds=1.0, trace=False, n=16,
            root=ROOT, timeout=600):
    """(rc, result, top-level modules loaded, stderr) of one CPU run."""
    shape = None if n is None else (n, n, n)
    code = SCRIPT.format(root=str(root), workload=workload, seed=seed,
                         seconds=seconds, trace=trace, shape=shape)
    p = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=timeout)
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    return out["rc"], out["result"], out["modules"], p.stderr
