"""A configuration, a traffic mix, a per-layer metric and a byte count,
and a deployment with its own geometry, mixing rule, load cases and
reference, added as new files plus manifest entries, without editing a
file that is there: a copy of the checkout gains a throwaway of each, and
a run there reports the new cell and metric, judged by the reference the
configuration names."""
import json
import shutil

from _cpu import ROOT, heat_config, run_cpu


def test_new_files_and_entries_are_enough(tmp_path):
    ignore = shutil.ignore_patterns("__pycache__", "_build")
    for d in ("fgbench", "fibergen_tpu_torch"):
        shutil.copytree(ROOT / d, tmp_path / d, ignore=ignore)
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "fgbench").rglob("*") if p.is_file()}
    man = json.loads((ROOT / "BENCHMARK.json").read_text())

    cfg = heat_config()
    cfg.update(name="tiny-heat", grid=[12, 10, 8],
               inclusion={"shape": "sphere", "radius": 0.25})
    (tmp_path / "fgbench/configs/tiny-heat.json").write_text(
        json.dumps(cfg))
    (tmp_path / "fgbench/traffic/two-cases.json").write_text(json.dumps({
        "name": "two-cases", "loop": "closed", "clients": 1,
        "entry": "run_batched", "load_cases": "unit",
        "cases_per_request": 2, "order": "cycle", "start": "seed"}))
    (tmp_path / "fgbench/metrics/cases_per_request.py").write_text(
        "def read(run):\n"
        "    return run.cases_done / len(run.requests)\n")
    (tmp_path / "fgbench/counts/throwaway_chain.py").write_text(
        "def bytes_moved(app):\n"
        "    return 4 * app['voxels'] * app['itemsize']\n")
    man["configs"].append({"name": "tiny-heat", "source": "a test",
                           "file": "fgbench/configs/tiny-heat.json",
                           "reduced": [], "why": "a throwaway"})
    man["workloads"].append({"name": "tiny-heat.two", "config": "tiny-heat",
                             "traffic": "two-cases", "chips": 1,
                             "why": "a throwaway"})
    man["per_layer"].append({"name": "cases_per_request", "unit": "cases",
                             "better": "higher", "source": "host_clock",
                             "layer": "Harness", "moves": "case_s",
                             "workloads": ["tiny-heat.two"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))

    after = {p.relative_to(tmp_path): p.read_bytes()
             for p in (tmp_path / "fgbench").rglob("*") if p.is_file()}
    assert all(after[k] == v for k, v in before.items())   # none edited

    rc, res, _, _ = run_cpu("tiny-heat.two", trace=True, n=None,
                            root=tmp_path)
    assert rc == 0 and res["correct"] is True
    assert res["metrics"]["cases_per_request"]["value"] == 2.0
    rc, res, _, _ = run_cpu("tiny-heat.two", trace=False, n=None,
                            root=tmp_path)
    assert res["attempted"] % 2 == 0 and "case_s" in res["metrics"]

    import sys
    sys.path.insert(0, str(tmp_path))
    try:
        from fgbench.harness import manifest
        count = manifest.plugin("counts", "throwaway_chain", tmp_path)
        assert count.bytes_moved({"voxels": 10, "itemsize": 4}) == 160
    finally:
        sys.path.remove(str(tmp_path))


SLAB = '''"""A slab across x, its faces smoothed over two voxels (fractional
phase values there), centred on a voxel drawn from the seed."""
import torch


def draw(config, rng, shape):
    return int(rng.integers(0, shape[0]))


def fields(config, drawn, shape, device, dtype=torch.float32):
    n = shape[0]
    x = torch.arange(n, dtype=torch.float64, device=device)
    d = torch.remainder(x - drawn + n / 2, n) - n / 2
    half = 0.5 * float(config["inclusion"]["width"]) * n
    phi = torch.clamp(0.5 + (half - d.abs()) / 2, 0.0, 1.0)
    return phi.to(dtype)[:, None, None].expand(shape).contiguous()
'''

REUSS = '''"""The Reuss rule over isotropic phases."""


def build(ft, config, geom, dim):
    return ft.ReussMixed(
        [ft.Phase(p["name"], ft.LinearIsotropic(mu=p["mu"], lam=p["lam"]),
                  geom if p["region"] == "inside" else 1.0 - geom)
         for p in config["phases"]], dim=dim)
'''

REUSS_REFERENCE = '''"""Staggered elasticity with the moduli mixed by
the Reuss rule: per voxel the harmonic means of 2 mu and 3 lam + 2 mu."""
import torch

from fgbench.reference import _plain as pl
from fgbench.reference import elasticity as el

DIM = 6


def moduli(config, geom, work):
    phi = geom.to(work)
    inv_m = inv_k = 0.0
    for ph in config["phases"]:
        f = phi if ph["region"] == "inside" else 1.0 - phi
        inv_m = inv_m + f / (2.0 * ph["mu"])
        inv_k = inv_k + f / (3.0 * ph["lam"] + 2.0 * ph["mu"])
    return 0.5 / inv_m, (1.0 / inv_k - 1.0 / inv_m) / 3.0


def solve(config, geom, load, *, tol=1e-10, maxiter=1000,
          store=torch.float64):
    work = pl.work_dtype(store)
    q = pl.rounder(store, work)
    shape = tuple(geom.shape)
    cell = config.get("cell", (1.0, 1.0, 1.0))
    h = pl.inv_h(shape, cell)
    mu, lam = (q(m) for m in moduli(config, geom, work))
    E = torch.as_tensor(load, dtype=work, device=geom.device)
    zero = torch.zeros(DIM, dtype=work, device=geom.device)
    mu0 = pl.contrast_mean(config, "mu")
    lam0 = pl.contrast_mean(config, "lam")
    c = (mu0 + lam0) / (2.0 * mu0 + lam0)
    qs, q2 = pl.wavenumbers(shape, cell, geom.device, work)

    def apply_a(u):
        return -el.div(el.stress(el.strain(u, zero, h), mu, lam), h)

    def precond(r):
        rh = pl.spectrum(r, shape)
        qr = sum(qa * rh[a] for a, qa in enumerate(qs))
        uh = torch.stack([(rh[a] - c * torch.conj(qa) * qr / q2) / (mu0 * q2)
                          for a, qa in enumerate(qs)])
        uh[:, 0, 0, 0] = 0.0
        return pl.real(uh, shape).to(work)

    b = q(el.div(el.stress(E.reshape(-1, 1, 1, 1).expand((DIM,) + shape),
                           mu, lam), h))
    u, it, rel = pl.pcg(apply_a, precond, b, q, tol, maxiter)
    eps = q(el.strain(u, E, h))
    mean = el.stress(eps, mu, lam).mean(dim=(1, 2, 3)).to(torch.float64)
    return pl.Solution(eps, mean, it, rel)
'''

VOIGT_ANYWAY = '''"""The elasticity reference, which mixes by the Voigt
rule, run on a configuration whatever rule it names."""
from fgbench.reference import elasticity

DIM = elasticity.DIM


def solve(config, geom, load, **kw):
    return elasticity.solve(dict(config, mixing="voigt"), geom, load, **kw)
'''

NORMAL = '''"""The three normal strains."""
import numpy as np


def cases(config, dim):
    return np.eye(dim)[:3]
'''


def test_a_deployment_of_its_own_is_new_files(tmp_path):
    """A geometry with fractional voxels, the Reuss rule, a reference that
    mixes the same way and the three normal strains, as new files: the
    cell runs correct.  The same configuration checked by the mode's
    reference (the Voigt rule: it refuses the configuration) or by the
    Voigt reference run on it anyway comes out not correct."""
    ignore = shutil.ignore_patterns("__pycache__", "_build")
    for d in ("fgbench", "fibergen_tpu_torch"):
        shutil.copytree(ROOT / d, tmp_path / d, ignore=ignore)
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "fgbench").rglob("*") if p.is_file()}
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    files = {"geometry/slab.py": SLAB, "mixing/reuss.py": REUSS,
             "reference/reuss-elasticity.py": REUSS_REFERENCE,
             "reference/voigt-anyway.py": VOIGT_ANYWAY,
             "loads/normal.py": NORMAL}
    for name, text in files.items():
        (tmp_path / "fgbench" / name).write_text(text)
    (tmp_path / "fgbench/traffic/normal.json").write_text(json.dumps({
        "name": "normal", "loop": "closed", "clients": 1,
        "entry": "run_batched", "load_cases": "normal",
        "cases_per_request": "all", "order": "cycle", "start": "first"}))
    base = json.loads((ROOT / "fgbench/configs/sphere-elastic-256.json")
                      .read_text())
    base.update(grid=[16, 16, 16], mixing="reuss",
                inclusion={"shape": "slab", "width": 0.4})
    for name, ref in (("slab-reuss", "reuss-elasticity"),
                      ("slab-reuss-by-mode", None),
                      ("slab-reuss-voigt", "voigt-anyway")):
        cfg = dict(base, name=name)
        if ref:
            cfg["reference"] = ref
        (tmp_path / f"fgbench/configs/{name}.json").write_text(
            json.dumps(cfg))
        man["configs"].append({"name": name, "source": "a test",
                               "file": f"fgbench/configs/{name}.json",
                               "reduced": [], "why": "a throwaway"})
        man["workloads"].append({"name": name, "config": name,
                                 "traffic": "normal", "chips": 1,
                                 "why": "a throwaway"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    after = {p.relative_to(tmp_path): p.read_bytes()
             for p in (tmp_path / "fgbench").rglob("*") if p.is_file()}
    assert all(after[k] == v for k, v in before.items())   # none edited

    rc, res, _, _ = run_cpu("slab-reuss", root=tmp_path)
    assert rc == 0 and res["correct"] is True and res["failed"] == 0
    assert res["attempted"] % 3 == 0
    assert res["check"]["field_gap"]["value"] < \
        res["check"]["field_gap"]["limit"] / 10

    rc, res, _, err = run_cpu("slab-reuss-by-mode", root=tmp_path)
    assert rc == 0 and res["correct"] is False
    assert "refuses the configuration" in err

    rc, res, _, _ = run_cpu("slab-reuss-voigt", root=tmp_path)
    assert rc == 0 and res["correct"] is False
    assert res["check"]["stress_gap"]["value"] > \
        10 * res["check"]["stress_gap"]["limit"]
