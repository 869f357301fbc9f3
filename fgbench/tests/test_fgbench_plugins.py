"""A configuration, a traffic mix, a per-layer metric and a byte count
added as new files plus manifest entries, without editing a file that is
there: a copy of the checkout gains a throwaway of each, and a run there
reports the new cell and metric."""
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
