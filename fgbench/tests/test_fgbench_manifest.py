"""BENCHMARK.json against the benchmark's contract, and every file it
names found where the harness looks for it."""
import json
import re

import pytest

from fgbench.harness import manifest, traffic

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")

M = manifest.load_manifest()


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 \
        and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert len((manifest.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51


def test_command_and_paths():
    assert 1 <= len(M["paths"]) <= 16
    for p in M["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    cmd = M["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    for w in cmd:
        assert not w.startswith("/") and ".." not in w
        if "/" in w:
            assert any(w.startswith(p + "/") for p in M["paths"])


@pytest.mark.parametrize("key", ["configs", "workloads", "end_to_end",
                                 "per_layer"])
def test_names_are_unique_and_allowed(key):
    names = [e["name"] for e in M[key]]
    assert len(set(names)) == len(names)
    assert all(NAME.match(n) for n in names)


def test_configs():
    used = {w["config"] for w in M["workloads"]}
    files = set()
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("fgbench/") and c["file"] not in files
        files.add(c["file"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        cfg = manifest.load_json(manifest.ROOT / c["file"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert manifest.plugin("reference", cfg["mode"]) is not None


def test_workloads():
    configs = {c["name"] for c in M["configs"]}
    pairs = set()
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        _, cfg, mix = manifest.cell(M, w["name"])
        traffic.check(mix)
    assert sum(w["chips"] == 4 for w in M["workloads"]) <= max(
        1, len(M["workloads"]) // 4)


def test_metrics():
    e2e = {m["name"] for m in M["end_to_end"]}
    assert "setup_s" in e2e
    cells = {w["name"] for w in M["workloads"]}
    for m in M["end_to_end"] + M["per_layer"]:
        keys = {"name", "unit", "better", "source"}
        if m in M["end_to_end"]:
            keys |= {"bound"}
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            keys |= {"layer", "moves"}
            assert _line(m["layer"]) and m["moves"] in e2e
            assert m["source"] in SOURCES
        assert set(m) - {"workloads"} == keys
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert manifest.plugin("metrics", m["name"]) is not None


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in M["workloads"]:
        e2e = {m["name"] for m in manifest.metrics_of(M, w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = manifest.metrics_of(M, w["name"], True)
        assert layers
        for m in layers:       # each reports the metric it moves
            assert m["moves"] in e2e


def test_roofline_shares_are_named_for_their_kernel():
    for m in M["per_layer"]:
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"


def test_files_under_paths_are_named_from_name_characters():
    for f in (manifest.ROOT / "fgbench").rglob("*"):
        if "__pycache__" in f.parts or f.is_dir():
            continue
        rel = f.relative_to(manifest.ROOT).as_posix()
        assert PATH.match(rel), rel


def test_manifest_is_valid_json_with_no_duplicate_keys():
    def hook(pairs):
        keys = [k for k, _ in pairs]
        assert len(keys) == len(set(keys))
        return dict(pairs)
    json.loads((manifest.ROOT / "BENCHMARK.json").read_text(),
               object_pairs_hook=hook)
