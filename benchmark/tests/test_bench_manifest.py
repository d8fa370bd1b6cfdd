"""BENCHMARK.json against the benchmark's contract: names, units, keys,
and every cell's files found by name."""

import json
import re

import pytest

import bench_tiny  # noqa: F401  (puts the benchmark on sys.path)
from harness import manifest

ROOT = manifest.ROOT
M = manifest.load_manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_keys_and_size():
    assert set(M) == TOP_KEYS
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= M["run_seconds"] <= 51 and isinstance(M["run_seconds"], int)


def test_command_and_paths():
    assert 1 <= len(M["command"]) <= 32
    for word in M["command"]:
        assert LINE.match(word) and not word.startswith("/") and ".." not in word.split("/")
    assert 1 <= len(M["paths"]) <= 16
    for p in M["paths"]:
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", p) and (ROOT / p).is_dir()
    for word in M["command"][1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in M["paths"])


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_unique_and_well_formed(section):
    names = [e["name"] for e in M[section]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n


def test_metric_names_unique_across_sections():
    names = [m["name"] for m in M["end_to_end"] + M["per_layer"]]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("metric", M["end_to_end"] + M["per_layer"], ids=lambda m: m["name"])
def test_metric_entry(metric):
    allowed = {"name", "unit", "better", "source", "workloads"}
    allowed |= {"bound"} if metric in M["end_to_end"] else {"layer", "moves"}
    assert set(metric) <= allowed and allowed - {"workloads"} <= set(metric)
    assert UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
    cells = {w["name"] for w in M["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if metric in M["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert LINE.match(metric["layer"])
        moved = {m["name"]: m for m in M["end_to_end"]}[metric["moves"]]
        assert set(metric["workloads"]) <= set(moved.get("workloads", cells))
        assert manifest.metric_path(metric["name"]).is_file()
        assert callable(manifest.load_reader(metric["name"]))


def test_setup_bound():
    setup = {m["name"]: m for m in M["end_to_end"]}["setup_s"]
    assert setup["bound"] <= 0.25 and "workloads" not in setup


@pytest.mark.parametrize("cell", M["workloads"], ids=lambda w: w["name"])
def test_cell_files_found_by_name(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] in (1, 4) and LINE.match(cell["why"])
    c = manifest.Cell(M, cell["name"])
    assert c.kind in ("train", "view")
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    assert set(c.limits["numbers"]) and all("limit" in v for v in c.limits["numbers"].values())


def test_pairs_and_four_chip_share():
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in M["workloads"]) <= max(1, len(pairs) // 4)


@pytest.mark.parametrize("config", M["configs"], ids=lambda c: c["name"])
def test_config_entry(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert config["file"].startswith("benchmark/") and (ROOT / config["file"]).is_file()
    assert any(w["config"] == config["name"] for w in M["workloads"])
    body = json.loads((ROOT / config["file"]).read_text())
    assert body["name"] == config["name"] and body["reduced"] == config["reduced"]
    assert len(config["reduced"]) <= 16 and LINE.match(config["source"])
    files = [c["file"] for c in M["configs"]]
    assert len(files) == len(set(files))


@pytest.mark.parametrize("path", sorted((manifest.BENCH_DIR / "configs").glob("*.json")),
                         ids=lambda p: p.stem)
def test_config_family_and_rig_resolve_to_files(path):
    config = json.loads(path.read_text())
    files = manifest.config_files(config)
    assert files and all(p.is_file() for p in files.values()), files
    assert manifest.family_path(manifest.family_of(config)) in files.values()
