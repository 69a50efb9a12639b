"""BENCHMARK.json against the contract's character rules, and every cell,
configuration, mode and metric file found by its name."""

from __future__ import annotations

import json
import re
import tomllib
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
HERE = ROOT / "retrieval_bench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["retrieval_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names_and_units(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in entry.get("reduced", []):
        assert NAME.match(key)
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] and "\t" not in entry[key]


def test_names_unique():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda e: e["name"])
def test_cell_files_found_by_name(cell):
    spec = tomllib.loads((HERE / "workloads" / f"{cell['name']}.toml").read_text())
    assert spec["config"] == cell["config"]
    assert spec["traffic"]["name"] == cell["traffic"]
    assert spec["chips"] == cell["chips"] == 1
    assert spec["why"] == cell["why"]
    assert (HERE / "drivers" / f"{spec['mode']}.py").is_file()
    assert (HERE / "configs" / f"{spec['config']}.toml").is_file()


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda e: e["name"])
def test_config_files(config):
    assert config["file"] == f"retrieval_bench/configs/{config['name']}.toml"
    spec = tomllib.loads((ROOT / config["file"]).read_text())
    assert spec["name"] == config["name"] and spec["source"] == config["source"]
    assert spec["reduced"] == config["reduced"]
    assert spec["assumed"]
    assert spec["tpu"]["mesh_shape"] == 1 and spec["tpu"]["precision"] == "float32"
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("folder,group", [("workloads", "workloads"), ("configs", "configs"),
                                          ("metrics", "metrics")])
def test_every_file_is_listed(folder, group):
    """A cell, configuration or metric file exists only with its entry."""
    listed = {e["name"] for e in (METRICS if group == "metrics" else BENCH[group])}
    found = {p.stem for p in (HERE / folder).iterdir()
             if p.suffix in (".toml", ".py") and p.stem != "__init__"}
    assert found == listed


@pytest.mark.parametrize("metric", METRICS, ids=lambda e: e["name"])
def test_metric_readers_found_by_name(metric):
    from retrieval_bench.harness import load_file

    mod = load_file(HERE / "metrics" / f"{metric['name']}.py", f"m_{metric['name']}")
    assert callable(mod.read)
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if metric in BENCH["per_layer"]:
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        moved = next(m for m in BENCH["end_to_end"] if m["name"] == metric["moves"])
        assert set(metric["workloads"]) <= set(moved.get("workloads", cells))
    else:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0 < metric["bound"] <= 0.25


def test_every_cell_reports_enough():
    for cell in BENCH["workloads"]:
        name = cell["name"]
        e2e = [m["name"] for m in BENCH["end_to_end"] if name in m.get("workloads", [name])]
        per = [m["name"] for m in BENCH["per_layer"] if name in m.get("workloads", [name])]
        assert "setup_s" in e2e and len(e2e) >= 2 and per


def test_roofline_and_mfu_names():
    names = {m["name"]: m for m in BENCH["per_layer"]}
    assert names["ncc_roofline"]["unit"] == "%"
    assert "mfu" in names["mfu_pct"]["name"].split("_")
