"""BENCHMARK.json against the contract, and every piece a cell names
found by name."""

import json
import re
from pathlib import Path

import pytest

from benchmark import faults, run

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metric_entry(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    if m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
    for w in m.get("workloads", []):
        assert w in CELLS


@pytest.mark.parametrize("cell", CELLS)
def test_cell_found_by_name(cell):
    w, config, mix = run.cell(BENCH, cell)
    assert w["chips"] == 1 and len(w["why"]) <= 200
    assert {"mode", "receiver", "checks", "assumed"} <= set(config)
    drv = run.driver(mix)
    assert callable(drv.run) and mix["driver"] in faults.FAULTS
    e2e = [m["name"] for m in run.end_to_end(BENCH, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = run.per_layer(BENCH, cell)
    assert layer
    for m in layer:
        assert m["moves"] in e2e


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_reader_found_by_name(m):
    read = run.reader(m["name"])
    assert read(None, {"kind": "none"}) is None


def test_configs_are_used_and_files_under_paths():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert c["file"].startswith("benchmark/")
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) \
        == len(CELLS)
