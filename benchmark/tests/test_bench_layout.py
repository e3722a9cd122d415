"""The benchmark's files: every cell, configuration, traffic mix, traffic
kind and per-layer metric is found by its name, and BENCHMARK.json keeps
to the benchmark's contract (keys, names, units, bounds, paths)."""

import json
import os
import re

import pytest

from benchmark import harness
from benchmark.tests import tiny

BENCH = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))
HELD = harness.read_json(os.path.join(harness.BENCH, "held_back.json"))
WITH_HELD = tiny.bench()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = len(BENCH["workloads"])
    spare = 43200 - 1200 - 24 * 2 * 90
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) <= spare
    assert 1 <= cells <= 24


@pytest.mark.parametrize("cell", CELLS + [w["name"]
                                          for w in HELD["workloads"]])
def test_cell_files_found_by_name(cell):
    c = harness.load_cell(cell, WITH_HELD)
    assert c.entry["chips"] in (1, 4)
    assert c.traffic["kind"] in ("clips", "train")
    kind = harness.load_module("traffic", c.traffic["kind"])
    assert callable(kind.run) and callable(kind.control)
    assert c.limits["compared"], "a cell compares at least one number"
    assert any(m["name"] == "setup_s" for m in c.end_to_end)
    assert len(c.end_to_end) >= 2 and c.per_layer


@pytest.mark.parametrize("metric", [m["name"]
                                    for m in WITH_HELD["per_layer"]])
def test_metric_reader_found_by_name(metric):
    mod = harness.load_module("metrics", metric)
    assert callable(mod.read)
    assert mod.read({"requests": [], "steps": []}) is None


def test_names_units_and_bounds():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(set(names)) == len(names)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for w in m.get("workloads", []):
            assert w in CELLS
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and "\n" not in m["layer"]
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


def test_configs_and_cells():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        body = json.load(open(os.path.join(harness.ROOT, c["file"])))
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"]
        assert len(c["why"]) <= 200 and len(c["source"]) <= 200
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and NAME.match(w["traffic"])
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        used = [m for m in BENCH["end_to_end"]
                if "workloads" not in m or w["name"] in m["workloads"]]
        assert len(used) >= 2
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_held_back_cells_stay_out():
    """A held-back cell, and every metric that only it reports, is absent
    from BENCHMARK.json; its entries keep BENCHMARK.json's form."""
    held = {w["name"] for w in HELD["workloads"]}
    assert held and not held & set(CELLS)
    names = {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    e2e = {m["name"] for m in WITH_HELD["end_to_end"]}
    for m in HELD["end_to_end"] + HELD["per_layer"]:
        assert m["name"] not in names and set(m["workloads"]) <= held
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m.get("moves", m["name"]) in e2e
    for w in HELD["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200
