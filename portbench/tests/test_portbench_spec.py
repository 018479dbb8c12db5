"""BENCHMARK.json and the files it names: every cell's configuration and
traffic mix load, every metric has its reader, names and units keep to
their characters."""

import json
import os
import re

import pytest

from portbench import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load(cell):
    c = spec.cell(cell)
    configs = {x["name"] for x in BENCH["configs"]}
    w = next(x for x in BENCH["workloads"] if x["name"] == cell)
    assert w["config"] in configs
    assert c.config["name"] == w["config"]
    assert c.traffic["name"] == w["traffic"]
    for model in ("regressor", "classifier"):
        for ext in (".ckpt", ".json"):
            assert os.path.exists(c.config[model] + ext)
    assert {m["name"] for m in c.end_to_end} >= {"setup_s", "edges_per_s"}
    assert c.per_layer


def test_configs_are_used_and_files_distinct():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/")
        assert set(c) == {"name", "source", "file", "reduced", "why"}


def test_names_and_units():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    names += [w[k] for w in BENCH["workloads"] for k in ("config", "traffic")]
    assert all(NAME.match(n) for n in names), names
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")


def test_per_layer_metrics_have_readers():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
        assert callable(spec.reader(m["name"]))


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_traffic_files_hold_the_generator_keys():
    keys = {"lanes", "lxd", "G", "R", "span", "spans", "c_threshold",
            "r_threshold", "check_lane_spans", "check_spans", "ring",
            "grain_spacing"}
    for w in BENCH["workloads"]:
        with open(os.path.join(spec.HERE, "traffic",
                               w["traffic"] + ".json")) as f:
            assert keys <= set(json.load(f))
