"""BENCHMARK.json and the files it names: a cell's configuration
(configs/<name>.json), its traffic mix (traffic/<name>.json) and the
readers of its per-layer metrics (metrics/<name>.py), found by name."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Callable, Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclasses.dataclass
class Cell:
    name: str
    config: Dict
    traffic: Dict
    chips: int
    end_to_end: List[Dict]     # the cell's end-to-end metric entries
    per_layer: List[Dict]      # the cell's per-layer metric entries


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> Dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def _in_cell(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: str = ROOT) -> Cell:
    """The cell `name` of BENCHMARK.json, its files read."""
    bench = benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"cells: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(root, configs[w["config"]]["file"]))
    for model in ("regressor", "classifier"):     # checkpoint paths
        config[model] = os.path.join(root, config[model])
    traffic = load_json(os.path.join(HERE, "traffic", w["traffic"] + ".json"))
    return Cell(name, config, traffic, int(w["chips"]),
                [m for m in bench["end_to_end"] if _in_cell(m, name)],
                [m for m in bench["per_layer"] if _in_cell(m, name)])


def reader(metric: str) -> Callable:
    """read(trace) of metrics/<metric>.py."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
