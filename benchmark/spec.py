"""What a cell is, found by name in ``BENCHMARK.json``: its workload
entry, its configuration file, its traffic file and the readers of its
metrics.  Adding a cell, a configuration, a traffic mix or a per-layer
metric adds files and entries and edits none:

* a configuration is the JSON file its entry names;
* a traffic mix is ``traffic/<traffic>.json`` beside this file;
* a per-layer metric is ``metrics/<name>.py`` beside this file, whose
  ``read(ctx)`` returns the value or None where the run gives it nothing
  to read.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

HERE = os.path.dirname(os.path.abspath(__file__))


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    end_to_end: list      # metric entries the cell reports with --trace 0
    per_layer: list       # ... with --trace 1
    chips: int


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(cell: str, root: str, bench_dir: str = HERE) -> Cell:
    """The cell ``cell`` of ``root``/BENCHMARK.json; configuration files
    are relative to ``root``, traffic files to ``bench_dir``."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    wl = {w["name"]: w for w in bench["workloads"]}.get(cell)
    if wl is None:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json")
    entry = {c["name"]: c for c in bench["configs"]}[wl["config"]]
    with open(os.path.join(root, entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(bench_dir, "traffic",
                           wl["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return Cell(name=cell, workload=wl, config=config, traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, cell)],
                per_layer=[m for m in bench["per_layer"]
                           if _reports(m, cell)],
                chips=int(wl["chips"]))


def reader(metric: str, bench_dir: str = HERE):
    """``read`` of ``metrics/<metric>.py``."""
    path = os.path.join(bench_dir, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
