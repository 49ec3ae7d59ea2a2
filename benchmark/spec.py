"""What a cell is, found by name in ``BENCHMARK.json``: its workload
entry, its configuration file, its traffic file, the module of its
front end and the readers of its metrics.  Adding a cell, a
configuration, a traffic mix, a front end, receiver settings or a
per-layer metric adds files and entries and edits none:

* a configuration is the JSON file its entry names;
* a traffic mix is ``traffic/<traffic>.json`` beside this file;
* a front end is ``frontends/<kind>.py`` beside this file, one for each
  value of a configuration's ``frontend.kind``: ``units_per_epoch(fe)``
  (host elements a millisecond), ``HOST_DTYPE``, ``to_host(x, fe)`` (the
  generator's noisy samples of a chunk in the host form, on the device),
  ``lag_s(fe)`` (epoch start to the centre of the first baseband sample)
  and ``to_baseband(host_slice, device)`` (the program's ingest to
  2.046 MHz complex baseband on the device, imported from the program
  inside the function; None where the host form is the receiver's
  input);
* receiver settings are the configuration's ``receiver.acq``,
  ``receiver.track`` and ``receiver.settings`` objects, fields of the
  program's ``AcqConfig``, ``TrackConfig`` and ``ReceiverConfig``
  (``jobs.receiver_config``);
* a per-layer metric is ``metrics/<name>.py`` beside this file, whose
  ``read(ctx)`` returns the value or None where the run gives it nothing
  to read.

Two things still take an edit, and belong to a benchmark change: a
traffic ``kind`` other than ``coldstart`` and ``replay`` (``run.Run``
and ``jobs``), and a new end-to-end metric (``run.Run.end_to_end``).
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from types import ModuleType

HERE = os.path.dirname(os.path.abspath(__file__))

#: what every front-end module gives
FRONTEND_API = ("units_per_epoch", "HOST_DTYPE", "to_host", "lag_s",
                "to_baseband")


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    end_to_end: list      # metric entries the cell reports with --trace 0
    per_layer: list       # ... with --trace 1
    chips: int
    frontend: ModuleType  # frontends/<config's frontend.kind>.py


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(cell: str, root: str, bench_dir: str = HERE) -> Cell:
    """The cell ``cell`` of ``root``/BENCHMARK.json; configuration files
    are relative to ``root``, traffic files and front ends to
    ``bench_dir``."""
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
    fe = frontend(config["frontend"]["kind"], bench_dir)
    return Cell(name=cell, workload=wl, config=config, traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, cell)],
                per_layer=[m for m in bench["per_layer"]
                           if _reports(m, cell)],
                chips=int(wl["chips"]), frontend=fe)


def _module(name: str, path: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def frontend(kind: str, bench_dir: str = HERE) -> ModuleType:
    """The module ``frontends/<kind>.py``.  An unknown kind raises,
    naming the kinds found; there is no fallback."""
    folder = os.path.join(bench_dir, "frontends")
    path = os.path.join(folder, kind + ".py")
    if not os.path.isfile(path):
        found = sorted(f[:-3] for f in os.listdir(folder)
                       if f.endswith(".py")) if os.path.isdir(folder) else []
        raise KeyError(f"no front end {kind!r} in {folder}; found: "
                       f"{', '.join(found) or 'none'}")
    mod = _module("benchmark.frontends." + kind, path)
    missing = [a for a in FRONTEND_API if not hasattr(mod, a)]
    if missing:
        raise AttributeError(f"front end {kind!r} lacks {', '.join(missing)}")
    return mod


def reader(metric: str, bench_dir: str = HERE):
    """``read`` of ``metrics/<metric>.py``."""
    path = os.path.join(bench_dir, "metrics", metric + ".py")
    return _module("benchmark.metrics." + metric.replace(".", "_"),
                   path).read
