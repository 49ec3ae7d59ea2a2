"""Small cells for the CPU tests, written into a temporary folder: the
firmware's four-satellite sky, at complex baseband or on the wire, so a
job runs on the CPU in about a minute."""

from __future__ import annotations

import json
import os
import shutil

from benchmark import spec

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def config(wire: bool = False, **limits) -> dict:
    """The firmware's configuration as committed, its wire front end
    or (``wire=False``) complex baseband at 2.046 MHz."""
    with open(os.path.join(HERE, "configs", "fw_max2769_4sat.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "t4"
    if not wire:
        cfg["frontend"] = {"kind": "complex_baseband", "complex": True,
                           "sample_rate_hz": 2046000.0, "if_hz": 0.0}
    cfg["limits"] = dict(cfg["limits"], **limits)
    return cfg


#: a replay job that is due two fixes (the fourth satellite's subframe 3
#: ends at 25.3 s; the ticks at 27.0 and 28.0 s are due), and cold starts
REPLAY = {"kind": "replay", "ingest": "host", "job_epochs": 28010,
          "capture_epochs": 28010, "captures": 1, "block_epochs": 1000,
          "warm_jobs": 0, "trace_jobs": 1}
COLDSTART = {"kind": "coldstart", "capture_epochs": 1500, "captures": 1,
             "window_epochs": 266, "warm_starts": 1, "trace_starts": 2}
WIRE_COLDSTART = dict(COLDSTART, ingest="wire")


def write_cell(root: str, traffic: dict, cfg: dict = None,
               name: str = "t", frontends: dict = None) -> spec.Cell:
    """A BENCHMARK.json with one cell ``name`` in ``root``, beside a copy
    of the benchmark's front ends and the modules ``frontends`` gives
    (kind: source)."""
    os.makedirs(os.path.join(root, "traffic"), exist_ok=True)
    shutil.copytree(os.path.join(HERE, "frontends"),
                    os.path.join(root, "frontends"), dirs_exist_ok=True,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for kind, source in (frontends or {}).items():
        with open(os.path.join(root, "frontends", kind + ".py"), "w") as f:
            f.write(source)
    with open(os.path.join(root, "t4.json"), "w") as f:
        json.dump(cfg or config(), f)
    with open(os.path.join(root, "traffic", name + ".json"), "w") as f:
        json.dump(traffic, f)
    e2e = "coldstart_p95_ms" if traffic["kind"] == "coldstart" else "rt_x"
    bench = {"configs": [{"name": "t4", "file": "t4.json"}],
             "workloads": [{"name": name, "config": "t4", "traffic": name,
                            "chips": 1}],
             "end_to_end": [{"name": e2e, "unit": "x"},
                            {"name": "setup_s", "unit": "s"}],
             "per_layer": []}
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return spec.load(name, root, root)
