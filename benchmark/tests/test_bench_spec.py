"""Workload discovery: every cell of BENCHMARK.json resolves to its
files, and a cell defined in another folder loads with no file of the
benchmark edited."""

import json
import os

import pytest

from benchmark import spec

from . import helpers

ROOT = os.path.dirname(helpers.HERE)


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("cell", [w["name"] for w in _bench()["workloads"]])
def test_every_cell_resolves(cell):
    c = spec.load(cell, ROOT)
    assert c.config["name"] == c.workload["config"]
    assert c.traffic["kind"] in ("replay", "coldstart")
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert callable(spec.reader(m["name"]))
        assert m["moves"] in names


def test_every_metric_has_a_reader_that_reads_nothing_from_nothing():
    for m in _bench()["per_layer"]:
        assert spec.reader(m["name"])({"kind": "replay"}) is None


def test_a_cell_in_another_folder_loads(tmp_path):
    cell = helpers.write_cell(str(tmp_path), helpers.COLDSTART, name="new")
    assert cell.name == "new" and cell.traffic == helpers.COLDSTART
    assert [m["name"] for m in cell.end_to_end] == ["coldstart_p95_ms",
                                                    "setup_s"]
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "new.metric.py").write_text(
        "def read(ctx):\n    return ctx.get('x')\n")
    assert spec.reader("new.metric", str(tmp_path))({"x": 3.5}) == 3.5


def test_unknown_cell_raises(tmp_path):
    helpers.write_cell(str(tmp_path), helpers.COLDSTART)
    with pytest.raises(KeyError):
        spec.load("nope", str(tmp_path), str(tmp_path))
