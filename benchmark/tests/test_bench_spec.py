"""Workload discovery: every cell of BENCHMARK.json resolves to its
files; a cell defined in another folder loads, and a deployment with a
front end and receiver settings of its own runs, with no file of the
benchmark edited; what a deployment's files name and the program or the
benchmark lacks is refused before any capture is made."""

import hashlib
import json
import os

import numpy as np
import pytest

from benchmark import gen, run, spec

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


#: a front end that exists only as a file outside the benchmark: the
#: committed complex baseband, twice as loud
GAINED_IQ = """
import os

from benchmark import spec

_base = spec.frontend("complex_baseband",
                      os.path.dirname(os.path.dirname(__file__)))
GAIN = 2.0
HOST_DTYPE = _base.HOST_DTYPE
to_baseband = None
units_per_epoch = _base.units_per_epoch
lag_s = _base.lag_s


def to_host(x, fe):
    return _base.to_host(x * GAIN, fe)
"""


def _tree_digest(folder):
    h = hashlib.sha256()
    for d, dirs, files in sorted(os.walk(folder)):
        dirs[:] = sorted(x for x in dirs if x != "__pycache__")
        for name in sorted(files):
            path = os.path.join(d, name)
            h.update(path.encode())
            with open(path, "rb") as f:
                h.update(f.read())
    return h.hexdigest()


def test_a_deployment_comes_in_as_files(tmp_path):
    """A front end and receiver settings written beside a cell of their
    own: it loads, makes its captures through the new module and runs a
    cold start on the CPU whose Receiver carries the setting."""
    before = _tree_digest(helpers.HERE)
    cfg = helpers.config()
    cfg["frontend"] = dict(cfg["frontend"], kind="gained_iq")
    cfg["receiver"] = dict(cfg["receiver"], acq={"noncoherent_epochs": 8})
    traffic = dict(helpers.COLDSTART, capture_epochs=300, warm_starts=0)
    cell = helpers.write_cell(str(tmp_path), traffic, cfg, name="gained",
                              frontends={"gained_iq": GAINED_IQ})
    assert cell.frontend.GAIN == 2.0
    seed = 2 ** 31 + 2027
    r = run.Run(cell, seed, "cpu")
    r.setup()
    base = gen.synthesize(r.scenes[0], cfg["frontend"], 300, seed * 7919,
                          "cpu", frontend=spec.frontend("complex_baseband"))
    np.testing.assert_array_equal(r.data[0], 2.0 * base)
    cs = r._coldstart()
    assert cs.rx.config.acq.noncoherent_epochs == 8
    assert cs.acq == 8
    ok, attempted, failed, rows = r.judge()
    assert ok and attempted == 1 and failed == 0, rows
    assert _tree_digest(helpers.HERE) == before


def _refused_cases():
    iq, wire = helpers.config(), helpers.config(wire=True)

    def rx(cfg, **kw):
        return dict(cfg, receiver=dict(cfg["receiver"], **kw))

    return {
        "unknown_frontend": (
            dict(iq, frontend=dict(iq["frontend"], kind="nope")),
            helpers.COLDSTART, KeyError,
            r"'nope'.*complex_baseband, wire_1bit"),
        "acq_field": (rx(iq, acq={"no_such_acq": 1}), helpers.COLDSTART,
                      TypeError, "no_such_acq"),
        "track_field": (rx(iq, track={"no_such_track": 1}),
                        helpers.COLDSTART, TypeError, "no_such_track"),
        "settings_field": (rx(iq, settings={"no_such_setting": 1}),
                           helpers.COLDSTART, TypeError, "no_such_setting"),
        "settings_fixed": (rx(iq, settings={"prns": [1]}), helpers.COLDSTART,
                           ValueError, "prns"),
        "codes_in_bit": (rx(iq, track={"codes_in_bit": 3}),
                         helpers.COLDSTART, ValueError, "codes_in_bit"),
        "host_on_wire": (wire, helpers.COLDSTART, ValueError,
                         "'wire_1bit' needs its to_baseband"),
        "wire_on_iq": (iq, helpers.WIRE_COLDSTART, ValueError,
                       "'complex_baseband' has none"),
    }


@pytest.mark.parametrize("case", sorted(_refused_cases()))
def test_refused_before_any_capture(tmp_path, monkeypatch, case):
    cfg, traffic, exc, match = _refused_cases()[case]
    made = []
    monkeypatch.setattr(gen, "synthesize",
                        lambda *a, **k: made.append(a))
    with pytest.raises(exc, match=match):
        cell = helpers.write_cell(str(tmp_path), traffic, cfg)
        run.Run(cell, 2 ** 31 + 11, "cpu").setup()
    assert made == []
