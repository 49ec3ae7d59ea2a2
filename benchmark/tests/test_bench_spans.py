"""The readers of the program's spans and counters, and the trace's
labels for them.

On a short CPU run of the wire cold-start cell the six readers of the
span log return numbers and the two of the device trace None (no trace
on the CPU); on synthetic records and a synthetic trace each reader
returns what its docstring says; where the program keeps no span log
every one returns None.  ``trace.summarize`` labels a gap inside a
``user_annotation`` span with the span's name and does not count a
``gpu_user_annotation`` as busy."""

import tempfile

import pytest

from benchmark import run, spec
from benchmark.trace import summarize
from stm32f4_sdr_gps_torch.utils import profiling
from stm32f4_sdr_gps_torch.utils.profiling import Span

from . import helpers

SPAN_READERS = ("pretrack_doppler_ms", "pretrack_code_ms", "handoff_ms",
                "condition_host_ms", "readbacks_per_start",
                "uploads_per_start")
TRACE_READERS = ("launches_per_start", "idle_pct.coldstart.python")


@pytest.fixture
def empty_log(monkeypatch):
    monkeypatch.setattr(profiling, "spans", type(profiling.spans)(
        maxlen=profiling.SPAN_LOG_SIZE))
    return profiling.spans


def test_readers_on_a_cpu_run_of_the_cell(empty_log):
    cell = helpers.write_cell(
        tempfile.mkdtemp(),
        dict(helpers.WIRE_COLDSTART, capture_epochs=300, warm_starts=1),
        helpers.config(wire=True))
    r = run.Run(cell, 2 ** 31 + 41, "cpu")
    r.setup()
    r.window(0.01)
    starts = 1 + len(r.records)
    got = {m: spec.reader(m)(r.ctx) for m in SPAN_READERS + TRACE_READERS}
    for m in SPAN_READERS:
        assert isinstance(got[m], float) and got[m] > 0, m
    for m in TRACE_READERS:
        assert got[m] is None, m
    assert sum(s.name == "acquire" for s in empty_log) == starts
    for m in ("readbacks_per_start", "uploads_per_start"):
        assert got[m] == int(got[m]), m


def _span(name, self_s, counts=None, traced=False, parent=None):
    return Span(name, 1, parent, 0.0, self_s + 1.0, self_s, counts or {},
                traced)


def test_readers_on_synthetic_spans(empty_log):
    empty_log.extend([
        _span("condition", 0.5e-3, {"upload": 2}),
        _span("acquire", 3e-3, {"upload": 2, "readback": 5}),
        _span("pretrack.doppler", 12e-3, {"upload": 35, "readback": 1}),
        _span("pretrack.code", 9e-3, {"upload": 3, "readback": 1}),
        _span("start_tracking", 0.25e-3, {"upload": 4}),
        _span("acquire", 4e-3, {"upload": 2, "readback": 5}),
        _span("pretrack.doppler", 14e-3, {"upload": 35, "readback": 1}),
        _span("pretrack.code", 11e-3, {"upload": 3, "readback": 1}),
        _span("start_tracking", 0.75e-3, {"upload": 4}),
        # a traced start: left out of the span readers, counted by the
        # trace's
        _span("acquire", 99.0, {"readback": 50}, traced=True),
        _span("pretrack.code", 99.0, traced=True),
    ])
    read = {m: spec.reader(m) for m in SPAN_READERS + TRACE_READERS}
    trace = {"kernels": {"k_a": (0.1, 300), "k_b": (0.2, 100)},
             "window_s": 2.0, "busy_s": 0.1,
             "idle_gaps": [["host (no operation)", 0.5],
                           ["gps.pretrack.code", 0.3], ["aten::mul", 0.2],
                           ["gps.start_tracking", 0.1]]}
    ctx = {"kind": "coldstart", "cold": {"wall_s": [0.03, 0.03]},
           "trace": trace}
    assert read["pretrack_doppler_ms"](ctx) == pytest.approx(13.0)
    assert read["pretrack_code_ms"](ctx) == pytest.approx(10.0)
    assert read["handoff_ms"](ctx) == pytest.approx(0.5)
    # condition_host_ms reads the duration, not the self time
    assert read["condition_host_ms"](ctx) == pytest.approx(1000.5)
    assert read["readbacks_per_start"](ctx) == 7.0
    assert read["uploads_per_start"](ctx) == 45.0
    assert read["launches_per_start"](ctx) == 400.0
    assert read["idle_pct.coldstart.python"](ctx) == pytest.approx(20.0)
    # a replay run reads nothing from the cold starts' spans
    for m, fn in read.items():
        assert fn({"kind": "replay", "trace": trace}) is None, m


def test_readers_without_a_span_log(monkeypatch):
    monkeypatch.delattr(profiling, "spans")
    ctx = {"kind": "coldstart", "cold": {"wall_s": [0.03]},
           "trace": {"kernels": {"k": (0.1, 10)}, "window_s": 1.0,
                     "busy_s": 0.1, "idle_gaps": [["gps.x", 0.1]]}}
    for m in SPAN_READERS + TRACE_READERS:
        assert spec.reader(m)(ctx) is None, m


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_summarize_labels_gaps_with_the_innermost_span():
    events = [
        _x("k1", "kernel", 0.0, 10.0),
        _x("gps.start_tracking", "user_annotation", 5.0, 200.0),
        _x("gps.pretrack.code", "user_annotation", 20.0, 100.0),
        _x("aten::mul", "cpu_op", 50.0, 30.0),
        # the annotation's copy on the card's timeline: not busy time
        _x("gps.pretrack.code", "gpu_user_annotation", 10.0, 150.0),
        _x("k2", "kernel", 30.0, 10.0),      # gap 10-30: pretrack.code
        _x("k3", "kernel", 70.0, 5.0),       # gap 40-70: aten::mul
        _x("k4", "kernel", 200.0, 10.0),     # gap 75-200: start_tracking
        _x("k5", "kernel", 300.0, 10.0),     # gap 210-300: no operation
    ]
    s = summarize(events)
    assert s["busy_s"] == pytest.approx(45e-6)
    assert s["window_s"] == pytest.approx(310e-6)
    gaps = dict(s["idle_gaps"])
    assert gaps == pytest.approx({"gps.pretrack.code": 20e-6,
                                  "aten::mul": 30e-6,
                                  "gps.start_tracking": 125e-6,
                                  "host (no operation)": 90e-6})
