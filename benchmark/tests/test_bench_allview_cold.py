"""The all-in-view cold start (configuration ``iq2046k_allview32_cold``,
cell ``allview_coldstart``): its configuration makes the captures
``iq2046k_allview32`` makes and adds the cold-start limits and the
handoff's setting for rectangular chips, and the
readers of the host window's crossing (``samples_ms``,
``sample_mb_per_start``) on a CPU run of the cell's loop, on synthetic
spans, and where the program gives them nothing to read."""

import hashlib
import json
import os

import pytest

from benchmark import gen, jobs, run, scene, spec, truth
from stm32f4_sdr_gps_torch.utils import profiling
from stm32f4_sdr_gps_torch.utils.profiling import Span

from . import helpers
from .test_bench_gen import MADE_BEFORE

NAME = "iq2046k_allview32_cold"
#: what the cold-start configuration adds to or states anew of the
#: replay configuration; everything else is the same
ADDED = {"name", "deployment", "receiver", "guarantees", "limits",
         "limits_source", "reduced"}
READERS = ("samples_ms", "sample_mb_per_start")


def _cfg(name):
    with open(os.path.join(helpers.HERE, "configs", name + ".json")) as f:
        return json.load(f)


@pytest.fixture
def empty_log(monkeypatch):
    monkeypatch.setattr(profiling, "spans", type(profiling.spans)(
        maxlen=profiling.SPAN_LOG_SIZE))
    return profiling.spans


def test_makes_the_captures_of_the_replay_configuration():
    digest, dtype, n, lag = MADE_BEFORE["iq2046k_allview32"]
    cfg = _cfg(NAME)
    fe = cfg["frontend"]
    mod = spec.frontend(fe["kind"])
    seed = 2 ** 31 + 77
    sc = scene.build(cfg, seed, 0, 0.006)
    x = gen.synthesize(sc, fe, 6, seed, "cpu", chunk_epochs=4, frontend=mod)
    assert x.dtype == dtype and x.shape == (n,)
    assert hashlib.sha256(x.tobytes()).hexdigest() == digest
    assert truth.frontend_lag_s(fe, mod) == lag


def test_is_the_replay_configuration_with_cold_start_limits():
    cold, replay = _cfg(NAME), _cfg("iq2046k_allview32")
    assert {k: v for k, v in cold.items() if k not in ADDED} == {
        k: v for k, v in replay.items() if k not in ADDED}
    assert {k: v for k, v in cold["guarantees"].items() if k != "handoff"} \
        == {k: v for k, v in replay["guarantees"].items() if k != "handoff"}
    # the receiver: the same PRNs and cadence, and the handoff's second
    # Doppler search set for rectangular chips (ReceiverConfig)
    settings = cold["receiver"].pop("settings")
    assert cold["receiver"] == replay["receiver"]
    assert set(settings) == {"weak_prompt_share"}
    assert jobs.receiver_config(_cfg(NAME), {"kind": "coldstart"}) \
        .weak_prompt_share == settings["weak_prompt_share"] > 0.125
    lim = cold["limits"]
    assert truth.limits(cold, "coldstart") == dict(
        missed_sats=0, handoff_doppler_max_hz=lim["handoff_doppler_max_hz"],
        handoff_code_max_chips=lim["handoff_code_max_chips"])
    assert truth.limits(cold, "replay") == truth.limits(replay, "replay")
    # the handoff's limits lie under the acquisition's half bin
    assert 0 < lim["handoff_doppler_max_hz"] < 250.0
    assert 0 < lim["handoff_code_max_chips"] <= 1.0
    with open(os.path.join(os.path.dirname(helpers.HERE),
                           "BENCHMARK.json")) as f:
        bench = json.load(f)
    entry, = [c for c in bench["configs"] if c["name"] == NAME]
    assert entry["file"] == f"benchmark/configs/{NAME}.json"
    cell, = [w for w in bench["workloads"] if w["config"] == NAME]
    assert (cell["name"], cell["traffic"], cell["chips"]) == (
        "allview_coldstart", "coldstart266", 1)


def test_readers_on_a_cpu_run_of_the_cell(tmp_path, empty_log):
    """Two cold starts of the cell on the CPU (its configuration, its
    traffic on shorter captures): 0.687456 MB of window a start, and a
    positive time for its crossings."""
    cfg = _cfg(NAME)
    with open(os.path.join(helpers.HERE, "traffic",
                           "coldstart266.json")) as f:
        traffic = dict(json.load(f), capture_epochs=400, warm_starts=0)
    cell = helpers.write_cell(str(tmp_path), traffic, cfg)
    r = run.Run(cell, 2 ** 31 + 2626, "cpu")
    r.setup()
    r.window(0.01)
    r._coldstart()
    assert spec.reader("sample_mb_per_start")(r.ctx) == pytest.approx(
        (10 + 32) * 2046 * 8 / 1e6, abs=1e-12)
    assert spec.reader("sample_mb_per_start")(r.ctx) == pytest.approx(
        0.687456, abs=1e-12)
    assert spec.reader("samples_ms")(r.ctx) > 0
    ok, attempted, failed, rows = r.judge()
    assert ok and attempted == 2 and failed == 0, rows


def _span(name, rid, dur, counts=None, traced=False):
    return Span(name, rid, None, 0.0, dur, dur, counts or {}, traced)


def test_readers_on_synthetic_spans(empty_log):
    """The crossings summed a start (request id) and the median over the
    untraced starts; the bytes over the untraced ``acquire`` spans."""
    b = {"samples.bytes": 1000}
    empty_log.extend([
        _span("samples", 1, 0.001, b), _span("acquire", 1, 0.01),
        _span("samples", 1, 0.002, b),
        _span("samples", 2, 0.003, b), _span("acquire", 2, 0.01),
        _span("samples", 2, 0.004, b),
        _span("samples", 3, 0.001, b), _span("acquire", 3, 0.01),
        _span("samples", 3, 0.001, b),
        _span("samples", 4, 0.5, b, True), _span("acquire", 4, 0.01, None,
                                                  True),
    ])
    ctx = {"kind": "coldstart", "cold": {"wall_s": [0.01]}}
    assert spec.reader("samples_ms")(ctx) == pytest.approx(3.0)
    assert spec.reader("sample_mb_per_start")(ctx) == pytest.approx(0.002)


@pytest.mark.parametrize("reader", READERS)
def test_readers_read_nothing_where_nothing_crossed(empty_log, reader):
    """A program without the span and counter (or a window handed over
    on the device), an empty log, and a run that is no cold start: None,
    so the line leaves the metric out."""
    ctx = {"kind": "coldstart", "cold": {"wall_s": [0.01]}}
    read = spec.reader(reader)
    assert read(ctx) is None
    empty_log.extend([_span("condition", 1, 0.001, {"upload": 1}),
                      _span("acquire", 1, 0.01, {"upload": 2})])
    assert read(ctx) is None
    empty_log.append(_span("samples", 2, 0.001, {"samples.bytes": 8}))
    assert read({"kind": "replay"}) is None
