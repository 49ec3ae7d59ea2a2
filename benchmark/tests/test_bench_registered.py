"""registered_uploads_per_start, the reader of the program's
``upload.registered`` counter: 0.0 on a CPU run of the int8 front end's
cold starts (the CPU registers nothing, though each start's window is a
view into the capture), the counts over the untraced ``acquire`` spans
on synthetic spans, and None where the program has no page-locked path
or keeps no span log."""

import json
import os

import pytest

from benchmark import run, spec
from stm32f4_sdr_gps_torch.utils import device, profiling
from stm32f4_sdr_gps_torch.utils.profiling import Span

from . import helpers

READER = "registered_uploads_per_start"


@pytest.fixture
def empty_log(monkeypatch):
    monkeypatch.setattr(profiling, "spans", type(profiling.spans)(
        maxlen=profiling.SPAN_LOG_SIZE))
    return profiling.spans


def test_reads_zero_on_a_cpu_run_of_the_int8_cold_start(tmp_path,
                                                         empty_log):
    cfg = helpers.config()
    with open(os.path.join(helpers.HERE, "configs",
                           "softgnss_fs38_int8.json")) as f:
        cfg["frontend"] = json.load(f)["frontend"]
    traffic = dict(helpers.WIRE_COLDSTART, capture_epochs=300,
                   warm_starts=0)
    cell = helpers.write_cell(str(tmp_path), traffic, cfg)
    r = run.Run(cell, 2 ** 31 + 25, "cpu")
    r.setup()
    r.window(0.01)
    assert spec.reader(READER)(r.ctx) == 0.0
    assert spec.reader("uploads_per_start")(r.ctx) > 0


def _span(name, counts, traced=False):
    return Span(name, 1, None, 0.0, 1.0, 1.0, counts, traced)


def test_reads_the_counts_over_the_untraced_starts(empty_log):
    empty_log.extend([
        _span("condition", {"upload": 1, "upload.registered": 1,
                            "upload.register": 1}),
        _span("acquire", {"upload": 2}),
        _span("condition", {"upload": 1}),
        _span("acquire", {"upload": 2}),
        _span("condition", {"upload": 1, "upload.registered": 1}, True),
        _span("acquire", {}, True),
    ])
    read = spec.reader(READER)
    assert read({"kind": "coldstart", "cold": {"wall_s": [0.01]}}) == 0.5
    assert read({"kind": "replay"}) is None


def test_none_without_the_page_locked_path_or_a_span_log(monkeypatch):
    ctx = {"kind": "coldstart", "cold": {"wall_s": [0.01]}}
    read = spec.reader(READER)
    with monkeypatch.context() as m:
        m.delattr(device, "upload_window")
        assert read(ctx) is None
    monkeypatch.delattr(profiling, "spans")
    assert read(ctx) is None
