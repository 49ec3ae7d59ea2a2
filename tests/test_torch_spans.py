"""Spans and counters of the port (``utils/profiling.py``) on the CPU.

The span log: nesting, self time, request ids, the ``traced`` flag and
the log's bound; ``count``; the stage timers' meaning and their report.
Then a whole cold start from wire words (upload and conditioning,
acquisition, handoff): under a ``torch.profiler`` its trace holds the
program's spans as ``user_annotation`` events; with none active the span
path calls nothing of ``torch.profiler``; and its ``readback`` and
``upload`` counts are every ``.cpu()`` and every tensor made from host
data in the start, counted by patching those calls around it.  Its code
table and TrackState equal those built from host tables, bit for bit; the
code table is uploaded once a process for a PRN set, and ``init_state``
uploads each host vector once.
"""

import json
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from stm32f4_sdr_gps_torch.config import (CODE_LENGTH, REFERENCE_PLAN,
                                          ReceiverConfig, TrackConfig)
from stm32f4_sdr_gps_torch.io.status import render_status
from stm32f4_sdr_gps_torch.ops import epl
from stm32f4_sdr_gps_torch.runtime import receiver
from stm32f4_sdr_gps_torch.runtime.receiver import Receiver
from stm32f4_sdr_gps_torch.signal.ca_code import ca_table_bipolar
from stm32f4_sdr_gps_torch.signal.capture import (
    pack_bits_lsb16, reference_to_baseband_device)
from stm32f4_sdr_gps_torch.signal.simulator import SimSat, simulate_capture
from stm32f4_sdr_gps_torch.utils import profiling
from stm32f4_sdr_gps_torch.track.state import TrackState, init_state
from stm32f4_sdr_gps_torch.utils.profiling import Profiler, count, span

torch.set_num_threads(2)

S = 2046
PRNS = (3, 11, 19, 27)
ACQ = 10                    # the acquisition's epochs (AcqConfig default)
COLD_SPANS = {"condition", "acquire", "start_tracking", "pretrack",
              "pretrack.doppler", "pretrack.code"}


def _last(n):
    return list(profiling.spans)[-n:]


def _since(t0):
    """The spans opened since ``perf_counter`` read ``t0``."""
    return [r for r in profiling.spans if r.t0 >= t0]


# -- the span log ------------------------------------------------------------

def test_spans_nest_with_self_time():
    with span("outer"):
        time.sleep(0.002)
        with span("inner"):
            time.sleep(0.003)
    inner, outer = _last(2)
    assert (inner.name, inner.parent) == ("inner", "outer")
    assert (outer.name, outer.parent) == ("outer", None)
    assert inner.self_s == inner.dur_s >= 0.003
    assert outer.dur_s >= inner.dur_s + 0.002
    assert outer.self_s == pytest.approx(outer.dur_s - inner.dur_s,
                                         abs=1e-12)
    assert outer.t0 <= inner.t0 <= inner.t0 + inner.dur_s <= \
        outer.t0 + outer.dur_s


def test_siblings_add_to_the_parent_child_time():
    with span("p"):
        for _ in range(3):
            with span("c"):
                time.sleep(0.001)
    recs = _last(4)
    p = recs[-1]
    kids = sum(r.dur_s for r in recs[:3])
    assert [r.name for r in recs] == ["c", "c", "c", "p"]
    assert p.self_s == pytest.approx(p.dur_s - kids, abs=1e-12)


def test_request_ids_are_fresh_a_profiler_and_inherited():
    a, b = Profiler(), Profiler()
    assert a.rid != b.rid and a.rid > 0 and b.rid > 0
    with span("alone"):
        pass
    assert _last(1)[0].rid == 0
    with a.stage("stage").time():
        with span("inside"):
            with span("deeper"):
                pass
    deeper, inside, stage = _last(3)
    assert deeper.rid == inside.rid == stage.rid == a.rid
    with b.stage("stage").time():
        pass
    assert _last(1)[0].rid == b.rid


def test_traced_only_under_an_active_profiler():
    with span("plain"):
        pass
    assert not _last(1)[0].traced
    with profile(activities=[ProfilerActivity.CPU]):
        with span("under"):
            torch.ones(4).sum()
    assert _last(1)[0].traced
    with span("after"):
        pass
    assert not _last(1)[0].traced


def test_the_log_is_bounded():
    assert profiling.spans.maxlen == profiling.SPAN_LOG_SIZE
    with span("first"):
        pass
    for _ in range(profiling.SPAN_LOG_SIZE):
        with span("filler"):
            pass
    assert len(profiling.spans) == profiling.SPAN_LOG_SIZE
    assert all(r.name == "filler" for r in profiling.spans)


def test_count_goes_to_the_innermost_span_and_the_totals():
    before = dict(profiling.counters)
    count("widgets")
    with span("a"):
        count("widgets", 2)
        with span("b"):
            count("widgets", 5)
            count("gadgets")
    b, a = _last(2)
    assert b.counts == {"widgets": 5, "gadgets": 1}
    assert a.counts == {"widgets": 2}
    assert profiling.counters["widgets"] == before.get("widgets", 0) + 8
    assert profiling.counters["gadgets"] == before.get("gadgets", 0) + 1


def test_counts_from_many_threads_are_not_lost():
    n_threads, n = 16, 5000
    before = profiling.counters.get("threads", 0)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work():
        with span("worker"):
            for _ in range(n):
                count("threads")

    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert profiling.counters["threads"] == before + n_threads * n
    workers = [r for r in _last(n_threads) if r.name == "worker"]
    assert len(workers) == n_threads
    assert all(r.counts == {"threads": n} and r.parent is None
               for r in workers)


def test_an_exception_closes_the_span():
    prof = Profiler()
    with pytest.raises(ValueError):
        with prof.stage("x").time():
            with span("y"):
                raise ValueError("inside")
    y, x = _last(2)
    assert (y.name, y.parent, x.name, x.parent) == ("y", "x", "x", None)
    # the stage counts completed calls only, as before; the stack is empty
    assert prof.stages["x"].calls == 0
    with span("z"):
        pass
    assert _last(1)[0].parent is None


def test_stage_timer_keeps_its_meaning(monkeypatch):
    # a clock that steps 1 us a read, and by ``dt`` where the span's work
    # would take that long: the budget is judged on these durations, not
    # on how a loaded machine schedules a sleep
    clock = [0.0]

    def perf_counter():
        clock[0] += 1e-6
        return clock[0]

    monkeypatch.setattr(profiling, "perf_counter", perf_counter)
    prof = Profiler()
    st = prof.stage("work", budget_s=0.002)
    assert prof.stage("work") is st
    for dt in (0.0, 0.004, 0.0):
        with st.time():
            clock[0] += dt
    assert st.calls == 3 and st.overruns == 1
    assert st.total_s >= 0.004 and st.last_s < 0.002
    assert st.mean_s == pytest.approx(st.total_s / 3)
    assert 0.0 < st.p95_s <= max(st.recent)
    assert len(st.recent) == 3


def test_report_nests_stages_with_p95_and_copies():
    prof = Profiler()
    with prof.stage("outer").time():
        count("readback")
        with prof.stage("inner").time():
            count("upload", 3)
    with prof.stage("alone").time():
        pass
    rows = prof.report().splitlines()
    assert rows[0].split() == ["stage", "calls", "mean", "ms", "p95", "ms",
                               "total", "s", "overruns", "readback",
                               "upload"]
    labels = [r[:20].rstrip() for r in rows[1:]]
    assert labels == ["alone", "outer", "  inner"]
    outer, inner = rows[2].split(), rows[3].split()
    assert outer[-2:] == ["1", "0"] and inner[-2:] == ["0", "3"]


# -- a cold start from wire words --------------------------------------------

@pytest.fixture(scope="module")
def words():
    sats = [SimSat(prn=p, doppler_hz=d, code_phase_chips=c, cn0_dbhz=50.0)
            for p, d, c in zip(PRNS, (-2100.0, 900.0, 2600.0, -400.0),
                               (120.3, 400.8, 650.1, 900.6))]
    x, _ = simulate_capture(sats, num_epochs=ACQ + 40, plan=REFERENCE_PLAN,
                            seed=5)
    return pack_bits_lsb16(x)


def _cold_start(words, **track):
    """What a cold start does: a fresh Receiver handed SPI words, which
    it conditions, acquires on and hands over to tracking."""
    rx = Receiver(ReceiverConfig(prns=PRNS, track=TrackConfig(**track)),
                  device="cpu")
    x = reference_to_baseband_device(words, device="cpu")
    rx.acquire_all(x)
    rx.start_tracking(x[ACQ * S:], start_epoch=ACQ)
    return rx


def test_cold_start_spans(words):
    t0 = time.perf_counter()
    rx = _cold_start(words)
    assert len(rx.channels) == len(PRNS)
    recs = _since(t0)
    assert {r.name for r in recs} == COLD_SPANS
    by = {r.name: r for r in recs}
    assert by["pretrack"].parent == "start_tracking"
    assert by["pretrack.doppler"].parent == by["pretrack.code"].parent \
        == "pretrack"
    assert by["condition"].rid == 0
    assert by["acquire"].rid == by["pretrack.code"].rid == rx.profiler.rid
    assert not any(r.traced for r in recs)
    report = render_status(rx, profile=True)
    assert "    pretrack.code" in report and "p95 ms" in report


def test_cold_start_trace_holds_the_spans(words, tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _cold_start(words)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"gps.pretrack.code", "gps.pretrack.doppler", "gps.start_tracking",
            "gps.condition"} <= names
    assert {"gps." + n for n in COLD_SPANS} == \
        {n for n in names if n.startswith("gps.")}


def test_no_profiler_no_record_function(words, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function called without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    t0 = time.perf_counter()
    rx = _cold_start(words)
    assert rx.track_state is not None
    assert {r.name for r in _since(t0)} == COLD_SPANS


def test_handoff_copies(words):
    """The handoff's copies: the Doppler search reads the refined Doppler
    back once; the code search takes the code table, the code phases and
    the refined Doppler where the Doppler search left them, uploads
    nothing and reads the power back once.  (On the CPU the Doppler
    search's plain loop also uploads the replica's lag each epoch; on the
    card its kernel takes that loop's place.)"""
    t0 = time.perf_counter()
    _cold_start(words)
    by = {r.name: r.counts for r in _since(t0)}
    assert by["pretrack.doppler"]["readback"] == 1
    assert by["pretrack.code"] == {"readback": 1}


def test_copy_counters_equal_the_patched_calls(words, monkeypatch):
    seen = {"readback": 0, "upload": 0}
    cpu = torch.Tensor.cpu

    def counted_cpu(self, *a, **k):
        seen["readback"] += 1
        return cpu(self, *a, **k)

    def host_copy(fn):
        def wrapper(data, *a, **k):
            if not isinstance(data, torch.Tensor):
                seen["upload"] += 1
            return fn(data, *a, **k)
        return wrapper

    monkeypatch.setattr(torch.Tensor, "cpu", counted_cpu)
    for name in ("as_tensor", "tensor", "from_numpy"):
        monkeypatch.setattr(torch, name, host_copy(getattr(torch, name)))
    c0 = dict(profiling.counters)
    t0 = time.perf_counter()
    _cold_start(words)
    got = {k: profiling.counters.get(k, 0) - c0.get(k, 0) for k in seen}
    assert got == seen
    assert seen["readback"] > 0 and seen["upload"] > 0
    # every copy falls inside one of the start's spans
    recs = _since(t0)
    for k in seen:
        assert sum(r.counts.get(k, 0) for r in recs) == seen[k]


TRACK_FORMS = pytest.mark.parametrize(
    "track", [{}, {"in_kernel_scan": True}],
    ids=["reference_scan", "kernel_scan"])


@TRACK_FORMS
def test_cold_start_equals_host_built_tables(words, monkeypatch, track):
    """A cold start's code table and TrackState equal, bit for bit, those
    of the same start with the tables built on the host: the bipolar
    codes by ``ca_table_bipolar``, the doubled form by
    ``upsampled_code_doubled``, each uploaded, and ``init_state``'s
    Dopplers and code phases each uploaded from the host."""
    rx = _cold_start(words, **track)

    def host_rows(prns, doubled, device):
        t = ca_table_bipolar(prns)
        return torch.as_tensor(
            epl.upsampled_code_doubled(t) if doubled else t, device=device)

    out = []
    handoff = receiver.handoff

    def kept(*a, **k):
        out.append(handoff(*a, **k))
        return out[-1]

    monkeypatch.setattr(receiver, "code_rows", host_rows)
    monkeypatch.setattr(receiver, "handoff", kept)
    old = _cold_start(words, **track)
    (dop, cp), = out
    assert old.code_table.shape[-1] == (epl.U2P if track else CODE_LENGTH)
    assert rx.code_table.dtype == old.code_table.dtype
    assert torch.equal(rx.code_table, old.code_table)

    def host(v):
        return torch.as_tensor(np.array(np.broadcast_to(v, (len(dop),)),
                                        np.float32))

    want = old.track_state._replace(
        doppler_hz=host(dop), acq_doppler_hz=host(dop),
        code_phase_chips=host(np.asarray(cp) % CODE_LENGTH))
    for f, got, w in zip(TrackState._fields, rx.track_state, want):
        assert got.dtype == w.dtype and torch.equal(got, w), f


@TRACK_FORMS
def test_code_table_is_uploaded_once_a_process(words, monkeypatch, track):
    """The first start of a PRN set uploads its bipolar codes once (the
    doubled form is gathered from them on the device); a second start of
    the same set uploads no code table and hands over the same tensor:
    the whole start makes one upload fewer."""
    _cold_start(words, **track)         # what else a process makes once
    epl.code_rows.cache_clear()
    seen = []
    upload = epl.upload

    def counted(*a, **k):
        seen.append(a[0].shape)
        return upload(*a, **k)

    def uploads(start):
        c0 = profiling.counters.get("upload", 0)
        return start(), profiling.counters.get("upload", 0) - c0

    monkeypatch.setattr(epl, "upload", counted)
    first, n_first = uploads(lambda: _cold_start(words, **track))
    assert seen == [(len(PRNS), CODE_LENGTH)]
    second, n_second = uploads(lambda: _cold_start(words, **track))
    assert seen == [(len(PRNS), CODE_LENGTH)]
    assert second.code_table is first.code_table
    assert n_first == n_second + 1


def test_init_state_uploads_each_vector_once():
    """``init_state`` uploads the Dopplers and the code phases once each:
    ``acq_doppler_hz`` is a device copy of ``doppler_hz``, equal and in
    storage of its own."""
    c0 = profiling.counters.get("upload", 0)
    st = init_state(3, np.array([1.5, 2.5, 1030.0]),
                    np.array([-1200.25, 0.0, 3400.5]), device="cpu")
    assert profiling.counters.get("upload", 0) - c0 == 2
    assert torch.equal(st.acq_doppler_hz, st.doppler_hz)
    assert st.acq_doppler_hz.data_ptr() != st.doppler_hz.data_ptr()
    assert st.code_phase_chips.tolist() == pytest.approx([1.5, 2.5, 7.0])
