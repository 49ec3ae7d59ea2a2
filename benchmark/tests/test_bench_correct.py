"""The comparison that decides ``correct`` fails where it must: the rest
of a run (set-up, window, the in-flight job finished, the verdict) on a
small cell on the CPU, with no look for a card, once sound and once with
the timed path broken underneath in each way the cell can be broken,
and once with the cell's control in the program's place.

Faults: a step that returns its state unchanged (the tracking step
hands back the state it was given), half of the batch left out (every
other acquired satellite dropped where the acquisition produces it),
and an answer altered where it is produced (one nav bit of every
subframe flipped as the tracker hands it to the framer; a cold start's
Doppler moved as the refinement produces it, or its code phase put on a
wrong peak).  A cold start holds no state across steps, and the exchange
between chips does not exist on one chip.  The cold starts run on the
wire, as the benchmark's cold-start cell does.
"""

import pytest

import stm32f4_sdr_gps_torch.runtime.receiver as receiver
from benchmark import run

from . import helpers

SEED = 2 ** 31 + 1234567


def _state_unchanged(monkeypatch):
    step = receiver.track_block

    def stuck(state, *a, **k):
        _, outs = step(state, *a, **k)
        return state, outs

    monkeypatch.setattr(receiver, "track_block", stuck)


def _half_batch(monkeypatch):
    acquire_all = receiver.Receiver.acquire_all

    def half(self, *a, **k):
        res = acquire_all(self, *a, **k)
        for ch in [c for c in self.channels if c.acq.detected][1::2]:
            ch.acq.detected = False
        return res

    monkeypatch.setattr(receiver.Receiver, "acquire_all", half)


def _bit_altered(monkeypatch):
    push = receiver.push_channel_bit

    def flipped(ch, value, epoch, cib):
        push(ch, value ^ (ch.bit_count % 300 == 150), epoch, cib)

    monkeypatch.setattr(receiver, "push_channel_bit", flipped)


def _doppler_altered(monkeypatch):
    refine = receiver.refine_doppler_device

    def moved(*a, **k):
        d = refine(*a, **k)
        d[0] += 50.0
        return d

    monkeypatch.setattr(receiver, "refine_doppler_device", moved)


def _code_altered(monkeypatch):
    refine = receiver.refine_code_phase

    def wrong_peak(*a, **k):
        cp = refine(*a, **k)
        cp[0] = (cp[0] + 300.0) % 1023.0
        return cp

    monkeypatch.setattr(receiver, "refine_code_phase", wrong_peak)


def _run(tmp_path, traffic, control=False, cfg=None):
    cell = helpers.write_cell(str(tmp_path), traffic, cfg)
    r = run.Run(cell, SEED, "cpu", control=control)
    r.setup()
    r.window(0.01)
    r.finish()
    return r


REPLAY_FAULTS = {"state_unchanged": _state_unchanged,
                 "half_batch": _half_batch, "bit_altered": _bit_altered}


@pytest.mark.parametrize("fault", [None, *REPLAY_FAULTS, "control"])
def test_replay(tmp_path, monkeypatch, fault):
    if fault in REPLAY_FAULTS:
        REPLAY_FAULTS[fault](monkeypatch)
    r = _run(tmp_path, helpers.REPLAY, control=fault == "control")
    ok, attempted, failed, rows = r.judge()
    numbers = {k: v for k, v, _ in rows}
    assert attempted == 1
    if fault is None:
        assert ok, rows
        assert failed == 0
        return
    assert not ok and failed == 1, rows
    if fault == "half_batch":
        assert numbers["missed_sats"] == 2
    elif fault == "control":
        assert numbers["fixes_missing"] == 1
    else:
        assert numbers["eph_wrong"] > 0 and numbers["fixes_missing"] == 2


COLD_FAULTS = {"half_batch": _half_batch, "doppler_altered": _doppler_altered,
               "code_altered": _code_altered}


@pytest.mark.parametrize("fault", [None, *COLD_FAULTS, "control"])
def test_coldstart(tmp_path, monkeypatch, fault):
    if fault in COLD_FAULTS:
        COLD_FAULTS[fault](monkeypatch)
    traffic = dict(helpers.WIRE_COLDSTART, warm_starts=0)
    r = _run(tmp_path, traffic, control=fault == "control",
             cfg=helpers.config(wire=True))
    for _ in range(5):
        r._coldstart()
    # the control: half the acquisition's epochs, its own Doppler and
    # code phase in the handoff's place
    ok, attempted, failed, rows = r.judge(
        handoff="acq" if fault == "control" else "handoff")
    numbers = {k: v for k, v, _ in rows}
    assert attempted == 6
    if fault is None:
        assert ok and failed == 0, rows
        return
    assert not ok and failed >= 1, rows
    if fault != "control":
        assert failed == 6
    if fault == "code_altered":
        assert numbers["handoff_code_max_chips"] > 100
    elif fault == "doppler_altered":
        assert numbers["handoff_doppler_max_hz"] > 40


def test_coldstart_host_ingest(tmp_path):
    """The complex-baseband ingest that the replayed-IQ cells use."""
    r = _run(tmp_path, dict(helpers.COLDSTART, warm_starts=0))
    r._coldstart()
    ok, attempted, failed, rows = r.judge()
    assert ok and attempted == 2 and failed == 0, rows
