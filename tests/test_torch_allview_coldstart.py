"""The complex-IQ cold start from host memory: the benchmark's
all-in-view cell (configuration ``iq2046k_allview32_cold``, traffic
``coldstart266``) at a size the CPU runs.

A window shaped like that cell's: complex baseband at 2.046 MHz with
rectangular chips and no filter, 8 PRNs searched and 3 in view at
45-50 dBHz, handed to ``acquire_all`` and ``start_tracking`` as a numpy
view into a capture held whole.  Once with the acquired phases as the
acquisition finds them, once with PRN 3's acquired phase planted 0.51
chip off the truth (the case that ``weak_prompt_channels`` exists for).

* Against the JAX package's ``Receiver`` on the same window: the same
  channels, acquired lags and Doppler bins (within the tolerances of
  tests/test_torch_acquire.py), and the handoff within those of
  tests/test_torch_handoff_weak_prompt.py (0.5 Hz, 0.05 chip).  The
  port runs as the cell configures it (``weak_prompt_share`` 1/2: a
  second Doppler search for every channel whose replica missed the
  peak's cell); the JAX package makes no second search.
* Against the planted truth within the cell's limits (read from the
  configuration's file).
* A numpy window and the same window as a CPU tensor give the same
  handoff bit for bit, and the code search on the Doppler search's
  epochs gives the power a search on the numpy window gives.
* The window crosses twice a start (``epochs_on``'s span ``samples``):
  the 10 acquisition epochs and the 32 of the Doppler search, 687,456
  bytes; a tensor window crosses nothing.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

from stm32f4_sdr_gps_torch.config import ReceiverConfig
from stm32f4_sdr_gps_torch.runtime import receiver as trx
from stm32f4_sdr_gps_torch.runtime.receiver import Receiver
from stm32f4_sdr_gps_torch.signal.simulator import SimSat, simulate_capture
from stm32f4_sdr_gps_torch.utils import profiling

SPE = 2046
ACQ = 10
SEARCHED = tuple(range(1, 9))
#: (PRN, Doppler Hz, code phase at sample 0, C/N0 dBHz)
IN_VIEW = ((3, -2310.0, 200.25, 45.0), (5, 1120.0, 611.25, 48.0),
           (8, 3470.0, 87.6, 50.0))
#: PRN 3's acquired phase put this far off the truth
PLANTED = {"as_acquired": None, "half_chip_off": 0.51}
CONFIG = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                      "benchmark", "configs", "iq2046k_allview32_cold.json")


with open(CONFIG) as _f:
    _CELL = json.load(_f)
#: the cell's handoff limits and its receiver's setting for rectangular
#: chips
LIMITS = (_CELL["limits"]["handoff_doppler_max_hz"],
          _CELL["limits"]["handoff_code_max_chips"])
SETTINGS = _CELL["receiver"]["settings"]


@pytest.fixture(scope="module")
def capture():
    """Two windows' worth of IQ (so a window is a view into a larger
    owner, as the benchmark's captures are) and the truth."""
    rng = np.random.default_rng(26)
    sats = [SimSat(prn=p, doppler_hz=d, code_phase_chips=q, cn0_dbhz=c,
                   nav_bits=rng.integers(0, 2, 40).astype(np.int8))
            for p, d, q, c in IN_VIEW]
    x, truth = simulate_capture(sats, num_epochs=120, seed=26)
    assert x.dtype == np.complex64 and x.flags.owndata
    return x, truth


def _window(capture):
    x, _ = capture
    return x[: 60 * SPE]


def _kw():
    return dict(prns=SEARCHED, enable_position=False)


def _port():
    """The port's receiver as the cell configures it."""
    return Receiver(ReceiverConfig(**_kw(), **SETTINGS), device="cpu")


def _start(rx, w, truth, planted):
    """Acquire on ``w``, plant PRN 3's acquired phase where asked, hand
    off; the receiver."""
    rx.acquire_all(w)
    if planted is not None:
        for ch in rx.channels:
            if ch.prn == 3:
                ch.acq.code_phase_chips = float(
                    (truth.code_phase_at_epoch(0, 0) + planted) % 1023.0)
    rx.start_tracking(w[ACQ * SPE:], start_epoch=ACQ)
    return rx


def _errors(rx, truth):
    """{PRN: (Doppler error Hz, code error chips)} at the handoff
    epoch."""
    dop = np.asarray(rx.track_state.doppler_hz, dtype=np.float64)
    cp = np.asarray(rx.track_state.code_phase_chips, dtype=np.float64)
    prns = [p for p, *_ in IN_VIEW]
    out = {}
    for i, ch in enumerate(rx.channels):
        k = prns.index(ch.prn)
        d = (cp[i] - truth.code_phase_at_epoch(k, ACQ)) % 1023.0
        true_hz = truth.apparent_doppler_hz(k, ACQ * 1e-3)
        out[ch.prn] = (abs(dop[i] - true_hz), min(d, 1023.0 - d))
    return out


@pytest.mark.parametrize("planted", list(PLANTED.values()),
                         ids=list(PLANTED))
def test_handoff_against_the_jax_package(capture, planted):
    from stm32f4_sdr_gps_tpu.config import ReceiverConfig as JReceiverConfig
    from stm32f4_sdr_gps_tpu.runtime.receiver import Receiver as JReceiver

    w = _window(capture)
    _, truth = capture
    rx = _start(_port(), w, truth,
                planted)
    jrx = _start(JReceiver(JReceiverConfig(**_kw())), w, truth, planted)
    assert [c.prn for c in rx.channels] == [c.prn for c in jrx.channels]
    # the acquisition within tests/test_torch_acquire.py's tolerances
    # (0.01 chip, 1 Hz), in the same 500 Hz bin
    for a, b in zip(rx.channels, jrx.channels):
        d = abs(a.acq.code_phase_chips - b.acq.code_phase_chips) % 1023.0
        assert min(d, 1023.0 - d) < 0.01
        assert abs(a.acq.doppler_hz - b.acq.doppler_hz) < 1.0
        assert round(a.acq.doppler_hz / 500.0) == round(b.acq.doppler_hz
                                                        / 500.0)
    port, jax = _errors(rx, truth), _errors(jrx, truth)
    for prn in port:
        assert abs(port[prn][0] - jax[prn][0]) <= 0.5, prn
        assert abs(port[prn][1] - jax[prn][1]) <= 0.05, prn


@pytest.mark.parametrize("planted", list(PLANTED.values()),
                         ids=list(PLANTED))
def test_handoff_against_the_planted_truth(capture, planted):
    w = _window(capture)
    _, truth = capture
    before = profiling.counters.get("pretrack.doppler_again", 0)
    rx = _start(_port(), w, truth, planted)
    again = profiling.counters.get("pretrack.doppler_again", 0) - before
    if planted is not None:
        assert again >= 1
    port = _errors(rx, truth)
    assert sorted(port) == [p for p, *_ in IN_VIEW]
    dop_limit, code_limit = LIMITS
    assert max(e[0] for e in port.values()) <= dop_limit, port
    assert max(e[1] for e in port.values()) <= code_limit, port
    # well inside them here: the prompt holds the signal
    assert max(e[0] for e in port.values()) <= 5.0, port


@pytest.mark.parametrize("planted", list(PLANTED.values()),
                         ids=list(PLANTED))
def test_numpy_and_tensor_windows_hand_over_alike(capture, planted):
    w = _window(capture)
    _, truth = capture
    a = _start(_port(), w, truth,
               planted)
    b = _start(_port(),
               torch.as_tensor(w.copy()), truth, planted)
    assert [c.prn for c in a.channels] == [c.prn for c in b.channels]
    for f in ("doppler_hz", "code_phase_chips"):
        assert torch.equal(getattr(a.track_state, f),
                           getattr(b.track_state, f)), f


def test_code_search_on_the_doppler_search_epochs(capture, monkeypatch):
    """The handoff's code search reads the Doppler search's epochs on the
    device: its power is that of a search on the numpy window itself."""
    w = _window(capture)
    _, truth = capture
    seen = []
    search = trx.code_search_power

    def spy(samples, *a, **k):
        power = search(samples, *a, **k)
        seen.append((samples, a, k, power))
        return power

    monkeypatch.setattr(trx, "code_search_power", spy)
    _start(_port(), w, truth, None)
    (samples, a, k, power), = seen
    assert isinstance(samples, torch.Tensor)
    want = search(w[ACQ * SPE:], *a, **k)
    assert np.array_equal(power, want)


def _since(t0):
    return [s for s in list(profiling.spans) if s.t0 >= t0]


def test_a_start_crosses_the_window_twice(capture):
    w = _window(capture)
    _, truth = capture
    names = ("upload.samples", "samples.bytes")
    before = dict(profiling.counters)
    t0 = time.perf_counter()
    rx = _start(_port(), w, truth,
                None)
    moved = {k: profiling.counters.get(k, 0) - before.get(k, 0)
             for k in names}
    assert moved == {"upload.samples": 2, "samples.bytes": 687_456}
    crossings = [s for s in _since(t0) if s.name == "samples"]
    assert [s.parent for s in crossings] == ["acquire", "pretrack.doppler"]
    assert {s.rid for s in crossings} == {rx.profiler.rid}
    assert [s.counts["samples.bytes"] for s in crossings] == [
        ACQ * SPE * 8, 32 * SPE * 8]

    before = dict(profiling.counters)
    t0 = time.perf_counter()
    _start(_port(),
           torch.as_tensor(w.copy()), truth, None)
    assert all(profiling.counters.get(k, 0) == before.get(k, 0)
               for k in names)
    assert "samples" not in {s.name for s in _since(t0)}
