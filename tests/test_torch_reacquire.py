"""The port's background re-acquisition and channel demotion against the
JAX package's: the two runs of tests/test_late_rise.py (with its
asserts, and the channel set after every block equal to the JAX
Receiver's, so the same join and drop epochs), the demotion cases of
tests/test_runtime.py:376-434 and the search timeout of
tests/test_runtime.py:137.

In tests/test_late_rise.py's setting run the JAX Receiver never demotes
PRN 18: through its 1.5 s gap the per-block C/N0 estimate on noise
reads 24-31 dBHz, above the 25 dBHz floor for less than the 1 s grace
window.  The same capture with ``cn0_floor_dbhz=35`` drops it at 2.51 s
and re-acquires it at 3.01 s in both packages (the ``setting_floor35``
case), which drives the demotion and the re-join through the Receiver.
"""

import numpy as np
import pytest
import torch

from stm32f4_sdr_gps_tpu.config import ReceiverConfig as JReceiverConfig
from stm32f4_sdr_gps_tpu.config import TrackConfig as JTrackConfig
from stm32f4_sdr_gps_tpu.runtime.receiver import Receiver as JReceiver
from stm32f4_sdr_gps_tpu.signal.simulator import SimSat, simulate_capture
from stm32f4_sdr_gps_torch.config import AcqConfig, ReceiverConfig, TrackConfig
from stm32f4_sdr_gps_torch.ops.epl import raw_codes
from stm32f4_sdr_gps_torch.runtime.receiver import ChannelStatus, Receiver
from stm32f4_sdr_gps_torch.signal.ca_code import ca_table_bipolar
from stm32f4_sdr_gps_torch.track.state import init_state
from tests.test_receiver import CIB as RX_CIB
from tests.test_receiver import PRNS, _make_capture

torch.set_num_threads(2)

CIB = 3
SPE = 2046


def _late_rise_capture():
    """tests/test_late_rise.py:14: PRN 18 silent for the first 1.2 s."""
    e, rise_epoch = 3000, 1200
    sat_a = SimSat(prn=5, doppler_hz=1200.0, code_phase_chips=300.0,
                   cn0_dbhz=47.0, codes_in_bit=CIB)
    sat_b = SimSat(prn=18, doppler_hz=-2400.0, code_phase_chips=700.0,
                   cn0_dbhz=47.0, codes_in_bit=CIB)
    xa, _ = simulate_capture([sat_a], num_epochs=e, seed=31)
    xb, truth_b = simulate_capture([sat_b], num_epochs=e, seed=32)
    xb[: rise_epoch * SPE] = 0
    return xa + xb, truth_b


def _setting_capture():
    """tests/test_late_rise.py:59: PRN 18 gone between 1.0 s and 2.5 s."""
    e = 4000
    sat_a = SimSat(prn=5, doppler_hz=1200.0, code_phase_chips=300.0,
                   cn0_dbhz=47.0, codes_in_bit=CIB)
    sat_b = SimSat(prn=18, doppler_hz=-2400.0, code_phase_chips=700.0,
                   cn0_dbhz=47.0, codes_in_bit=CIB)
    xa, _ = simulate_capture([sat_a], num_epochs=e, seed=41)
    xb, _ = simulate_capture([sat_b], num_epochs=e, seed=42)
    xb[1000 * SPE: 2500 * SPE] = 0
    return xa + xb, None


def assert_rows_follow_channels(rx):
    """The (C, 1023) rows behind ``rx.code_table`` are the bipolar codes
    of the tracked PRNs in row order, a mesh's ghost copies of channel 0
    included."""
    prns = [ch.prn for ch in rx.channels]
    prns += prns[:1] * (rx.code_table.shape[0] - len(prns))
    np.testing.assert_array_equal(raw_codes(rx.code_table).cpu().numpy(),
                                  ca_table_bipolar(prns))


def _run(pkg, x, **cfg):
    """Receiver.run with the late-rise config; returns the receiver, its
    report and the live PRNs after every block (and for the port, checks
    its code rows after every block: re-acquisitions and demotions)."""
    kw = dict(prns=(5, 18), enable_position=False, track_block_epochs=250,
              reacquire_period_ms=500, **cfg)
    trk = dict(codes_in_bit=CIB, pll_bad_state_threshold=10**9)
    if pkg == "jax":
        rx = JReceiver(JReceiverConfig(track=JTrackConfig(**trk), **kw))
    else:
        rx = Receiver(ReceiverConfig(track=TrackConfig(**trk), **kw),
                      device="cpu")
    live = []

    def status(r):
        live.append((r.epoch_cursor, tuple(ch.prn for ch in r.channels)))
        if pkg != "jax":
            assert_rows_follow_channels(r)

    report = rx.run(x, status_callback=status)
    return rx, report, live


@pytest.mark.parametrize("case", ["late_rise", "setting", "setting_floor35"])
def test_late_rise_runs_match_jax(case):
    x, truth_b = (_late_rise_capture() if case == "late_rise"
                  else _setting_capture())
    cfg = dict(cn0_floor_dbhz=35.0) if case == "setting_floor35" else {}
    jrx, _, j_live = _run("jax", x, **cfg)
    rx, report, live = _run("torch", x, **cfg)
    # the same channel set after every block: the same join and drop
    # epochs as the JAX Receiver
    assert live == j_live
    by = {ch.prn: ch for ch in report.channels}
    assert 5 in by and by[5].state_name == "TRACKING"
    assert 18 in by, "PRN 18 never (re)joined"
    assert by[18].state_name == "TRACKING"
    assert abs(by[18].doppler_hz + 2400.0) < 15.0
    if case == "late_rise":
        cp_true = truth_b.code_phase_at_epoch(0, report.epochs_processed - 1)
        err = (by[18].code_phase_chips - cp_true + 511.5) % 1023 - 511.5
        assert abs(err) < 0.5
        assert not rx.standby_channels
    elif case == "setting":
        assert all(prns == (5, 18) for _, prns in live)
    else:
        gone = [t for t, prns in live if prns == (5,)]
        assert gone and 2500 <= gone[0] and gone[-1] < 3500, live
        assert by[18].last_healthy_ms == report.epochs_processed
    assert rx.code_table.shape[0] == len(rx.channels)
    assert rx.track_state.doppler_hz.shape[0] == len(rx.channels)
    for ch in report.channels:
        jch = {c.prn: c for c in jrx.channels}[ch.prn]
        assert ch.bit_count == jch.bit_count, ch.prn
        assert abs(ch.doppler_hz - jch.doppler_hz) < 0.05, ch.prn


def _cfg(**kw):
    base = dict(
        prns=PRNS,
        track=TrackConfig(codes_in_bit=RX_CIB,
                          pll_bad_state_threshold=10**9),
        enable_position=False,
        track_block_epochs=200,
    )
    base.update(kw)
    return ReceiverConfig(**base)


def _demotion_rx(n=3, grace_ms=1000):
    """tests/test_runtime.py:359: a Receiver with hand-built live
    tracking state."""
    cfg = _cfg(demote_grace_ms=grace_ms)
    rx = Receiver(cfg, device="cpu")
    rx.channels = [ChannelStatus(prn=p + 1, state_name="TRACKING")
                   for p in range(n)]
    rx.track_state = init_state(n, np.zeros(n), np.zeros(n),
                                window=cfg.track.pll_check_window,
                                device="cpu")
    rx.code_table = torch.zeros((n, 16), dtype=torch.float32)
    return rx


def test_demotes_zero_cn0_noise_channel_despite_high_snr():
    rx = _demotion_rx()
    rx.epoch_cursor = 5000
    for ch in rx.channels:
        ch.last_healthy_ms = 4900
        ch.cn0_dbhz = 45.0
    bad = rx.channels[1]
    bad.cn0_dbhz = 0.0          # estimator failed on noise
    bad.snr_db = 3.0            # chance I/Q ratio
    bad.last_healthy_ms = 2000  # stale for 3 s
    dropped = rx.drop_dead_channels()
    assert dropped == [bad.prn]
    assert [ch.prn for ch in rx.channels] == [1, 3]
    assert rx.track_state.doppler_hz.shape[0] == 2
    assert rx.code_table.shape[0] == 2
    assert bad in rx.standby_channels and bad.state_name == "LOST"


def test_demotes_channel_that_decoded_bits_then_died():
    rx = _demotion_rx()
    rx.epoch_cursor = 10000
    for ch in rx.channels:
        ch.last_healthy_ms = 9900
        ch.cn0_dbhz = 45.0
    bad = rx.channels[2]
    bad.bit_count = 120
    bad.cn0_dbhz = 0.0
    bad.snr_db = 0.2
    bad.last_healthy_ms = 3000
    bad.doppler_hz = 1234.5
    assert rx.drop_dead_channels() == [bad.prn]
    assert bad.acq_hint_hz == 1234.5     # the re-acquisition hint


def test_demotion_respects_grace_window():
    rx = _demotion_rx(grace_ms=1500)
    rx.epoch_cursor = 4000
    for ch in rx.channels:
        ch.cn0_dbhz = 20.0
        ch.last_healthy_ms = 3000
    assert rx.drop_dead_channels() == []
    rx.epoch_cursor = 4600
    assert rx.drop_dead_channels() == []     # never drops every channel
    rx.channels[0].cn0_dbhz = 45.0
    rx.channels[0].last_healthy_ms = 4500
    assert sorted(rx.drop_dead_channels()) == [2, 3]
    assert [ch.prn for ch in rx.channels] == [1]


def test_demotion_selects_state_rows():
    """The row selection keeps each surviving channel's own state row."""
    rx = _demotion_rx(n=4)
    rx.track_state = rx.track_state._replace(
        doppler_hz=torch.tensor([10.0, 20.0, 30.0, 40.0]),
        ip_sign_window=torch.arange(16, dtype=torch.int8).reshape(4, 4))
    rx.code_table = torch.arange(4.0)[:, None].expand(4, 16).clone()
    rx.epoch_cursor = 9000
    for ch in rx.channels:
        ch.cn0_dbhz, ch.last_healthy_ms = 45.0, 8900
    rx.channels[1].cn0_dbhz = rx.channels[1].last_healthy_ms = 0
    assert rx.drop_dead_channels() == [2]
    assert rx.track_state.doppler_hz.tolist() == [10.0, 30.0, 40.0]
    assert rx.track_state.ip_sign_window[:, 0].tolist() == [0, 8, 12]
    assert rx.code_table[:, 0].tolist() == [0.0, 2.0, 3.0]


def test_acq_timeout_widens_search():
    """tests/test_runtime.py:137: a standby channel whose hinted search
    keeps failing discards the hint after AcqConfig.timeout_ms and
    re-enters a full-grid search, which finds it."""
    x, _ = _make_capture(700, seed=13)
    cfg = _cfg(doppler_hints_hz=(None, None, None, 3500.0),
               acq=AcqConfig(timeout_ms=400))
    rx = Receiver(cfg, device="cpu")
    rx.acquire_all(x)
    assert not rx.channels[3].acq.detected
    rx.start_tracking(x)
    assert [ch.prn for ch in rx.standby_channels] == [24]
    sb = rx.standby_channels[0]

    win = x[: 500 * SPE]
    rx.epoch_cursor = 500
    assert rx.maybe_reacquire(win) == []       # hint confines -> fail
    assert sb.acq_search_start_ms == 500
    assert sb.acq_timeouts == 0

    rx.epoch_cursor = 980                      # > timeout_ms later
    added = rx.maybe_reacquire(win)
    assert sb.acq_timeouts == 1
    assert added == [24]
    assert sb.state_name == "TRACKING"
    assert abs(rx.channels[-1].acq.doppler_hz - (-400.0)) < 300.0
    assert sb.last_healthy_ms == 980
    assert rx.track_state.epoch_idx.tolist()[-1] == 980
    assert rx.code_table.shape[0] == 4
    assert raw_codes(rx.code_table).shape == (4, 1023)
    assert_rows_follow_channels(rx)
