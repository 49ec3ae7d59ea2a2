"""Every Receiver stage takes its samples as a numpy array or a tensor.

The compressed-time 4-PRN capture of tests/test_receiver.py (the verify
recipe's drive) fed once as a numpy array and once as a CPU tensor of
the same samples gives identical results, bit for bit: ``acquire_all``
alone, ``start_tracking`` alone, and ``Receiver.run`` (every channel's
state, bits, Doppler, code phase and C/N0, and its ``framer.history``).
A complex64 tensor on the receiver's device is used in place: no host
copy (``utils.profiling``'s ``upload.samples`` counter) and no device
copy (the epochs are a view of it).  A complex128 tensor is cast, as the numpy path casts.
"""

import numpy as np
import pytest
import torch

from stm32f4_sdr_gps_torch.acquire import engine
from stm32f4_sdr_gps_torch.acquire.engine import epochs_on
from stm32f4_sdr_gps_torch.config import ReceiverConfig, TrackConfig
from stm32f4_sdr_gps_torch.runtime.receiver import Receiver
from stm32f4_sdr_gps_torch.utils import profiling
from stm32f4_sdr_gps_torch.track.pretrack import refine_code_phase
from tests.test_receiver import CIB, PRNS, _make_capture

torch.set_num_threads(2)

S = 2046


@pytest.fixture(scope="module")
def capture():
    x, _ = _make_capture(120 * CIB + 300 * CIB + 300, seed=11)
    return x


def _sample_copies():
    return profiling.counters.get("upload.samples", 0)


def _receiver():
    return Receiver(ReceiverConfig(
        prns=PRNS, enable_position=False, track_block_epochs=250,
        track=TrackConfig(codes_in_bit=CIB, pll_bad_state_threshold=10**9)),
        device="cpu")


def _channel_record(ch):
    return (ch.prn, ch.state_name, ch.bit_count, ch.subframe_count,
            ch.doppler_hz, ch.code_phase_chips, ch.cn0_dbhz, ch.snr_db,
            ch.subframe_time_ms, ch.framer.history)


def test_epochs_on_uses_a_device_tensor_in_place(capture):
    t = torch.as_tensor(capture)
    copies = _sample_copies()
    e = epochs_on(t, 10, S, "cpu")
    assert _sample_copies() == copies
    assert e.shape == (10, S) and e.dtype == torch.complex64
    assert e.data_ptr() == t.data_ptr()
    np.testing.assert_array_equal(e.numpy(), capture[:10 * S].reshape(10, S))
    e128 = epochs_on(t.to(torch.complex128), 10, S, "cpu")
    assert e128.dtype == torch.complex64 and torch.equal(e128, e)
    assert _sample_copies() == copies
    epochs_on(capture, 10, S, "cpu")
    assert _sample_copies() == copies + 1


def test_acquire_and_refine_take_tensors(capture):
    """The acquire entry points and refine_code_phase give the same
    results from a tensor."""
    t = torch.as_tensor(capture)
    for fn in (engine.acquire, engine.acquire_epoch_vote):
        a = fn(capture, list(PRNS), device="cpu")
        b = fn(t, list(PRNS), device="cpu")
        assert a == b, fn.__name__
    assert engine.refine_doppler(capture, 2, 100.0, -2500.0, device="cpu") \
        == engine.refine_doppler(t, 2, 100.0, -2500.0, device="cpu")
    from stm32f4_sdr_gps_torch.signal.ca_code import ca_table_bipolar

    args = (ca_table_bipolar(list(PRNS)), np.array([100.0, 200.0, 300.0,
                                                    400.0]),
            np.array([-2500.0, 800.0, 3100.0, -400.0]),
            _receiver().config.plan)
    np.testing.assert_array_equal(
        refine_code_phase(capture, *args, device="cpu"),
        refine_code_phase(t, *args, device="cpu"))


def test_acquire_all_and_start_tracking_alone(capture):
    rx_n, rx_t = _receiver(), _receiver()
    t = torch.as_tensor(capture)
    assert rx_n.acquire_all(capture) == rx_t.acquire_all(t)
    rx_n.start_tracking(capture[10 * S:], start_epoch=10)
    copies = _sample_copies()
    rx_t.start_tracking(t[10 * S:], start_epoch=10)
    assert _sample_copies() == copies
    for a, b in zip(rx_n.track_state, rx_t.track_state):
        assert torch.equal(a, b)


def test_run_from_a_tensor_equals_run_from_numpy(capture):
    rx_n, rx_t = _receiver(), _receiver()
    rep_n = rx_n.run(capture)
    copies = _sample_copies()
    rep_t = rx_t.run(torch.as_tensor(capture))
    assert _sample_copies() == copies
    assert rep_n.epochs_processed == rep_t.epochs_processed
    assert [_channel_record(c) for c in rep_n.channels] == \
        [_channel_record(c) for c in rep_t.channels]
    assert sum(c.subframe_count for c in rep_n.channels) >= 4
    for a, b in zip(rx_n.track_state, rx_t.track_state):
        assert torch.equal(a, b)
