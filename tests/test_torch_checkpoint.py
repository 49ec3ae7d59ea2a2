"""The port's checkpoint (runtime/checkpoint.py), in the JAX package's
file format.

* save at half, resume and continue: equal to the uninterrupted run bit
  for bit on the CPU (tests/test_runtime.py:31 asks it of the JAX
  package), on the reference scan and on the tracking-scan kernel's
  plain version (there against an uninterrupted run whose kernel carry
  is dropped at the same block: a checkpoint stores no kernel state);
* a JAX-written checkpoint resumes in the port with the same bits and
  ephemerides as the JAX Receiver continuing, and a port-written one
  loads and continues in the JAX package;
* the device code table is rebuilt for the tracking path of the loading
  receiver (tests/test_runtime.py:436);
* the JAX-only TrackConfig fields are dropped on load, any other unknown
  field raises.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from stm32f4_sdr_gps_tpu.config import ReceiverConfig as JReceiverConfig
from stm32f4_sdr_gps_tpu.config import TrackConfig as JTrackConfig
from stm32f4_sdr_gps_tpu.runtime import checkpoint as jck
from stm32f4_sdr_gps_tpu.runtime.receiver import Receiver as JReceiver
from stm32f4_sdr_gps_torch import convert
from stm32f4_sdr_gps_torch.config import ReceiverConfig, TrackConfig
from stm32f4_sdr_gps_torch.ops.epl import raw_codes
from stm32f4_sdr_gps_torch.runtime import checkpoint as tck
from stm32f4_sdr_gps_torch.runtime import receiver as trx
from stm32f4_sdr_gps_torch.runtime.receiver import Receiver
from tests.test_receiver import CIB, PRNS, _make_capture

torch.set_num_threads(2)

SPE = 2046
BLOCK = 200


@pytest.fixture(scope="module")
def short_capture():
    return _make_capture(1200, seed=13)[0]


@pytest.fixture(scope="module")
def eph_capture():
    """tests/test_runtime.py's RTCM capture: ephemerides complete."""
    return _make_capture(4400, seed=13)[0]


def _kw(**track):
    return dict(prns=PRNS, enable_position=False, track_block_epochs=BLOCK,
                track=dict(codes_in_bit=CIB, pll_bad_state_threshold=10**9,
                           **track))


def _port_rx(**track):
    kw = _kw(**track)
    kw["track"] = TrackConfig(**kw["track"])
    return Receiver(ReceiverConfig(**kw), device="cpu")


def _jax_rx():
    kw = _kw()
    kw["track"] = JTrackConfig(**kw["track"])
    return JReceiver(JReceiverConfig(**kw))


def _start(rx, x):
    acq_e = rx.config.acq.noncoherent_epochs
    rx.acquire_all(x)
    rx.start_tracking(x[acq_e * SPE:], start_epoch=acq_e)
    rx.epoch_cursor = acq_e
    return acq_e * SPE


def _blocks(rx, x, pos, until=None):
    """process_block in BLOCK-epoch blocks from sample ``pos`` until the
    cursor reaches ``until`` (or the capture ends); returns the new pos."""
    while pos + SPE <= len(x) and (until is None or rx.epoch_cursor < until):
        chunk = x[pos: pos + BLOCK * SPE]
        rx.process_block(chunk)
        pos += (len(chunk) // SPE) * SPE
    return pos


def _state(rx):
    ts = rx.track_state
    if isinstance(ts.doppler_hz, torch.Tensor):
        return convert.track_state_to_numpy(ts)
    return {f: np.asarray(getattr(ts, f)) for f in ts._fields}


def _assert_same(a, b, exact=True):
    for ca, cb in zip(a.channels, b.channels):
        assert ca.prn == cb.prn
        assert ca.bit_count == cb.bit_count, ca.prn
        assert ca.framer.history == cb.framer.history, ca.prn
        assert ca.subframe_time_ms == cb.subframe_time_ms, ca.prn
        assert ca.eph.received_mask_proc == cb.eph.received_mask_proc
        if exact:
            assert ca.code_phase_chips == cb.code_phase_chips, ca.prn
            assert ca.doppler_hz == cb.doppler_hz, ca.prn
            assert ca.carrier_cycles == cb.carrier_cycles, ca.prn
        else:
            assert abs(ca.doppler_hz - cb.doppler_hz) < 0.05, ca.prn
            assert abs(ca.code_phase_chips - cb.code_phase_chips) < 0.05
    if exact:
        sa, sb = _state(a), _state(b)
        for f in sa:
            np.testing.assert_array_equal(sa[f], sb[f], err_msg=f)


@pytest.mark.parametrize("in_kernel_scan", [None, True],
                         ids=["reference_scan", "kernel_plain_version"])
def test_resume_bit_exact(short_capture, tmp_path, in_kernel_scan):
    x = short_capture
    cut = 600
    track = {} if in_kernel_scan is None else dict(in_kernel_scan=True)
    full = _port_rx(**track)
    pos_cut = _blocks(full, x, _start(full, x), until=cut)
    full._scan_carry_ref = None          # the resumed run has no carry
    _blocks(full, x, pos_cut)

    rx_a = _port_rx(**track)
    pos = _blocks(rx_a, x, _start(rx_a, x), until=cut)
    assert pos == pos_cut
    path = tck.save_receiver(str(tmp_path / "ck"), rx_a)
    assert path.endswith(".npz")
    rx_b = tck.load_receiver(path, device="cpu")
    assert rx_b.epoch_cursor == rx_a.epoch_cursor
    assert rx_b._scan_carry_ref is None
    _blocks(rx_b, x, pos)
    assert rx_b.epoch_cursor == full.epoch_cursor
    _assert_same(full, rx_b)


def test_jax_checkpoint_resumes_in_the_port(eph_capture, tmp_path):
    x = eph_capture
    cut = 2000
    j = _jax_rx()
    pos = _blocks(j, x, _start(j, x), until=cut)
    path = jck.save_receiver(str(tmp_path / "jax_ck"), j)
    rx = tck.load_receiver(path, device="cpu")
    assert rx.epoch_cursor == j.epoch_cursor
    assert isinstance(rx.track_state.doppler_hz, torch.Tensor)
    assert [c.prn for c in rx.channels] == [c.prn for c in j.channels]
    _blocks(j, x, pos)
    _blocks(rx, x, pos)
    _assert_same(j, rx, exact=False)
    for cj, ct in zip(j.channels, rx.channels):
        assert cj.eph.has_full_set and ct.eph.has_full_set, ct.prn
        for f in ("week", "iode", "iodc", "A", "e", "M0", "toes", "f0"):
            assert getattr(ct.eph, f) == getattr(cj.eph, f), f


def test_port_checkpoint_loads_in_jax(eph_capture, tmp_path):
    x = eph_capture
    cut = 2000
    rx = _port_rx()
    pos = _blocks(rx, x, _start(rx, x), until=cut)
    path = tck.save_receiver(str(tmp_path / "port_ck"), rx)
    j = jck.load_receiver(path)
    assert j.epoch_cursor == rx.epoch_cursor
    assert np.asarray(j.code_table).shape == (len(PRNS), 1023)
    _blocks(rx, x, pos)
    _blocks(j, x, pos)
    _assert_same(rx, j, exact=False)
    assert all(c.eph.has_full_set for c in j.channels)


def test_checkpoint_code_table_is_path_portable(short_capture, tmp_path,
                                                monkeypatch):
    """A checkpoint written on the reference scan's raw table resumes on a
    receiver that resolves to the tracking-scan kernel (the doubled
    upsampled table), and back."""
    x = short_capture[: 600 * SPE]
    rx = _port_rx()
    rx.acquire_all(x)
    rx.start_tracking(x)
    assert rx.code_table.shape[-1] == 1023
    p = tck.save_receiver(str(tmp_path / "ck"), rx)
    monkeypatch.setattr(trx, "resolve_in_kernel_scan", lambda cfg, dev: True)
    rx2 = tck.load_receiver(p, device="cpu")
    assert rx2.code_table.shape[-1] >= 2 * 2046
    assert raw_codes(rx2.code_table).shape[-1] == 1023
    assert torch.equal(raw_codes(rx2.code_table), rx.code_table)
    monkeypatch.undo()
    rx3 = tck.load_receiver(p, device="cpu")
    assert rx3.code_table.shape[-1] == 1023


def _rewrite_host(path, out, edit):
    data = dict(np.load(path, allow_pickle=False))
    host = json.loads(data["host_json"].tobytes().decode("utf-8"))
    edit(host)
    data["host_json"] = np.frombuffer(json.dumps(host).encode("utf-8"),
                                      dtype=np.uint8)
    np.savez_compressed(out, **data)
    return out


def test_jax_only_fields_dropped_other_fields_raise(short_capture, tmp_path):
    x = short_capture[: 600 * SPE]
    j = JReceiver(dataclasses.replace(
        _jax_rx().config,
        track=dataclasses.replace(_jax_rx().config.track,
                                  pallas_interpret=True, ablate="")))
    j.acquire_all(x)
    j.start_tracking(x)
    p = jck.save_receiver(str(tmp_path / "ck"), j)
    rx = tck.load_receiver(p, device="cpu")
    assert not hasattr(rx.config.track, "pallas_interpret")
    assert rx.config.track.codes_in_bit == CIB

    def add_field(host):
        host["__m__"]["config"]["fields"]["track"]["fields"]["warp"] = 1

    bad = _rewrite_host(p, str(tmp_path / "bad.npz"), add_field)
    with pytest.raises(TypeError, match="warp"):
        tck.load_receiver(bad, device="cpu")

    def add_class(host):
        host["__m__"]["channels"][0]["__dc__"] = "Trojan"

    bad2 = _rewrite_host(p, str(tmp_path / "bad2.npz"), add_class)
    with pytest.raises(ValueError, match="Trojan"):
        tck.load_receiver(bad2, device="cpu")


def _host(path):
    data = np.load(path, allow_pickle=False)
    return json.loads(data["host_json"].tobytes().decode("utf-8"))


@pytest.mark.parametrize("share", [None, 0.5], ids=["default", "set"])
def test_port_only_setting_is_written_where_it_is_set(short_capture,
                                                      tmp_path, share):
    """``ReceiverConfig.weak_prompt_share``, a setting the JAX package
    lacks: a checkpoint leaves it out at its default (so the JAX package
    loads it) and keeps it where it is set, which the port loads back
    and the JAX package refuses, naming it."""
    x = short_capture[: 600 * SPE]
    kw = _kw()
    kw["track"] = TrackConfig(**kw["track"])
    if share is not None:
        kw["weak_prompt_share"] = share
    rx = Receiver(ReceiverConfig(**kw), device="cpu")
    rx.acquire_all(x)
    rx.start_tracking(x)
    p = tck.save_receiver(str(tmp_path / "ck"), rx)
    fields = _host(p)["__m__"]["config"]["fields"]
    assert ("weak_prompt_share" in fields) == (share is not None)
    back = tck.load_receiver(p, device="cpu")
    assert back.config == rx.config
    if share is None:
        assert jck.load_receiver(p).epoch_cursor == rx.epoch_cursor
    else:
        with pytest.raises(TypeError, match="weak_prompt_share"):
            jck.load_receiver(p)
