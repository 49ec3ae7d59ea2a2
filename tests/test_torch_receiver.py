"""The port's Receiver end to end on the CPU.

* against the JAX package's golden vectors (tests/goldens/
  receiver_golden.npz, made by tools/make_goldens.py) at the tolerances of
  tests/test_goldens.py;
* on the tracking-scan kernel's plain version (in_kernel_scan=True), the
  run of tests/test_receiver.py:137-170;
* on the per-epoch half-chip path (use_pallas=True, in_kernel_scan=False)
  against the JAX Receiver on the same path, bit for bit;
* the full-scale cold start to a fix, gated behind RUN_SLOW=1 like
  tests/test_e2e_slow.py.
"""

import os

import numpy as np
import pytest
import torch

from stm32f4_sdr_gps_torch.config import ReceiverConfig, TrackConfig
from stm32f4_sdr_gps_torch.io.status import render_status
from stm32f4_sdr_gps_torch.ops import track_scan as ts
from stm32f4_sdr_gps_torch.runtime.receiver import Receiver
from tests.test_receiver import CIB, PRNS, _make_capture

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens",
                      "receiver_golden.npz")
slow = pytest.mark.skipif(
    os.environ.get("RUN_SLOW") != "1", reason="set RUN_SLOW=1 to run"
)


def _port_goldens(device_digest=True):
    """tools/make_goldens.py build(), run through the port's Receiver."""
    num_epochs = 120 * CIB + 4 * 300 * CIB + 400
    x, _ = _make_capture(num_epochs, seed=11)
    cfg = ReceiverConfig(
        prns=PRNS,
        track=TrackConfig(codes_in_bit=CIB, pll_bad_state_threshold=10**9),
        enable_position=False,
        track_block_epochs=500,
        device_digest=device_digest,
    )
    rx = Receiver(cfg)
    rx.run(x)
    out = {}
    for ch in rx.channels:
        p = ch.prn
        out[f"dop_{p}"] = np.float64(ch.doppler_hz)
        out[f"cp_{p}"] = np.float64(ch.code_phase_chips)
        out[f"sft_{p}"] = np.int64(ch.subframe_time_ms)
        out[f"tow_{p}"] = np.float64(ch.subframe_tow_s)
        out[f"mask_{p}"] = np.int64(ch.eph.received_mask_proc)
        out[f"cn0_{p}"] = np.float64(ch.cn0_dbhz)
        out[f"eph_{p}"] = np.array([ch.eph.week, ch.eph.iode, ch.eph.iodc],
                                   dtype=np.int64)
        out[f"ephf_{p}"] = np.array([
            ch.eph.A, ch.eph.e, ch.eph.M0, ch.eph.OMG0, ch.eph.i0,
            ch.eph.omg, ch.eph.f0, ch.eph.tgd, ch.eph.toes,
        ], dtype=np.float64)
    return out, rx


@pytest.mark.parametrize("device_digest", [True, False],
                         ids=["digest", "full_readback"])
def test_receiver_matches_jax_goldens(device_digest):
    want = dict(np.load(GOLDEN))
    got, rx = _port_goldens(device_digest)
    assert set(got) == set(want)
    for k in sorted(want):
        w, g = want[k], got[k]
        if k.startswith(("mask_", "eph_", "sft_")):
            assert np.array_equal(w, g), (k, w, g)
        elif k.startswith("ephf_"):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-12, err_msg=k)
        elif k.startswith("tow_"):
            assert float(w) == float(g), k
        elif k.startswith("dop_"):
            assert abs(float(w) - float(g)) < 1.0, (k, w, g)
        elif k.startswith("cp_"):
            assert abs(float(w) - float(g)) < 0.05, (k, w, g)
        elif k.startswith("cn0_"):
            assert abs(float(w) - float(g)) < 1.0, (k, w, g)
    text = render_status(rx)
    assert all(f"{p:2d}" in text or str(p) in text for p in PRNS)


def test_receiver_runs_on_kernel_plain_version():
    """Receiver.run with in_kernel_scan=True on the CPU: the tracking scan
    runs as the kernel's plain version, carrying its ScanState between
    blocks; every channel tracks and decodes bits."""
    x, _ = _make_capture(700, seed=23)
    cfg = ReceiverConfig(
        prns=PRNS,
        track=TrackConfig(codes_in_bit=CIB, pll_bad_state_threshold=10**9,
                          in_kernel_scan=True),
        enable_position=False,
    )
    rx = Receiver(cfg)
    assert rx._digest_active
    calls = ts.track_scan_reference.calls
    rx.run(x)
    assert ts.track_scan_reference.calls - calls == \
        rx.profiler.stages["track"].calls
    assert len(rx.channels) == len(PRNS)
    for ch in rx.channels:
        assert ch.state_name == "TRACKING"
        assert ch.bit_count > 50, (ch.prn, ch.bit_count)
    # the carried ScanState stays valid while track_state is its view
    assert rx._scan_carry is not None
    assert rx.track_state is rx._scan_carry_ref
    rx.track_state = rx.track_state._replace(
        doppler_hz=rx.track_state.doppler_hz + 1.0)
    assert rx.track_state is not rx._scan_carry_ref


def test_receiver_half_chip_per_epoch_path_matches_jax():
    """Receiver.run on the per-epoch half-chip path (use_pallas with the
    whole-block scan off: one E/P/L correlator call per epoch, the plain
    version here) against the JAX Receiver on the same path with its
    Pallas kernel K2 in interpret mode: the same bits, in value and epoch,
    on every channel.  Final Doppler within 0.05 Hz and code phase within
    0.05 chip: the two correlators sum in other orders, which the closed
    loops carry into the last digits of their state."""
    from stm32f4_sdr_gps_tpu.config import ReceiverConfig as JReceiverConfig
    from stm32f4_sdr_gps_tpu.config import TrackConfig as JTrackConfig
    from stm32f4_sdr_gps_tpu.runtime.receiver import Receiver as JReceiver
    from stm32f4_sdr_gps_torch.ops import epl

    x, _ = _make_capture(700, seed=23)
    common = dict(codes_in_bit=CIB, pll_bad_state_threshold=10**9,
                  use_pallas=True, in_kernel_scan=False)
    j_rx = JReceiver(JReceiverConfig(
        prns=PRNS, enable_position=False,
        track=JTrackConfig(pallas_interpret=True, **common)))
    j_rx.run(x)
    rx = Receiver(ReceiverConfig(prns=PRNS, enable_position=False,
                                 track=TrackConfig(**common)))
    calls = epl.epl_correlate_halfchip.calls
    report = rx.run(x)
    tracked = report.epochs_processed - rx.config.acq.noncoherent_epochs
    assert epl.epl_correlate_halfchip.calls - calls == tracked
    assert [c.prn for c in rx.channels] == [c.prn for c in j_rx.channels]
    for ch, jch in zip(rx.channels, j_rx.channels):
        assert ch.state_name == "TRACKING"
        assert ch.bit_count > 50, (ch.prn, ch.bit_count)
        assert ch.bit_count == jch.bit_count, ch.prn
        assert ch.framer.history == jch.framer.history, ch.prn
        assert abs(ch.doppler_hz - jch.doppler_hz) < 0.05, ch.prn
        assert abs(ch.code_phase_chips - jch.code_phase_chips) < 0.05, ch.prn


def test_warm_reset_restarts_tracking():
    """Operator warm reset: nav state cleared, re-acquisition hinted with
    the learned Doppler, tracking restarted at the ledger cursor."""
    x, _ = _make_capture(400, seed=29)
    cfg = ReceiverConfig(prns=PRNS, enable_position=False,
                         track=TrackConfig(codes_in_bit=CIB,
                                           pll_bad_state_threshold=10**9))
    rx = Receiver(cfg)
    rx.run(x)
    cursor = rx.epoch_cursor
    dops = {ch.prn: ch.doppler_hz for ch in rx.channels}
    rx.warm_reset(x)
    assert rx.epoch_cursor == cursor
    assert torch.equal(rx.track_state.epoch_idx,
                       torch.full((len(PRNS),), cursor, dtype=torch.int32))
    for ch in rx.channels:
        assert ch.state_name == "TRACKING" and ch.bit_count == 0
        assert abs(ch.acq.doppler_hz - dops[ch.prn]) < 100.0


def test_receiver_on_cuda_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Receiver(ReceiverConfig(), device="cuda")


@pytest.mark.parametrize("change", [
    dict(enable_rtcm=True), dict(reacquire_period_ms=1000),
    dict(track=TrackConfig(coherent_pll=True))])
def test_unported_receiver_options_raise(change):
    with pytest.raises(NotImplementedError):
        Receiver(ReceiverConfig(**change))


def test_entry_block_program():
    from stm32f4_sdr_gps_torch.entry import entry

    fn, args = entry()
    ps, st, d = fn(*args)
    assert ps.f32.shape == (16, 32) and ps.i32.shape == (14, 32)
    assert d.bit_value.shape == (96 // 20 + 8, 32)
    assert torch.isfinite(d.doppler_hz).all()
    assert torch.equal(st.epoch_idx, torch.full((32,), 96, dtype=torch.int32))


@slow
@pytest.mark.parametrize("track", [
    dict(in_kernel_scan=False), dict(in_kernel_scan=True),
    dict(use_pallas=True, in_kernel_scan=False)],
    ids=["reference_scan", "kernel_plain_version", "half_chip_per_epoch"])
def test_full_cold_start_to_fix(track):
    from stm32f4_sdr_gps_torch.signal.scenarios import fix_scenario

    sc = fix_scenario(num_epochs=29_000)
    cfg = ReceiverConfig(prns=sc.prns, track_block_epochs=1000,
                         track=TrackConfig(**track))
    report = Receiver(cfg).run(sc.samples)
    for ch in report.channels:
        assert ch.eph.has_full_set, ch.prn
    assert report.solutions, "no position fix obtained"
    sol = report.solutions[-1]
    err = np.linalg.norm(sol.rr - sc.rr_true)
    assert err < 500.0, f"position error {err:.1f} m"
    assert np.linalg.norm(sol.vel) < 10.0
