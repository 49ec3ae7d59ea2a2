"""The port on the reference firmware's wire format, on the CPU: the
cases of tests/test_reference_format_e2e.py and
tests/test_independent_capture.py, with their bars.

* 1-bit real samples at 16.368 MHz (IF 4.092 MHz) packed into SPI uint16
  words (signal_capture.c:143-177) -> native unpack -> the host
  conditioner -> acquisition -> tracking -> bit sync -> subframe decode
  (PRN 19, 2.3 s, 3 codes a bit): tracking within 15 Hz, > 400 bits,
  >= 1 subframe; also through probes/firmware_parity.py's copy of the
  capture and bars (what chip_smoke.py runs on the card).
* ``native/capture_gen``'s independent captures (no code shared with
  either package): cold acquisition finds every planted satellite at
  the truth code phase (sub-chip; 1.5 chip for the multipath PRN) and
  Doppler (within 300 Hz, TCXO shift included).  The decode and the fix
  run behind RUN_SLOW, as in the JAX file.
"""

import os

import numpy as np
import pytest
import torch

from stm32f4_sdr_gps_torch.acquire.engine import acquire
from stm32f4_sdr_gps_torch.config import (REFERENCE_PLAN, ReceiverConfig,
                                          TrackConfig)
from stm32f4_sdr_gps_torch.probes import firmware_parity as fp
from stm32f4_sdr_gps_torch.runtime import native
from stm32f4_sdr_gps_torch.runtime.receiver import Receiver
from stm32f4_sdr_gps_torch.signal.capture import (pack_bits_lsb16,
                                                  reference_to_baseband)
from stm32f4_sdr_gps_torch.signal.nav_message import build_bitstream
from stm32f4_sdr_gps_torch.signal.simulator import SimSat, simulate_capture
from tests.test_independent_capture import EPH_FIELDS
from tests.test_nav import TEST_EPH

torch.set_num_threads(2)

CIB = 3
slow = pytest.mark.skipif(
    os.environ.get("RUN_SLOW") != "1", reason="set RUN_SLOW=1 to run")


def test_wire_format_to_subframes():
    prefix = np.tile([0, 1], 50).astype(np.int8)
    body = build_bitstream(dict(TEST_EPH), start_tow_6s=700,
                           num_subframes=2, subframe_ids=(5, 1))
    sat = SimSat(prn=19, doppler_hz=2500.0, cn0_dbhz=52.0,
                 nav_bits=np.concatenate([prefix, body]),
                 codes_in_bit=CIB, delay_ms=4.321)
    x, _ = simulate_capture([sat], num_epochs=2300, plan=REFERENCE_PLAN,
                            seed=17)
    assert set(np.unique(x)) <= {-1.0, 1.0}

    words = pack_bits_lsb16(x)
    assert native.get_lib() is not None, "native library unavailable"
    signs = native.unpack_bits16(words)
    assert np.array_equal(signs, x.astype(np.float32))
    baseband = reference_to_baseband(signs)
    assert len(baseband) == len(x) // 8

    cfg = ReceiverConfig(
        prns=(19,),
        track=TrackConfig(codes_in_bit=CIB, pll_bad_state_threshold=10**9),
        enable_position=False,
        track_block_epochs=250,
    )
    report = Receiver(cfg, device="cpu").run(baseband)
    ch = report.channels[0]
    assert ch.state_name == "TRACKING"
    assert abs(ch.doppler_hz - 2500.0) < 15.0
    assert ch.bit_count > 400
    assert ch.subframe_count >= 1, (ch.framer.words_decoded,
                                    ch.framer.polarity_found)
    if ch.eph.received_mask_proc & 0x1:
        assert ch.eph.week == TEST_EPH["week"]

    # the probe's copy of the capture, and its bars on the same run
    assert fp.TEST_EPH == TEST_EPH
    assert fp.wire_format_config() == cfg
    p_words, p_signs = fp.wire_format_capture()
    assert np.array_equal(p_words, words) and np.array_equal(p_signs, x)
    rec = fp.check_wire_format(report)
    assert rec["bits"] == ch.bit_count and rec["subframes"] >= 1


def _generate(tmp, **kw):
    words, truth = native.capture_gen(str(tmp), "cap", **kw)
    return native.unpack_bits16(words), truth


def _code_phase_error(r, t):
    # sub-ms delay = (1023 - code_phase) / 1023 ms (pvt/observables.py)
    cp_true = (1023.0 * (1.0 - (t["delay_ms"] % 1.0))) % 1023.0
    dcp = abs(r.code_phase_chips - cp_true)
    return min(dcp, 1023.0 - dcp)


def test_independent_capture_acquisition(tmp_path):
    signs, truth = _generate(tmp_path, cib=20, duration_ms=60, cn0=48,
                             seed=5, repeats=1)
    baseband = reference_to_baseband(signs)
    prns = [s["prn"] for s in truth["sats"]]
    results = {r.prn: r for r in acquire(baseband, prns, device="cpu")}
    for t in truth["sats"]:
        r = results[t["prn"]]
        assert r.detected, t["prn"]
        assert _code_phase_error(r, t) < 1.0, (t["prn"], r.code_phase_chips)
        assert abs(r.doppler_hz - t["doppler_hz"]) < 300.0, t["prn"]


def test_independent_capture_impaired_acquisition(tmp_path):
    signs, truth = _generate(
        tmp_path, cib=20, duration_ms=60, cn0=48, seed=5, repeats=1,
        tcxo_ppm=2.0, phase_noise_rad2_s=0.5, frontend_bw_hz=1800000,
        multipath="7,0.8,0.3,0.13")
    assert truth["impairments"]["tcxo_ppm"] == 2.0
    baseband = reference_to_baseband(signs)
    prns = [s["prn"] for s in truth["sats"]]
    results = {r.prn: r for r in acquire(baseband, prns, device="cpu")}
    shift = -2.0e-6 * 1.57542e9
    for t in truth["sats"]:
        r = results[t["prn"]]
        assert r.detected, t["prn"]
        bound = 1.5 if t["prn"] == 7 else 1.0
        assert _code_phase_error(r, t) < bound, (t["prn"], r.code_phase_chips)
        assert abs(r.doppler_hz - (t["doppler_hz"] + shift)) < 300.0, \
            t["prn"]


@slow
def test_independent_capture_decode(tmp_path):
    signs, truth = _generate(tmp_path, cib=3, duration_ms=7800, cn0=48,
                             seed=5, repeats=2)
    prns = tuple(s["prn"] for s in truth["sats"])
    cfg = ReceiverConfig(
        prns=prns,
        track=TrackConfig(codes_in_bit=3, pll_bad_state_threshold=10**9),
        enable_position=False,
        track_block_epochs=400,
    )
    report = Receiver(cfg, device="cpu").run(reference_to_baseband(signs))
    by_prn = {s["prn"]: s for s in truth["sats"]}
    for ch in report.channels:
        t = by_prn[ch.prn]
        assert ch.state_name == "TRACKING", ch.prn
        assert abs(ch.doppler_hz - t["doppler_hz"]) < 15.0, ch.prn
        assert ch.subframe_count >= 3, (ch.prn, ch.subframe_count)
        assert ch.eph.has_full_set, (ch.prn, hex(ch.eph.received_mask_proc))
        assert ch.eph.week == truth["week"]
        assert ch.eph.iode == t["eph"]["iode"]
        assert abs(ch.eph.A - t["eph"]["sqrtA"] ** 2) < 1e-3
        assert abs(ch.eph.toes - t["eph"]["toes"]) < 1e-9
        for attr, key in EPH_FIELDS.items():
            got, want = getattr(ch.eph, attr), t["eph"][key]
            assert got == pytest.approx(want, rel=1e-12, abs=1e-21), (
                ch.prn, attr, got, want)


@slow
def test_independent_capture_to_fix(tmp_path):
    signs, truth = _generate(tmp_path, cib=20, duration_ms=29000, cn0=48,
                             seed=5, repeats=1)
    prns = tuple(s["prn"] for s in truth["sats"])
    report = Receiver(ReceiverConfig(prns=prns, track_block_epochs=1000),
                      device="cpu").run(reference_to_baseband(signs))
    for ch in report.channels:
        assert ch.eph.has_full_set, ch.prn
    assert report.solutions, "no position fix from the independent capture"
    err = np.linalg.norm(report.solutions[-1].rr - np.array(truth["rr_ecef"]))
    assert err < 500.0, f"position error {err:.1f} m vs planted truth"
