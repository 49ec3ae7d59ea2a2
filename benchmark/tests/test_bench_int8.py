"""The ``real_int8`` front end (SoftGNSS's int8 real IF at 38.192 MHz):
its plain reference against the program's ingest, the resampler's lag
pinned on a noiseless planted satellite, the capture the front end makes
pinned, and cold starts on the CPU judged correct."""

import hashlib
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import gen, ref_real_int8, run, scene, spec, truth
from benchmark import physics as ph

from . import helpers

FS = 38192000.0
IF = 9548000.0
SPE = 38192
SEED = 2 ** 31 + 77


def _cfg():
    with open(os.path.join(helpers.HERE, "configs",
                           "softgnss_fs38_int8.json")) as f:
        return json.load(f)


def _window(seed, epochs=3):
    rng = np.random.default_rng(seed)
    x = np.round(rng.standard_normal(epochs * SPE) * 8.0)
    return np.clip(x, -127, 127).astype(np.int8)


def test_the_reference_designs_the_programs_taps():
    from stm32f4_sdr_gps_torch.signal import capture as cap

    np.testing.assert_array_equal(ref_real_int8.taps(FS),
                                  cap.if_resample_taps(FS))
    assert ref_real_int8.lag_s(FS) == cap.if_resample_plan(FS).lag_s
    assert ref_real_int8.ratio(FS) == (3, 56)


@pytest.mark.parametrize("seed", [1, 2])
def test_the_reference_holds_the_programs_ingest(seed):
    from stm32f4_sdr_gps_torch.signal.capture import if_to_baseband_device
    from stm32f4_sdr_gps_torch.signal.if_reference import (
        if_to_baseband_reference)

    x = _window(seed)
    want = ref_real_int8.to_baseband(x, FS, IF)
    rms = float(want.abs().pow(2).mean().sqrt())
    port_ref = if_to_baseband_reference(x, FS, IF)
    assert float((port_ref - want).abs().max()) <= 1e-12 * rms
    got = if_to_baseband_device(x, FS, IF, device="cpu")
    assert float((got.to(torch.complex128) - want).abs().max()) <= 1e-5 * rms


def _code_phase_fit(y, code):
    """The code phase (chips) at y's first sample of one whole period of
    a noiseless satellite at 2 samples a chip: the phase whose band-
    limited model, the rectangular chips' Fourier series below 0.7 MHz,
    lines up with y's spectrum.  The resampler's passband is real there
    once its lag is taken out, so the match peaks at the true phase."""
    n = y.size                                       # 2046
    k = np.arange(-700, 701)
    Y = np.fft.fft(y)[k % n]
    B = (np.fft.fft(code)[k % 1023] * np.sinc(k / 1023.0)
         * np.exp(-1j * np.pi * k / 1023.0))
    A = Y * np.conj(B)

    def match(phi):
        phi = np.atleast_1d(phi)[:, None]
        return np.abs((A[None, :] * np.exp(-2j * np.pi * k * phi
                                            / 1023.0)).sum(axis=1))

    coarse = np.arange(0.0, 1023.0, 1.0 / 16)
    best = coarse[np.argmax(np.concatenate([match(c) for c in
                                            np.array_split(coarse, 64)]))]
    fine = best + np.arange(-0.1, 0.1, 1e-4)
    return float(fine[np.argmax(match(fine))] % 1023.0)


@pytest.mark.parametrize("delay_ms", [3.21, 7.0004])
def test_lag_puts_a_noiseless_satellite_at_its_true_phase(delay_ms):
    fe = _cfg()["frontend"]
    mod = spec.frontend(fe["kind"])
    sat = SimpleNamespace(prn=7, doppler_hz=0.0, doppler_rate_hz_s=0.0,
                          delay_s=delay_ms * 1e-3, carrier_phase_cycles=0.3,
                          cn0_dbhz=50.0, bits=np.zeros(4, np.int64))
    sc = SimpleNamespace(sats=[sat], codes_in_bit=20)
    s = gen.signal_chunk(sc, fe, 0, 2 * SPE, "cpu").numpy()
    x = np.round(100.0 * s / np.abs(s).max()).astype(np.int8)
    y = mod.to_baseband(x, "cpu").numpy()[2046:]     # the second epoch
    got = _code_phase_fit(y.astype(np.complex128), ph.ca_bipolar(7))
    want = truth.code_phase_at(sat, 1e-3 + mod.lag_s(fe))
    assert truth.chip_error(got, want) < 0.02
    # without the lag the phase is 1.7 chips off
    assert truth.chip_error(got, truth.code_phase_at(sat, 1e-3)) > 1.5


#: the capture the front end makes of the configuration: 6 epochs at seed
#: 2**31 + 77 (scene and noise) in chunks of 4 on the CPU; SHA-256 of its
#: bytes, its dtype and length, and ``truth.frontend_lag_s``
MADE = ("3ab29b366c7669c1a9df24840587780869b95d8874733a161dd921c781af7141",
        np.int8, 6 * SPE, -1.6713796955732439e-06)


def test_front_end_makes_its_capture():
    digest, dtype, n, lag = MADE
    cfg = _cfg()
    fe = cfg["frontend"]
    mod = spec.frontend(fe["kind"])
    sc = scene.build(cfg, SEED, 0, 0.006)
    x = gen.synthesize(sc, fe, 6, SEED, "cpu", chunk_epochs=4, frontend=mod)
    assert x.dtype == dtype and x.shape == (n,)
    assert hashlib.sha256(x.tobytes()).hexdigest() == digest
    assert mod.units_per_epoch(fe) * 6 == n
    assert truth.frontend_lag_s(fe, mod) == lag
    # the quantiser: 8 LSB of noise, saturated at +-127
    assert 7.5 < x.astype(np.float64).std() < 8.5
    assert np.abs(x.astype(np.int16)).max() <= 127


def test_front_end_takes_only_the_sources_rates():
    mod = spec.frontend("real_int8")
    with pytest.raises(ValueError):
        mod.units_per_epoch(dict(_cfg()["frontend"], sample_rate_hz=16368e3))


def test_coldstarts_on_the_cpu_are_correct(tmp_path):
    """The cell's front end and ingest on the firmware's four-satellite
    sky, three cold starts on the CPU through the plain resampler."""
    cfg = helpers.config()
    cfg["frontend"] = _cfg()["frontend"]
    traffic = dict(helpers.WIRE_COLDSTART, capture_epochs=300,
                   warm_starts=0)
    cell = helpers.write_cell(str(tmp_path), traffic, cfg)
    r = run.Run(cell, SEED, "cpu")
    r.setup()
    r.window(0.01)
    for _ in range(2):
        r._coldstart()
    ok, attempted, failed, rows = r.judge()
    assert ok and attempted == 3 and failed == 0, rows
