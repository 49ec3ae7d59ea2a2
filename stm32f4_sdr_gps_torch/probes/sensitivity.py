"""The JAX package's sensitivity claims (tests/test_sensitivity.py:12-162)
as seven functions, their captures and bars copied here (so the port
needs nothing of that package).

* ``detect_36`` (:12-21): PRN 23 at 36 dBHz, 10 non-coherent epochs,
  detected within 300 Hz on at least 4 of 5 seeds;
* ``no_false_alarms`` (:24-30): PRN 22 searched in a capture of PRN 1 at
  45 dBHz, no detection on 6 seeds;
* ``integration_33`` (:33-42): PRN 6 at 33 dBHz detected within 300 Hz
  with 40 non-coherent epochs;
* ``lock_38`` (:45-65): ``track_block`` with ``TrackConfig()`` holds PRN 9
  at 38 dBHz for 1500 epochs: the last 200 epochs' mean Doppler within
  10 Hz, the last code phase within 0.5 chip;
* ``weak_track_29`` (:91-115): ``WEAK_SIGNAL_TRACK`` holds PRN 9 at
  29 dBHz for 3000 epochs: 8 Hz over the last 300, 0.3 chip;
* ``deep_acq_31`` (:118-133): ``DEEP_ACQ`` detects PRN 5 at 31 dBHz
  within 150 Hz and 1 chip where 60 epochs summed non-coherently at the
  same 100 Hz grid do not;
* ``ultra_acq_28`` (:136-162): ``ULTRA_ACQ`` (20 ms spans, 10 bit-edge
  hypotheses, a +/-2 kHz grid) detects PRN 17 at 28 dBHz with a peak ratio
  above 2.0, within 10 Hz and 0.5 chip, where ``DEEP_ACQ`` does not, and
  pure noise stays undetected.

Each function takes a ``device`` (the card by default; raises without
one unless given ``cpu``) and TrackConfig overrides where it tracks,
returns its record and raises SensitivityError when a bar fails.
Acquisition goes through ``acquire.engine.acquire`` (each result's peak
ratio beside the detection threshold in the record, so a near miss
shows); tracking through ``track.scan.track_block``, on the card the
tracking-scan kernel K1 in its default mode.  The captures come from the
port's simulator, the same samples as the JAX package's.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import (BASEBAND_PLAN, DEEP_ACQ, ULTRA_ACQ, WEAK_SIGNAL_TRACK,
                      AcqConfig, TrackConfig)
from .stress import phase_err, run_track

PLAN = BASEBAND_PLAN


class SensitivityError(AssertionError):
    """A bar of the sensitivity claims failed."""


def _require(ok, *msg) -> None:
    if not ok:
        raise SensitivityError(msg)


def _sim(num_epochs, seed, **sat):
    from ..signal.simulator import SimSat, simulate_capture

    return simulate_capture([SimSat(**sat)], num_epochs=num_epochs,
                            seed=seed)


def _acq(x, prn, cfg, device) -> dict:
    """One PRN's acquisition as a record: the verdict, the peak ratio
    beside the threshold it is held to."""
    from ..acquire.engine import acquire

    r = acquire(x, [prn], PLAN, cfg, device=device)[0]
    return {"detected": bool(r.detected), "doppler_hz": float(r.doppler_hz),
            "code_phase_chips": float(r.code_phase_chips),
            "peak_ratio": float(r.peak_ratio),
            "detect_ratio": cfg.detect_ratio}


# ------------------------------------------------------------ acquisition

DETECT_36 = dict(prn=23, doppler_hz=1234.0, code_phase_chips=321.0,
                 cn0_dbhz=36.0)


def detect_36_captures():
    """{seed: capture} of test_acquisition_detects_down_to_36dbhz."""
    return {seed: _sim(10, seed, **DETECT_36)[0] for seed in range(5)}


def detect_36(device="cuda") -> dict:
    runs = {s: _acq(x, 23, AcqConfig(), device)
            for s, x in detect_36_captures().items()}
    hits = sum(r["detected"] and abs(r["doppler_hz"] - 1234.0) < 300
               for r in runs.values())
    _require(hits >= 4, "detect_36: hits", hits, runs)
    return {"hits": hits, "runs": runs}


def no_false_alarms_captures():
    """{seed: capture} of test_acquisition_no_false_alarms_across_seeds."""
    return {100 + s: _sim(10, 100 + s, prn=1, doppler_hz=0.0,
                          cn0_dbhz=45.0)[0] for s in range(6)}


def no_false_alarms(device="cuda") -> dict:
    runs = {s: _acq(x, 22, AcqConfig(), device)
            for s, x in no_false_alarms_captures().items()}
    for s, r in runs.items():
        _require(not r["detected"], "no_false_alarms: seed", s, r)
    return {"runs": runs}


INTEGRATION_33 = AcqConfig(noncoherent_epochs=40)


def integration_33_capture():
    """test_more_integration_helps_weak_signals' capture."""
    return _sim(40, 3, prn=6, doppler_hz=-800.0, code_phase_chips=101.0,
                cn0_dbhz=33.0)[0]


def integration_33(device="cuda") -> dict:
    r = _acq(integration_33_capture(), 6, INTEGRATION_33, device)
    _require(r["detected"], "integration_33: not detected", r)
    _require(abs(r["doppler_hz"] + 800.0) < 300.0, "integration_33:", r)
    return {"r40": r}


DEEP_NC = AcqConfig(noncoherent_epochs=60, doppler_step_hz=100.0)


def deep_acq_31_capture():
    """test_deep_acquisition_coherent_gain's capture."""
    return _sim(60, 2, prn=5, doppler_hz=1730.0, code_phase_chips=512.0,
                cn0_dbhz=31.0)[0]


def deep_acq_31(device="cuda") -> dict:
    x = deep_acq_31_capture()
    r_nc = _acq(x, 5, DEEP_NC, device)
    r_co = _acq(x, 5, DEEP_ACQ, device)
    _require(not r_nc["detected"], "deep_acq_31: non-coherent detects", r_nc)
    _require(r_co["detected"], "deep_acq_31: DEEP_ACQ misses", r_co)
    _require(abs(r_co["doppler_hz"] - 1730.0) < 150.0, "deep_acq_31:", r_co)
    _require(abs(r_co["code_phase_chips"] - 512.0) < 1.0, "deep_acq_31:",
             r_co)
    return {"noncoherent": r_nc, "deep": r_co}


ULTRA_2K = dataclasses.replace(ULTRA_ACQ, doppler_span_hz=2000.0)
DEEP_2K = dataclasses.replace(DEEP_ACQ, doppler_span_hz=2000.0)


def ultra_acq_28_captures():
    """test_ultra_acq_detects_28dbhz_with_edge_hypotheses' two captures:
    PRN 17 with 40 random nav bits, and pure noise."""
    rng = np.random.default_rng(0)
    x, _ = _sim(130, 1, prn=17, doppler_hz=1200.0, code_phase_chips=300.0,
                cn0_dbhz=28.0, codes_in_bit=20,
                nav_bits=list(rng.integers(0, 2, 40)))
    noise = (np.random.default_rng(10).standard_normal(130 * 2046)
             + 1j * np.random.default_rng(110).standard_normal(130 * 2046)
             ).astype(np.complex64)
    return x, noise


def ultra_acq_28(device="cuda") -> dict:
    x, noise = ultra_acq_28_captures()
    ru = _acq(x, 17, ULTRA_2K, device)
    rd = _acq(x, 17, DEEP_2K, device)
    rn = _acq(noise, 17, ULTRA_2K, device)
    _require(ru["detected"] and ru["peak_ratio"] > 2.0, "ultra_acq_28:", ru)
    _require(abs(ru["doppler_hz"] - 1200.0) < 10.0, "ultra_acq_28:", ru)
    _require(abs(ru["code_phase_chips"] - 300.0) < 0.5, "ultra_acq_28:", ru)
    _require(not rd["detected"], "ultra_acq_28: DEEP_ACQ detects", rd)
    _require(not rn["detected"], "ultra_acq_28: noise detected", rn)
    return {"ultra": ru, "deep": rd, "noise": rn}


# --------------------------------------------------------------- tracking

#: {claim: (C/N0, epochs, initial Doppler, TrackConfig, Doppler bar over
#: the last n epochs (Hz, n), code bar (chip))}; PRN 9 at 900 Hz and
#: 400 chips, seed 4, entered 0.2 chip off
TRACK_CLAIMS = {
    "lock_38": (38.0, 1500, 915.0, TrackConfig(), (10.0, 200), 0.5),
    "weak_track_29": (29.0, 3000, 905.0, WEAK_SIGNAL_TRACK, (8.0, 300), 0.3),
}


def track_capture(name):
    """(samples, truth) of a tracking claim."""
    cn0, e = TRACK_CLAIMS[name][:2]
    return _sim(e, 4, prn=9, doppler_hz=900.0, code_phase_chips=400.0,
                cn0_dbhz=cn0)


def track_claim(name, device="cuda", **track):
    """A tracking claim through ``track_block`` under its TrackConfig (with
    ``track`` overrides): (final state, outputs, record); raises
    SensitivityError when a bar fails."""
    _, e, dop0, cfg, (dop_bar, n), cp_bar = TRACK_CLAIMS[name]
    x, truth = track_capture(name)
    st, outs = run_track(x, [9], [400.2], [dop0],
                         dataclasses.replace(cfg, **track), device)
    dop = outs.doppler_hz[:, 0].cpu().numpy()
    cp = outs.code_phase_chips[:, 0].cpu().numpy()
    rec = {"doppler_err_hz": float(np.mean(dop[-n:]) - 900.0),
           "code_err_chips": float(phase_err(
               cp[-1], truth.code_phase_at_epoch(0, e - 1)))}
    _require(abs(rec["doppler_err_hz"]) < dop_bar, name, rec)
    _require(abs(rec["code_err_chips"]) < cp_bar, name, rec)
    return st, outs, rec


def lock_38(device="cuda", **track) -> dict:
    return track_claim("lock_38", device, **track)[2]


def weak_track_29(device="cuda", **track) -> dict:
    return track_claim("weak_track_29", device, **track)[2]


#: the seven claims in the order of tests/test_sensitivity.py
CLAIMS = {"detect_36": detect_36, "no_false_alarms": no_false_alarms,
          "integration_33": integration_33, "lock_38": lock_38,
          "weak_track_29": weak_track_29, "deep_acq_31": deep_acq_31,
          "ultra_acq_28": ultra_acq_28}
