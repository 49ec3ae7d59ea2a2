"""The plain reference and the comparison that decides ``correct``.

The reference is the truth the generator planted, worked out again
from the scene alone in float64 NumPy: which satellites are up, each
one's Doppler at any epoch, the ephemeris each one broadcasts as its
LNAV fields carry it, when each has sent subframes 1-3, which solve
ticks the configuration's cadence makes, and where the receiver is.  It
imports nothing of the program and reads nothing the program made: the
program's answers, collected by ``jobs`` as plain numbers, are what it
judges.

Numbers read from the answers; ``limits`` lists those compared, each
against its limit:

* ``missed_sats``: satellites in view that were not handed to tracking;
* ``false_acq_rate``: PRNs handed to tracking that are not in view, per
  PRN searched that is not in view (the detector's false-alarm rate;
  read and reported, not compared);
* ``eph_wrong``: satellites in view whose ephemeris at the end of a job
  is not the broadcast one, field for field at its LNAV resolution, or
  is missing though the satellite sent subframes 1-3 a grace before;
* ``fixes_missing``: solve ticks of the configuration's cadence after
  the fourth satellite's subframes 1-3 are in (and a grace) without a
  fix;
* ``fix_error_m``, ``fix_speed_mps``: the largest distance of any fix
  from the planted site, and the largest speed of any fix;
* ``handoff_doppler_max_hz``: the largest error, over every cold start
  and satellite in view, of the Doppler handed to tracking against the
  planted one at the handoff epoch;
* ``handoff_code_max_chips``: the same for the code phase handed to
  tracking, against the planted code phase at the centre of the handoff
  epoch's first sample as the front end forms it (``frontend_lag_s``).
"""

from __future__ import annotations

import numpy as np

from . import physics as ph

#: grace after the fourth satellite's subframe 3 before a fix is due
FIX_GRACE_S = 1.0


#: the receiver's baseband rate: 2 samples a chip
BASEBAND_HZ = 2.046e6


def doppler_at(sat, epoch: float) -> float:
    t = epoch * 1e-3
    return sat.doppler_hz + sat.doppler_rate_hz_s * t


def code_phase_at(sat, t: float) -> float:
    """The planted code phase, chips in [0, 1023), arriving at capture
    time ``t`` seconds."""
    dop = t * (sat.doppler_hz + 0.5 * sat.doppler_rate_hz_s * t)
    chips = ph.CODE_RATE_HZ * (t + dop / ph.FREQ_L1_HZ - sat.delay_s)
    return chips % ph.CODE_LENGTH


def frontend_lag_s(fe: dict) -> float:
    """Time from an epoch's start to the centre of its first baseband
    sample.  A wire front end's samples reach baseband summed ``fs /
    2.046 MHz`` at a time (the firmware's integrate-and-dump), so each
    baseband sample stands for the middle of its run; complex baseband
    is taken as it is."""
    if fe["complex"]:
        return 0.0
    d = int(round(fe["sample_rate_hz"] / BASEBAND_HZ))
    return (d - 1) / 2.0 / fe["sample_rate_hz"]


def chip_error(a: float, b: float) -> float:
    """|a - b| in chips, the shorter way round the 1023-chip code."""
    d = (a - b) % ph.CODE_LENGTH
    return min(d, ph.CODE_LENGTH - d)


def sat_ready_s(scene, sat) -> float:
    """Capture time by which ``sat`` has sent subframes 1-3."""
    ids = list(scene.subframe_ids)
    return max(scene.subframe_end_s(sat, ids.index(i)) for i in (1, 2, 3))


def ready_s(scene) -> float:
    """Capture time by which four satellites have sent subframes 1-3."""
    done = sorted(sat_ready_s(scene, s) for s in scene.sats)
    return done[min(3, len(done) - 1)]


def solve_ticks(start_epoch: int, end_epoch: int, block: int,
                period_ms: int) -> list:
    """Epochs (ms) at which the receiver attempts a fix: block ends at
    least ``period_ms`` after the last attempt, stamped one ms back."""
    out, last = [], 0
    for end in range(start_epoch + block, end_epoch + 1, block):
        if end - last >= period_ms:
            last = end
            out.append(end - 1)
    return out


def eph_matches(decoded: dict, sent: dict) -> bool:
    for k, q in ph.FIELD_QUANTUM.items():
        if q is None:                                   # A = sqrtA^2
            q = 2.0 * np.sqrt(sent["A"]) * ph.P2_19
        if not abs(float(decoded[k]) - float(sent[k])) <= 0.5 * q:
            return False
    return True


def check_replay(jobs: list, scenes: list, period_ms: int,
                 searched: tuple) -> dict:
    """Numbers of a set of finished replay jobs; fixes are due at the
    cadence the configuration states, ``period_ms``; ``searched`` is the
    PRNs the receiver searches."""
    n = dict(missed_sats=0, false_acq_rate=0.0, eph_wrong=0,
             fixes_missing=0, fix_error_m=0.0, fix_speed_mps=0.0)
    false = absent = 0
    for job in jobs:
        sc = scenes[job["capture"]]
        present = set(sc.prns)
        live = set(job["live"])
        n["missed_sats"] += len(present - live)
        false += len(live - present)
        absent += len(set(searched) - present)
        for s in sc.sats:
            eph = job["eph"].get(s.prn)
            if eph is None:
                due = (sat_ready_s(sc, s) + FIX_GRACE_S) * 1e3
                n["eph_wrong"] += job["end_epoch"] >= due
            elif not eph_matches(eph, s.eph):
                n["eph_wrong"] += 1
        fixes = {f[0]: f for f in job["fixes"]}
        due_from = (ready_s(sc) + FIX_GRACE_S) * 1e3
        for tick in solve_ticks(job["start_epoch"], job["end_epoch"],
                                job["block"], period_ms):
            if tick >= due_from and tick not in fixes:
                n["fixes_missing"] += 1
        for _, rr, vel in job["fixes"]:
            n["fix_error_m"] = max(n["fix_error_m"],
                                   float(np.linalg.norm(np.asarray(rr) - sc.rr)))
            if vel is not None:
                n["fix_speed_mps"] = max(n["fix_speed_mps"],
                                         float(np.linalg.norm(vel)))
    n["false_acq_rate"] = false / absent if absent else 0.0
    return n


def check_coldstart(starts: list, scenes: list, searched: tuple,
                    lag_s: float = 0.0, handoff: str = "handoff") -> dict:
    """Numbers of a set of cold starts; ``lag_s`` is the front end's
    ``frontend_lag_s``.  ``handoff="acq"`` judges the acquisition's own
    Doppler and code phase, at the window's first epoch, in the
    handoff's place (the control)."""
    missed = false = absent = 0
    dop_errs, code_errs = [], []
    for st in starts:
        sc = scenes[st["capture"]]
        by_prn = {s.prn: s for s in sc.sats}
        live = st["live"]
        missed += len(set(by_prn) - set(live))
        false += len(set(live) - set(by_prn))
        absent += len(set(searched) - set(by_prn))
        epoch = st["offset"] + (st["start_epoch"] if handoff == "handoff"
                                else 0)
        t = epoch * 1e-3 + lag_s
        for prn, dop, code in zip(live, st[handoff + "_doppler"],
                                  st[handoff + "_code"]):
            if prn in by_prn:
                sat = by_prn[prn]
                dop_errs.append(abs(dop - doppler_at(sat, epoch)))
                code_errs.append(chip_error(code, code_phase_at(sat, t)))
    return dict(missed_sats=missed,
                false_acq_rate=false / absent if absent else 0.0,
                handoff_doppler_max_hz=max(dop_errs, default=0.0),
                handoff_code_max_chips=max(code_errs, default=0.0))


def limits(cfg: dict, kind: str) -> dict:
    """Each compared number's limit for a cell of ``kind``.  The
    false-alarm rate is read and not compared (PERF.md)."""
    lim = cfg["limits"]
    if kind == "coldstart":
        return dict(missed_sats=0,
                    handoff_doppler_max_hz=lim["handoff_doppler_max_hz"],
                    handoff_code_max_chips=lim["handoff_code_max_chips"])
    return dict(missed_sats=0, eph_wrong=0, fixes_missing=0,
                fix_error_m=lim["fix_error_m"],
                fix_speed_mps=lim["fix_speed_mps"])


def judge(numbers: dict, lims: dict) -> tuple:
    """(correct, [[name, value, limit], ...]) in the limits' order."""
    rows = [[k, numbers[k], lims[k]] for k in lims]
    ok = all(v is not None and lim is not None and v <= lim
             for _, v, lim in rows)
    return ok, rows
