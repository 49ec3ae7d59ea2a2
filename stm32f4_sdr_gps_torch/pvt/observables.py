"""Observables assembly: relative pseudorange formation.

Implements the capability of ``gps_master_nav_handling`` /
``gps_master_final_pseudorange_calc`` (gps_master.c:159-329) on top of
the framework's explicit sample-index ledger, with one structural
improvement over the firmware:

The firmware combines the integer-ms subframe-boundary ledger with the
fractional code phase directly and patches up the two failure modes of
that split — bit-edge-vs-epoch rounding (the "accurate swap time"
refinement, nav_data.c:145-218) and code-phase wraps between subframes
(the +/-1 ms pending correction, gps_master.c:315-323).  We instead
*reconstruct* the true boundary arrival time

    arrival_ms = round(subframe_epoch_ms - frac_ms) + frac_ms,

where ``frac_ms = (1023 - code_phase_chips)/1023`` is the sub-ms signal
delay measured by the code NCO at the measurement epoch.  Because code
drift between subframes is microseconds (max ~3 chips/s of code
Doppler), the round() resolves the integer ambiguity exactly and absorbs
code wraps continuously — both firmware patch-ups become unnecessary.

Pseudoranges are then relative with the firmware's nominal offset:
``PR_i = (68.802 ms + arrival_i - arrival_ref) * c`` (gps_master.c:31,
324), reference satellite = earliest boundary (closest satellite,
gps_master.c:180-184).  The firmware's per-channel TDM skew term
(i * TRACKING_CH_LENGTH ms, gps_master.c:326-327) is identically zero
here because all channels sample the same epoch (SURVEY.md §7).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..config import CLIGHT, CODE_LENGTH, GPS_OFFSET_TIME_MS
from .gpstime import gpst2time
from .solve import Obs

CLIGHT_PER_MS = CLIGHT / 1000.0   # CLIGHT_NORM (gps_master.c:33)
LAMBDA_L1_M = CLIGHT / 1.57542e9  # L1 wavelength


@dataclass
class HatchState:
    """Carrier-smoothing filter state for one channel.

    The firmware has no carrier observable (obsd L=0,
    rtklib_common.c:84); here the integrated Doppler (accumulated
    carrier cycles from the tracking loop) propagates the pseudorange
    between measurements and a growing-window Hatch filter averages the
    code noise down.
    """

    pr_m: float = 0.0
    carrier_cycles: float = 0.0
    count: int = 0
    window: int = 100
    reset_threshold_m: float = 50.0
    last_update_ms: int = -1

    def update(self, pr_m: float, carrier_cycles: float,
               epoch_ms: int = -1) -> float:
        """Fold in a new (pseudorange, accumulated carrier) pair and
        return the smoothed pseudorange.

        Idempotent per measurement epoch: a second call with the same
        ``epoch_ms`` (two consumers — e.g. the solve and RTCM cadences —
        reading the same measurement) returns the already-smoothed value
        without folding again.  Without the guard a coincident-cadence
        epoch would double-weight one code measurement (both cadences
        land on the same epoch at every LCM, e.g. 500/200 ms → every
        1000 ms), silently shortening the filter window.  Calls at
        distinct epochs each fold one independent code measurement —
        that is the filter's intended semantics (window counts
        measurements, not seconds)."""
        if epoch_ms >= 0 and epoch_ms == self.last_update_ms \
                and self.count > 0:
            return self.pr_m
        self.last_update_ms = epoch_ms
        if self.count == 0:
            self.pr_m = pr_m
            self.carrier_cycles = carrier_cycles
            self.count = 1
            return pr_m
        # carrier-propagated prediction: positive Doppler = closing range
        delta_r = -LAMBDA_L1_M * (carrier_cycles - self.carrier_cycles)
        predicted = self.pr_m + delta_r
        if abs(pr_m - predicted) > self.reset_threshold_m:
            # code/carrier divergence (loop kick, slip): restart
            self.pr_m = pr_m
            self.carrier_cycles = carrier_cycles
            self.count = 1
            return pr_m
        k = min(self.count + 1, self.window)
        self.pr_m = pr_m / k + (predicted * (k - 1)) / k
        self.carrier_cycles = carrier_cycles
        self.count += 1
        return self.pr_m


@dataclass
class ChannelObservables:
    """Per-channel inputs to pseudorange formation."""

    prn: int
    subframe_time_ms: int        # receiver epoch of last subframe boundary
    tow_s: float                 # TOW labelling that boundary (from HOW)
    week: int
    code_phase_chips: float      # tracked code phase at the meas epoch
    doppler_hz: float
    snr_db: float


def boundary_arrival_ms(subframe_time_ms: int, code_phase_chips: float) -> float:
    """Reconstructed sub-ms arrival time of the subframe boundary,
    propagated to the measurement epoch by the code NCO (see module
    docstring)."""
    frac = (CODE_LENGTH - (code_phase_chips % CODE_LENGTH)) / CODE_LENGTH
    return float(np.round(subframe_time_ms - frac) + frac)


def form_observations(
    channels: List[ChannelObservables],
    meas_epoch_ms: int,
    max_spread_ms: float = 100.0,
    ref_prn: Optional[int] = None,
) -> Optional[List[Obs]]:
    """Form one obs set at ``meas_epoch_ms``; None if not ready.

    Channel boundaries are compared TOW-NORMALIZED: each boundary
    labels a known transmit time, so subtracting ``tow_s`` leaves the
    per-satellite time of flight, which must agree within
    ``max_spread_ms`` (the physical quantity behind the firmware's
    raw epoch-alignment gate, gps_master.c:199-201).  This tolerates a
    channel whose most recent decoded subframe is tens of seconds
    stale — its boundary reconstruction stays valid because the
    sub-ms part is propagated by the live code NCO
    (boundary_arrival_ms), good to ~±0.5 ms of TOF drift (several
    minutes of staleness at GPS dynamics).

    ``ref_prn`` pins the reference channel (the receiver-clock
    realization): the caller's carrier observables must share the SAME
    base or code-minus-carrier drifts at the reference range rate, so
    the receiver passes its sticky reference here.  Default (None, or
    a PRN not in ``channels``) keeps the firmware's earliest-boundary
    convention (closest satellite, gps_master.c:180-184).  A pinned
    reference can make other channels' relative TOF negative (closer
    satellite than the reference) — the solver's clock-bias estimate
    absorbs the common-mode choice either way.
    """
    if not channels or any(c.subframe_time_ms == 0 for c in channels):
        return None
    arrivals = np.array(
        [boundary_arrival_ms(c.subframe_time_ms, c.code_phase_chips)
         for c in channels]
    )
    tow_ms = np.array([c.tow_s for c in channels]) * 1000.0
    tof_like = arrivals - (tow_ms - tow_ms.min())
    if tof_like.max() - tof_like.min() > max_spread_ms:
        return None
    prns = [c.prn for c in channels]
    if ref_prn is not None and ref_prn in prns:
        ref = prns.index(ref_prn)
    else:
        ref = int(np.argmin(tof_like))
    ref_ch = channels[ref]
    elapsed_ms = meas_epoch_ms - arrivals[ref]
    if elapsed_ms < 0:
        return None

    tow = ref_ch.tow_s + elapsed_ms / 1000.0
    obs_time = gpst2time(ref_ch.week, tow)

    out: List[Obs] = []
    for ch, rel in zip(channels, tof_like - tof_like[ref]):
        pr = (GPS_OFFSET_TIME_MS + rel) * CLIGHT_PER_MS
        out.append(
            Obs(sat=ch.prn, time=obs_time, P=pr, D=ch.doppler_hz,
                snr=ch.snr_db)
        )
    return out
