"""Single-point positioning: weighted Gauss-Newton least squares.

The non-iterative ``pntpos`` shape of the firmware's RTKLIB-derived
solver (``solving.c:153-181`` / ``estpos`` :376-449 / ``rescode``
:711-794 / ``lsq`` :1452-1470) with the same geometry (Sagnac-corrected
geometric distance, az/el, elevation weighting), correction models
(Klobuchar, Saastamoinen, TGD) and convergence criterion (|dx|^2 < 1e-8,
<=10 iterations).  The firmware's time-sliced variants are MCU real-time
artifacts with no counterpart here.

NX=7 state like the firmware (x,y,z, receiver clock, 3 spare inter-system
biases constrained to 0, solving.c:31, rescode's rank-deficiency rows
:784-792).
"""

from __future__ import annotations

from dataclasses import dataclass, field as dfield
from typing import Dict, List, Optional

import numpy as np

from ..config import CLIGHT
from .atmosphere import ionocorr, tropcorr
from .ephpos import satposs
from .gpstime import GTime, timeadd

NX = 7            # solving.c:31
MAXITR = 10       # solving.c:30
EFACT_GPS = 1.0   # solving.c:37
EVAR = 0.003      # solving.c:39

RE_WGS84 = 6378137.0              # solving.c:33
FE_WGS84 = 1.0 / 298.257223563    # solving.c:34
OMGE = 7.2921151467e-5


@dataclass
class Obs:
    """One pseudorange observation (obsd_t, rtk_common.h:52-61)."""

    sat: int
    time: GTime
    P: float                  # pseudorange, m
    D: float = 0.0            # Doppler, Hz
    snr: float = 0.0
    L: float = 0.0            # carrier phase, cycles (integrated Doppler)


@dataclass
class Solution:
    """Receiver solution (sol_t equivalent)."""

    ok: bool = False
    time: GTime = dfield(default_factory=GTime)
    rr: np.ndarray = dfield(default_factory=lambda: np.zeros(3))
    dtr_s: float = 0.0
    qr: np.ndarray = dfield(default_factory=lambda: np.zeros(6))
    ns: int = 0
    pos_llh: np.ndarray = dfield(default_factory=lambda: np.zeros(3))
    azel_deg: Optional[np.ndarray] = None
    residuals: Optional[np.ndarray] = None
    iterations: int = 0
    vel: Optional[np.ndarray] = None       # ECEF velocity, m/s
    dtr_drift_s: float = 0.0               # clock drift, s/s
    excluded_sat: Optional[int] = None     # RAIM-excluded PRN, if any


def ecef2pos(r):
    """ECEF -> geodetic (lat, lon, h) rad/m, WGS84 (solving.c:1225-1238)."""
    e2 = FE_WGS84 * (2.0 - FE_WGS84)
    r = np.asarray(r, dtype=float)
    r2 = r[0] ** 2 + r[1] ** 2
    z, zk, v = r[2], 0.0, RE_WGS84
    while abs(z - zk) >= 1e-4:
        zk = z
        sinp = z / np.sqrt(r2 + z * z)
        v = RE_WGS84 / np.sqrt(1.0 - e2 * sinp * sinp)
        z = r[2] + v * e2 * sinp
    lat = np.arctan(z / np.sqrt(r2)) if r2 > 1e-12 else (
        np.pi / 2.0 if r[2] > 0 else -np.pi / 2.0
    )
    lon = np.arctan2(r[1], r[0]) if r2 > 1e-12 else 0.0
    return np.array([lat, lon, np.sqrt(r2 + z * z) - v])


def pos2ecef(pos):
    """Geodetic (lat, lon, h) -> ECEF (inverse of ecef2pos)."""
    lat, lon, h = pos
    e2 = FE_WGS84 * (2.0 - FE_WGS84)
    v = RE_WGS84 / np.sqrt(1.0 - e2 * np.sin(lat) ** 2)
    return np.array([
        (v + h) * np.cos(lat) * np.cos(lon),
        (v + h) * np.cos(lat) * np.sin(lon),
        (v * (1.0 - e2) + h) * np.sin(lat),
    ])


def xyz2enu(pos):
    """ECEF->ENU rotation at geodetic pos (solving.c:1289-1296)."""
    sinp, cosp = np.sin(pos[0]), np.cos(pos[0])
    sinl, cosl = np.sin(pos[1]), np.cos(pos[1])
    return np.array([
        [-sinl, cosl, 0.0],
        [-sinp * cosl, -sinp * sinl, cosp],
        [cosp * cosl, cosp * sinl, sinp],
    ])


def geodist(rs, rr):
    """Sagnac-corrected geometric distance + LOS unit vector
    (solving.c:1248-1258)."""
    if np.linalg.norm(rs[:3]) < RE_WGS84:
        return -1.0, np.zeros(3)
    e = rs[:3] - rr
    r = np.linalg.norm(e)
    e = e / r
    return r + OMGE * (rs[0] * rr[1] - rs[1] * rr[0]) / CLIGHT, e


def satazel(pos, e):
    """Azimuth/elevation of LOS vector (solving.c:1268-1280)."""
    az, el = 0.0, np.pi / 2.0
    if pos[2] > -RE_WGS84:
        enu = xyz2enu(pos) @ e
        az = 0.0 if enu[0] ** 2 + enu[1] ** 2 < 1e-12 else np.arctan2(
            enu[0], enu[1]
        )
        if az < 0.0:
            az += 2 * np.pi
        el = np.arcsin(np.clip(enu[2], -1.0, 1.0))
    return np.array([az, el])


def _varerr(el):
    """Elevation-dependent measurement variance (solving.c:591-597)."""
    varr = EVAR**2 * (EVAR**2 + EVAR**2 / np.sin(el))
    return EFACT_GPS**2 * varr


def rescode(obs_list, rs, dts, vare, svh, eph_map, x, ion_params=None):
    """Pseudorange residuals + design matrix (solving.c:711-794).

    Returns (v, H, var, azel, ns) with the firmware's rank-deficiency
    constraint rows for the 3 unused inter-system biases appended.
    """
    rr = x[:3]
    pos = ecef2pos(rr)
    v, rows, var = [], [], []
    azel = np.zeros((len(obs_list), 2))
    ns = 0
    for i, obs in enumerate(obs_list):
        r, e = geodist(rs[i], rr)
        if r <= 0.0:
            continue
        azel[i] = satazel(pos, e)
        if azel[i][1] < 0.0:
            continue
        if svh[i]:
            continue
        eph = eph_map.get(obs.sat)
        tgd_m = CLIGHT * eph.tgd if eph is not None else 0.0
        P = obs.P - tgd_m
        dion, vion = ionocorr(obs.time, ion_params, pos, azel[i])
        dtrp, vtrp = tropcorr(pos, azel[i])
        v.append(P - (r + dion + dtrp + x[3] - CLIGHT * dts[i][0]))
        row = np.zeros(NX)
        row[:3] = -e
        row[3] = 1.0
        rows.append(row)
        var.append(_varerr(azel[i][1]) + vare[i] + vion + vtrp)
        ns += 1
    # constraint rows for unused bias states (solving.c:784-792)
    for k in range(4, NX):
        v.append(0.0)
        row = np.zeros(NX)
        row[k] = 1.0
        rows.append(row)
        var.append(0.01)
    return (np.asarray(v), np.asarray(rows), np.asarray(var), azel, ns)


def lsq(H, v):
    """Normal-equation least squares: x = (H'H)^-1 H'v, Q = (H'H)^-1
    (solving.c:1452-1470; LU inversion replaced by numpy solve).
    Degenerate geometry (coincident satellites, rank-deficient H) must
    surface as a failed SOLUTION, not an exception out of the receiver
    loop — return None like the firmware's lsq() error code path."""
    A = H.T @ H
    try:
        Q = np.linalg.inv(A)
    except np.linalg.LinAlgError:
        return None, None
    dx = Q @ (H.T @ v)
    if not np.all(np.isfinite(dx)):
        return None, None
    return dx, Q


def estpos(obs_list, rs, dts, vare, svh, eph_map, x0=None, ion_params=None):
    """Gauss-Newton position estimate (estpos, solving.c:376-449)."""
    x = np.zeros(NX)
    if x0 is not None:
        x[:3] = x0[:3]
    sol = Solution()
    for it in range(MAXITR):
        v, H, var, azel, ns = rescode(
            obs_list, rs, dts, vare, svh, eph_map, x, ion_params
        )
        if len(v) < NX:
            break
        sig = np.sqrt(var)
        vw = v / sig
        Hw = H / sig[:, None]
        dx, Q = lsq(Hw, vw)
        if dx is None:
            break
        x += dx
        if float(dx @ dx) < 1e-8:  # solving.c:420
            sol.ok = True
            sol.time = timeadd(obs_list[0].time, -x[3] / CLIGHT)
            sol.dtr_s = x[3] / CLIGHT
            sol.rr = x[:3].copy()
            sol.qr = np.array([Q[0, 0], Q[1, 1], Q[2, 2],
                               Q[0, 1], Q[1, 2], Q[0, 2]])
            sol.ns = ns
            sol.pos_llh = ecef2pos(sol.rr)
            sol.azel_deg = np.degrees(azel)
            # only the ns contributing observations produced residual
            # rows; the remaining entries of v are the constraint rows
            # for the unused bias states (the firmware masks with vsat,
            # solving.c:744) -- including them would dilute the RAIM /
            # max_resid_rms_m RMS.
            sol.residuals = v[:ns]
            sol.iterations = it + 1
            return sol
    sol.iterations = MAXITR
    return sol


def solve_velocity(obs_list, rs, sol: Solution) -> bool:
    """Receiver velocity + clock drift from Doppler observations.

    The firmware never computes velocity (sol_t rr[3:6] stays zero,
    solving.c:426).  Model: the measured range rate
    ``-lambda_L1 * D_i`` equals ``e_i . (v_sat - v_rx) + ddtr`` with
    ``e_i`` the receiver->satellite unit vector; linear least squares in
    (v_rx, ddtr).  Requires sol.ok (uses the fixed position's geometry).
    Fills sol.vel (m/s, ECEF) and sol.dtr_drift_s.
    """
    lam = CLIGHT / 1.57542e9
    rows, y = [], []
    for i, obs in enumerate(obs_list):
        if obs.D == 0.0:
            # D == 0.0 is the "Doppler unavailable" default; treating it
            # as a real 0 Hz range rate would corrupt the velocity fit.
            continue
        r, e = geodist(rs[i], sol.rr)
        if r <= 0:
            continue
        rdot_meas = -lam * obs.D
        rows.append(np.concatenate([-e, [1.0]]))
        y.append(rdot_meas - e @ rs[i][3:6])
    if len(rows) < 4:
        return False
    H = np.asarray(rows)
    yv = np.asarray(y)
    dx, _ = lsq(H, yv)
    if dx is None:
        return False
    sol.vel = dx[:3]
    sol.dtr_drift_s = dx[3] / CLIGHT
    return True


def solution_plausible(
    sol: Solution,
    min_altitude_m: float = -1000.0,
    max_altitude_m: float = 100_000.0,
    min_clock_bias_ms: float = -19.0,
    max_clock_bias_ms: float = 3.0,
    max_speed_mps: float = 600.0,
) -> bool:
    """Physical plausibility gate for a converged solution.

    At exactly 4 satellites a single channel whose nav-bit grid settled
    an integer number of ms wrong produces a CONVERGED, zero-residual,
    wrong fix (4 obs / 4 unknowns — no redundancy for RAIM or the
    residual-RMS gate).  But the wrong fix is not physically plausible:
    a 1-3 ms grid fault moves the altitude by 700-2500 km and the
    receiver clock bias by the same scale (measured in test_pvt), while
    a terrestrial receiver sits within ~[-1, +100] km of the ellipsoid.

    The clock-bias window is ASYMMETRIC because pseudoranges are formed
    with the firmware's relative convention ``P_ref = 68.802 ms * c``
    (GPS_OFFSET_TIME_MS, gps_master.c:31): the solved bias is then
    ``68.802 ms - TOF_ref`` plus the true (sub-ms, TOW-derived) clock
    error, and the reference satellite's TOF physically spans
    [~67.3 ms zenith, ~86 ms horizon] -> legitimate bias in about
    [-17.2, +1.5] ms.  Common-mode SV clock error also lands here:
    the broadcast af0 field spans +/-(2^21)*2^-31 s ~ +/-0.98 ms
    (IS-GPS-200 20.3.3.3.1.8), so the window carries +/-1 ms margin.

    The Doppler-implied speed is the sharpest discriminator when
    Doppler observations exist: at a wrong position the satellite LOS
    geometry is wrong, so the velocity fit must absorb ~|dLOS| x 3.9
    km/s of mismatch — measured km/s-scale implied speed for a fix a
    few Mm off, vs <1 m/s at the true position (test_pvt).  The
    capability class of the firmware's commented-out ``valsol``
    residual check (solving.c:436-439), extended with the geometry-free
    constraints the firmware never used.
    """
    if not sol.ok:
        return False
    alt = float(sol.pos_llh[2])
    if not (min_altitude_m <= alt <= max_altitude_m):
        return False
    if min_clock_bias_ms < max_clock_bias_ms and not (
        min_clock_bias_ms <= sol.dtr_s * 1e3 <= max_clock_bias_ms
    ):
        return False
    if (max_speed_mps > 0.0 and sol.vel is not None
            and float(np.linalg.norm(sol.vel)) > max_speed_mps):
        return False
    return True


def identify_grid_fault(
    obs_list: List[Obs],
    eph_map: Dict[int, object],
    x0=None,
    ion_params=None,
    max_shift_ms: int = 4,
    min_altitude_m: float = -1000.0,
    max_altitude_m: float = 100_000.0,
    min_clock_bias_ms: float = -19.0,
    max_clock_bias_ms: float = 3.0,
    max_speed_mps: float = 600.0,
    resid_gate_m: float = 30.0,
):
    """Search for a single-channel integer-ms pseudorange fault.

    Hypothesis search over (channel, shift): re-solve with obs[i].P
    shifted by s ms of light time for every i and s in
    [-max_shift_ms, +max_shift_ms]\\{0}; a hypothesis survives when the
    corrected solution is plausible (solution_plausible) and its
    residual RMS stays under ``resid_gate_m``.  Returns
    ``(solution, obs_index, shift_ms)`` when exactly ONE hypothesis
    survives — a unique identification — else None (ambiguous or no
    fault found; callers must then reject the epoch).

    The sign convention matches the observables ledger: shift_ms > 0
    means the channel's subframe boundary was recorded shift_ms too
    EARLY (its pseudorange was short), so the channel's
    ``subframe_time_ms`` should be increased by shift_ms.
    """
    ms = CLIGHT * 1e-3
    survivors = []
    for i in range(len(obs_list)):
        for s in range(-max_shift_ms, max_shift_ms + 1):
            if s == 0:
                continue
            trial = [Obs(sat=o.sat, time=o.time, P=o.P, D=o.D, snr=o.snr,
                         L=o.L) for o in obs_list]
            trial[i].P += s * ms
            sol = pntpos(trial, eph_map, x0=x0, ion_params=ion_params)
            if not solution_plausible(sol, min_altitude_m, max_altitude_m,
                                      min_clock_bias_ms, max_clock_bias_ms,
                                      max_speed_mps):
                continue
            if sol.residuals is not None and len(sol.residuals) and \
                    float(np.sqrt(np.mean(sol.residuals**2))) > resid_gate_m:
                continue
            survivors.append((sol, i, s))
    if len(survivors) == 1:
        return survivors[0]
    return None


def pntpos(obs_list: List[Obs], eph_map: Dict[int, object],
           x0=None, ion_params=None, raim_threshold_m: float = 0.0
           ) -> Solution:
    """Single-point position from pseudoranges (pntpos, solving.c:153-181):
    satposs -> estpos.

    ``raim_threshold_m`` > 0 enables receiver-autonomous integrity
    monitoring when there is redundancy (>= 5 satellites): if the
    post-fit residual RMS exceeds the threshold, each satellite is
    excluded in turn and the subset with the smallest residuals wins
    (the capability class of the firmware's commented-out ``valsol``,
    solving.c:436-439).
    """
    if not obs_list:
        return Solution()
    rs, dts, var, svh, ok = satposs(obs_list[0].time, obs_list, eph_map)
    if not ok.all():
        return Solution()
    sol = estpos(obs_list, rs, dts, var, svh, eph_map, x0, ion_params)

    if (
        raim_threshold_m > 0.0
        and sol.ok
        and len(obs_list) >= 5
        and sol.residuals is not None
        and float(np.sqrt(np.mean(sol.residuals**2))) > raim_threshold_m
    ):
        best = None
        best_rms = float(np.sqrt(np.mean(sol.residuals**2)))
        excluded = None
        for skip in range(len(obs_list)):
            subset = [o for i, o in enumerate(obs_list) if i != skip]
            rs_s = np.delete(rs, skip, axis=0)
            dts_s = np.delete(dts, skip, axis=0)
            var_s = np.delete(var, skip, axis=0)
            svh_s = np.delete(svh, skip, axis=0)
            cand = estpos(subset, rs_s, dts_s, var_s, svh_s, eph_map,
                          x0, ion_params)
            if not cand.ok or cand.residuals is None:
                continue
            rms = float(np.sqrt(np.mean(cand.residuals**2)))
            if rms < best_rms:
                best, best_rms, excluded = cand, rms, skip
        if best is not None and best_rms <= raim_threshold_m:
            best.excluded_sat = obs_list[excluded].sat
            sol = best
            obs_list = [o for i, o in enumerate(obs_list)
                        if i != excluded]
            rs = np.delete(rs, excluded, axis=0)

    if sol.ok and any(o.D != 0.0 for o in obs_list):
        solve_velocity(obs_list, rs, sol)
    return sol
