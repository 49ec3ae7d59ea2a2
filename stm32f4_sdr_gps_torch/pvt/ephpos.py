"""Broadcast-ephemeris satellite position/velocity/clock.

Vectorized float64 host implementation of the RTKLIB-derived chain in the
firmware's solver (``solving.c``): ``eph2clk`` (:1044-1054), ``eph2pos``
Kepler solve (:1165-1216), ``ephpos`` velocity-by-differencing
(:1118-1140) — identical models and constants.  The firmware's
time-sliced ``*_iterative`` variants are 1 ms-budget MCU artifacts and
intentionally have no counterpart here (SURVEY.md §7).

Host NumPy (not jnp) because PVT needs float64 (pseudoranges ~2e7 m to
mm) and runs on tiny data (N<=32 satellites) at solution cadence.
"""

from __future__ import annotations

import numpy as np

from ..config import CLIGHT
from .gpstime import GTime, timeadd, timediff

MU_GPS = 3.9860050e14        # gravitational constant (solving.c:24)
OMGE = 7.2921151467e-5       # earth rotation rate, rad/s (solving.c:25)
RTOL_KEPLER = 1e-14          # solving.c:26
MAX_ITER_KEPLER = 30         # solving.c:27
MAXDTOE_S = 7200.0           # GPS ephemeris validity (RTKLIB MAXDTOE)

_URA_VALUES = np.array(
    [2.4, 3.4, 4.85, 6.85, 9.65, 13.65, 24.0, 48.0, 96.0, 192.0,
     384.0, 768.0, 1536.0, 3072.0, 6144.0]
)


def var_uraeph(ura: int) -> float:
    """URA index -> variance (solving.c:1143-1150)."""
    if ura < 0 or ura > 14:
        return 6144.0 ** 2
    return float(_URA_VALUES[ura] ** 2)


def eph2clk(time: GTime, eph) -> float:
    """Satellite clock bias from broadcast polynomial, 2-iteration
    inversion (solving.c:1044-1054)."""
    t = timediff(time, eph.toc)
    for _ in range(2):
        t = timediff(time, eph.toc) - (eph.f0 + eph.f1 * t + eph.f2 * t * t)
    return eph.f0 + eph.f1 * t + eph.f2 * t * t


def eph2pos(time: GTime, eph):
    """Kepler solve -> (pos_ecef[3], clock_bias_s, var_m2)
    (solving.c:1165-1216), including the relativity correction."""
    if eph.A <= 0.0:
        return np.zeros(3), 0.0, 0.0
    tk = timediff(time, eph.toe)

    n0 = np.sqrt(MU_GPS / eph.A ** 3)
    M = eph.M0 + (n0 + eph.deln) * tk
    E, Ek = M, 0.0
    for _ in range(MAX_ITER_KEPLER):
        if abs(E - Ek) <= RTOL_KEPLER:
            break
        Ek = E
        E -= (E - eph.e * np.sin(E) - M) / (1.0 - eph.e * np.cos(E))
    sinE, cosE = np.sin(E), np.cos(E)

    u = np.arctan2(np.sqrt(1.0 - eph.e**2) * sinE, cosE - eph.e) + eph.omg
    r = eph.A * (1.0 - eph.e * cosE)
    i = eph.i0 + eph.idot * tk
    sin2u, cos2u = np.sin(2 * u), np.cos(2 * u)
    u += eph.cus * sin2u + eph.cuc * cos2u
    r += eph.crs * sin2u + eph.crc * cos2u
    i += eph.cis * sin2u + eph.cic * cos2u
    x, y = r * np.cos(u), r * np.sin(u)
    cosi = np.cos(i)

    O = eph.OMG0 + (eph.OMGd - OMGE) * tk - OMGE * eph.toes
    sinO, cosO = np.sin(O), np.cos(O)
    pos = np.array([
        x * cosO - y * cosi * sinO,
        x * sinO + y * cosi * cosO,
        y * np.sin(i),
    ])

    tk_c = timediff(time, eph.toc)
    dts = eph.f0 + eph.f1 * tk_c + eph.f2 * tk_c * tk_c
    dts -= 2.0 * np.sqrt(MU_GPS * eph.A) * eph.e * sinE / CLIGHT**2
    return pos, float(dts), var_uraeph(eph.sva)


def ephpos(time: GTime, eph):
    """Position+velocity+clock(+drift) by differential approximation
    (solving.c:1118-1140).  Returns (rs[6], dts[2], var, svh)."""
    tt = 1e-3
    rs = np.zeros(6)
    dts = np.zeros(2)
    p0, c0, var = eph2pos(time, eph)
    p1, c1, _ = eph2pos(timeadd(time, tt), eph)
    rs[:3] = p0
    rs[3:] = (p1 - p0) / tt
    dts[0] = c0
    dts[1] = (c1 - c0) / tt
    return rs, dts, var, eph.svh


def satposs(sol_time: GTime, obs_list, eph_map):
    """Satellite positions/clocks for a set of observations
    (solving.c:910-963): signal transmit time from pseudorange, clock
    correction, then position at transmit time.

    ``obs_list``: iterable of objects with .sat, .P (m), .time (GTime);
    ``eph_map``: {sat: Ephemeris}.
    Returns (rs (n,6), dts (n,2), var (n,), svh (n,), ok (n,) bool).
    """
    n = len(obs_list)
    rs = np.zeros((n, 6))
    dts = np.zeros((n, 2))
    var = np.zeros(n)
    svh = np.zeros(n, dtype=int)
    ok = np.zeros(n, dtype=bool)
    for i, obs in enumerate(obs_list):
        eph = eph_map.get(obs.sat)
        if eph is None or eph.A <= 0.0:
            continue
        t = timeadd(obs.time, -obs.P / CLIGHT)
        # ephemeris aging: Kepler extrapolation degrades past the fit
        # interval — RTKLIB's MAXDTOE gate (the firmware, running
        # minutes at a time, never ages out; a long-running framework
        # job must).  Aged satellites drop out like unhealthy ones.
        if abs(timediff(t, eph.toe)) > MAXDTOE_S:
            continue
        dt = eph2clk(t, eph)
        t = timeadd(t, -dt)
        rs[i], dts[i], var[i], svh[i] = ephpos(t, eph)
        ok[i] = True
    return rs, dts, var, svh, ok
