"""Ionosphere (Klobuchar) and troposphere (Saastamoinen) models.

Same models and constants as the firmware's solver
(``solving.c:620-708``): broadcast Klobuchar with the 2004/1/1 default
coefficients, and standard-atmosphere Saastamoinen at 70% relative
humidity.
"""

from __future__ import annotations

import numpy as np

from ..config import CLIGHT
from .gpstime import GTime, time2gpst

ION_DEFAULT = np.array([
    0.1118e-07, -0.7451e-08, -0.5961e-07, 0.1192e-06,
    0.1167e+06, -0.2294e+06, -0.1311e+06, 0.1049e+07,
])  # solving.c:623-626

ERR_BRDCI = 0.5   # solving.c:38
ERR_SAAS = 0.3    # solving.c:42
REL_HUMI = 0.7    # solving.c:41


def ionmodel(t: GTime, ion, pos, azel) -> float:
    """Klobuchar broadcast iono delay on L1, meters (solving.c:620-660)."""
    if pos[2] < -1e3 or azel[1] <= 0:
        return 0.0
    if ion is None:
        ion = ION_DEFAULT
    else:
        ion = np.asarray(ion, dtype=float)
        if np.linalg.norm(ion) <= 0.0:
            ion = ION_DEFAULT

    psi = 0.0137 / (azel[1] / np.pi + 0.11) - 0.022
    phi = pos[0] / np.pi + psi * np.cos(azel[0])
    phi = np.clip(phi, -0.416, 0.416)
    lam = pos[1] / np.pi + psi * np.sin(azel[0]) / np.cos(phi * np.pi)
    phi += 0.064 * np.cos((lam - 1.617) * np.pi)

    tow, _ = time2gpst(t)
    tt = 43200.0 * lam + tow
    tt -= np.floor(tt / 86400.0) * 86400.0

    f = 1.0 + 16.0 * (0.53 - azel[1] / np.pi) ** 3
    amp = ion[0] + phi * (ion[1] + phi * (ion[2] + phi * ion[3]))
    per = ion[4] + phi * (ion[5] + phi * (ion[6] + phi * ion[7]))
    amp = max(amp, 0.0)
    per = max(per, 72000.0)
    x = 2.0 * np.pi * (tt - 50400.0) / per
    if abs(x) < 1.57:
        delay = 5e-9 + amp * (1.0 + x * x * (-0.5 + x * x / 24.0))
    else:
        delay = 5e-9
    return CLIGHT * f * delay


def ionocorr(t: GTime, ion, pos, azel):
    """(delay_m, variance) (solving.c:662-669)."""
    d = ionmodel(t, ion, pos, azel)
    return d, (d * ERR_BRDCI) ** 2


def tropmodel(pos, azel, humi: float = REL_HUMI) -> float:
    """Saastamoinen tropo delay, meters (solving.c:679-700)."""
    temp0 = 15.0
    if pos[2] < -100.0 or pos[2] > 1e4 or azel[1] <= 0:
        return 0.0
    hgt = max(pos[2], 0.0)
    pres = 1013.25 * (1.0 - 2.2557e-5 * hgt) ** 5.2568
    temp = temp0 - 6.5e-3 * hgt + 273.16
    e = 6.108 * humi * np.exp((17.15 * temp - 4684.0) / (temp - 38.45))
    z = np.pi / 2.0 - azel[1]
    trph = (
        0.0022768 * pres
        / (1.0 - 0.00266 * np.cos(2.0 * pos[0]) - 0.00028 * hgt / 1e3)
        / np.cos(z)
    )
    trpw = 0.002277 * (1255.0 / temp + 0.05) * e / np.cos(z)
    return trph + trpw


def tropcorr(pos, azel):
    """(delay_m, variance) (solving.c:702-708)."""
    d = tropmodel(pos, azel)
    return d, (ERR_SAAS / (np.sin(azel[1]) + 0.1)) ** 2
