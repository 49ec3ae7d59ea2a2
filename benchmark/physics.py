"""The GPS physics the benchmark's generator and reference share: C/A
codes, broadcast-ephemeris orbits, light time, the LNAV encoder.

A frozen copy, kept with the yardstick so that no change to the program
changes what the benchmark plants or expects: the C/A Gold codes
(IS-GPS-200 3.3.2.3), the Keplerian orbit and clock of a broadcast
ephemeris (IS-GPS-200 20.3.3.4.3, RTKLIB's ``eph2pos``), the
Sagnac-corrected geometric distance, and the LNAV subframe encoder with
its D29/D30 parity chaining (IS-GPS-200 20.3.5), copied from the port's
``signal/ca_code.py``, ``pvt/ephpos.py``, ``pvt/solve.py`` and
``signal/nav_message.py``.  Time is GPS seconds of the week as a float
(a resolution of ~6e-11 s, 2 cm of range, at a week's end).
"""

from __future__ import annotations

import functools

import numpy as np

CLIGHT = 299_792_458.0
FREQ_L1_HZ = 1.57542e9
CODE_RATE_HZ = 1.023e6
CODE_LENGTH = 1023
MU_GPS = 3.9860050e14
OMGE = 7.2921151467e-5
RE_WGS84 = 6378137.0
FE_WGS84 = 1.0 / 298.257223563
SC2RAD = 3.1415926535898
PREAMBLE_BITS = (1, 0, 0, 0, 1, 0, 1, 1)

P2_5 = 2.0 ** -5
P2_19 = 2.0 ** -19
P2_29 = 2.0 ** -29
P2_31 = 2.0 ** -31
P2_33 = 2.0 ** -33
P2_43 = 2.0 ** -43
P2_55 = 2.0 ** -55

_PHASE_TAPS = {
    1: (2, 6), 2: (3, 7), 3: (4, 8), 4: (5, 9), 5: (1, 9), 6: (2, 10),
    7: (1, 8), 8: (2, 9), 9: (3, 10), 10: (2, 3), 11: (3, 4), 12: (5, 6),
    13: (6, 7), 14: (7, 8), 15: (8, 9), 16: (9, 10), 17: (1, 4), 18: (2, 5),
    19: (3, 6), 20: (4, 7), 21: (5, 8), 22: (6, 9), 23: (1, 3), 24: (4, 6),
    25: (5, 7), 26: (6, 8), 27: (7, 9), 28: (8, 10), 29: (1, 6), 30: (2, 7),
    31: (3, 8), 32: (4, 9),
}


@functools.lru_cache(maxsize=None)
def _g1_g2() -> tuple:
    r1 = np.ones(10, dtype=np.int8)
    r2 = np.ones(10, dtype=np.int8)
    g1 = np.empty(CODE_LENGTH, dtype=np.int8)
    g2 = np.empty((CODE_LENGTH, 10), dtype=np.int8)
    for i in range(CODE_LENGTH):
        g1[i] = r1[9]
        g2[i] = r2
        fb1 = r1[2] ^ r1[9]
        fb2 = r2[1] ^ r2[2] ^ r2[5] ^ r2[7] ^ r2[8] ^ r2[9]
        r1 = np.roll(r1, 1)
        r2 = np.roll(r2, 1)
        r1[0] = fb1
        r2[0] = fb2
    return g1, g2


@functools.lru_cache(maxsize=None)
def _ca(prn: int) -> np.ndarray:
    g1, g2 = _g1_g2()
    t1, t2 = _PHASE_TAPS[prn]
    out = 1.0 - 2.0 * (g1 ^ g2[:, t1 - 1] ^ g2[:, t2 - 1]).astype(np.float64)
    out.setflags(write=False)
    return out


def ca_bipolar(prn: int) -> np.ndarray:
    """1023-chip C/A code of ``prn`` as float64 +/-1 (chip 0 -> +1)."""
    return _ca(prn).copy()


# -- orbits --------------------------------------------------------------

def eph2pos(t: float, eph: dict) -> tuple:
    """(ECEF position, clock bias s) at GPS seconds of week ``t``, the
    relativistic term included (IS-GPS-200 20.3.3.4.3)."""
    a = eph["A"]
    tk = t - eph["toes"]
    n = np.sqrt(MU_GPS / a ** 3) + eph["deln"]
    m = eph["M0"] + n * tk
    e_anom, prev = m, 0.0
    for _ in range(30):
        if abs(e_anom - prev) <= 1e-14:
            break
        prev = e_anom
        e_anom -= ((e_anom - eph["e"] * np.sin(e_anom) - m)
                   / (1.0 - eph["e"] * np.cos(e_anom)))
    sin_e, cos_e = np.sin(e_anom), np.cos(e_anom)
    u = np.arctan2(np.sqrt(1.0 - eph["e"] ** 2) * sin_e,
                   cos_e - eph["e"]) + eph["omg"]
    r = a * (1.0 - eph["e"] * cos_e)
    i = eph["i0"] + eph["idot"] * tk
    s2, c2 = np.sin(2 * u), np.cos(2 * u)
    u += eph["cus"] * s2 + eph["cuc"] * c2
    r += eph["crs"] * s2 + eph["crc"] * c2
    i += eph["cis"] * s2 + eph["cic"] * c2
    x, y = r * np.cos(u), r * np.sin(u)
    om = eph["OMG0"] + (eph["OMGd"] - OMGE) * tk - OMGE * eph["toes"]
    pos = np.array([x * np.cos(om) - y * np.cos(i) * np.sin(om),
                    x * np.sin(om) + y * np.cos(i) * np.cos(om),
                    y * np.sin(i)])
    tc = t - eph["toc_s"]
    dts = eph["f0"] + eph["f1"] * tc + eph["f2"] * tc * tc
    dts -= 2.0 * np.sqrt(MU_GPS * a) * eph["e"] * sin_e / CLIGHT ** 2
    return pos, float(dts)


def pos2ecef(lat: float, lon: float, h: float) -> np.ndarray:
    e2 = FE_WGS84 * (2.0 - FE_WGS84)
    v = RE_WGS84 / np.sqrt(1.0 - e2 * np.sin(lat) ** 2)
    return np.array([(v + h) * np.cos(lat) * np.cos(lon),
                     (v + h) * np.cos(lat) * np.sin(lon),
                     (v * (1.0 - e2) + h) * np.sin(lat)])


def geodist(rs: np.ndarray, rr: np.ndarray) -> float:
    """Sagnac-corrected geometric distance (m)."""
    return float(np.linalg.norm(rs - rr)
                 + OMGE * (rs[0] * rr[1] - rs[1] * rr[0]) / CLIGHT)


def elevation_deg(rs: np.ndarray, rr: np.ndarray, lat: float,
                  lon: float) -> float:
    up = np.array([np.cos(lat) * np.cos(lon), np.cos(lat) * np.sin(lon),
                   np.sin(lat)])
    los = (rs - rr) / np.linalg.norm(rs - rr)
    return float(np.degrees(np.arcsin(np.dot(los, up))))


def signal_delay(eph: dict, rr: np.ndarray, t_rx: float) -> float:
    """Transmit-to-receive delay (s) on the satellite's clock for a
    signal received at ``t_rx``: light time iterated, minus the
    satellite's clock bias (the pseudorange the satellite labels)."""
    tau = 0.075
    for _ in range(4):
        rs, dts = eph2pos(t_rx - tau, eph)
        tau = geodist(rs, rr) / CLIGHT - dts
    return tau


# -- LNAV encoder --------------------------------------------------------

_PARITY_TAPS = (
    (1, 2, 3, 5, 6, 10, 11, 12, 13, 14, 17, 18, 20, 23),
    (2, 3, 4, 6, 7, 11, 12, 13, 14, 15, 18, 19, 21, 24),
    (1, 3, 4, 5, 7, 8, 12, 13, 14, 15, 16, 19, 20, 22),
    (2, 4, 5, 6, 8, 9, 13, 14, 15, 16, 17, 20, 21, 23),
    (1, 3, 5, 6, 7, 9, 10, 14, 15, 16, 17, 18, 21, 22, 24),
    (3, 5, 6, 8, 9, 10, 11, 13, 15, 19, 22, 23, 24),
)
_PARITY_SEED_D29 = (True, False, True, False, False, True)


def _parity(src, d29: int, d30: int) -> list:
    out = []
    for taps, seed29 in zip(_PARITY_TAPS, _PARITY_SEED_D29):
        p = d29 if seed29 else d30
        for t in taps:
            p ^= src[t - 1]
        out.append(p)
    return out


def _solve_tail(src, d29: int, d30: int) -> list:
    """Bits 23-24 of the HOW and word 10 chosen so D29 = D30 = 0."""
    src = list(src)
    src[22] = src[23] = 0
    p = _parity(src, d29, d30)
    src[23] = p[4]
    src[22] = p[5] ^ src[23]
    return src


def _words(src240, d29: int, d30: int) -> tuple:
    out = []
    for w in range(10):
        src = list(src240[w * 24: (w + 1) * 24])
        if w in (1, 9):
            src = _solve_tail(src, d29, d30)
        tx = [b ^ d30 for b in src] + _parity(src, d29, d30)
        out.extend(tx)
        d29, d30 = tx[28], tx[29]
    return out, d29, d30


class _Bits:
    def __init__(self):
        self.bits: list = []

    def u(self, value: int, width: int):
        value = int(value) & ((1 << width) - 1)
        self.bits.extend((value >> i) & 1 for i in range(width - 1, -1, -1))


def _q(value: float, scale: float) -> int:
    return int(round(value / scale))


def _semi(rad: float) -> float:
    return (rad / SC2RAD + 1.0) % 2.0 - 1.0


def _header(pk: _Bits, tow_6s: int, sf_id: int):
    pk.bits.extend(PREAMBLE_BITS)
    pk.u(0, 16)
    pk.u(tow_6s, 17)
    pk.u(0, 2)
    pk.u(sf_id, 3)
    pk.u(0, 2)


def _subframe(eph: dict, sf_id: int, tow_6s: int) -> list:
    pk = _Bits()
    _header(pk, tow_6s, sf_id)
    if sf_id == 1:
        pk.u(eph["week"] % 1024, 10)
        pk.u(0, 2)
        pk.u(eph["sva"], 4)
        pk.u(eph["svh"], 6)
        pk.u(eph["iodc"] >> 8, 2)
        pk.u(0, 1 + 23 + 24 + 24 + 16)
        pk.u(_q(eph["tgd"], P2_31), 8)
        pk.u(eph["iodc"] & 0xFF, 8)
        pk.u(_q(eph["toc_s"], 16.0), 16)
        pk.u(_q(eph["f2"], P2_55), 8)
        pk.u(_q(eph["f1"], P2_43), 16)
        pk.u(_q(eph["f0"], P2_31), 22)
        pk.u(0, 2)
    elif sf_id == 2:
        pk.u(eph["iode"], 8)
        pk.u(_q(eph["crs"], P2_5), 16)
        pk.u(_q(eph["deln"] / SC2RAD, P2_43), 16)
        m0 = _q(_semi(eph["M0"]), P2_31)
        pk.u(m0 >> 24, 8)
        pk.u(m0 & 0xFFFFFF, 24)
        pk.u(_q(eph["cuc"], P2_29), 16)
        e = _q(eph["e"], P2_33)
        pk.u(e >> 24, 8)
        pk.u(e & 0xFFFFFF, 24)
        pk.u(_q(eph["cus"], P2_29), 16)
        sqa = _q(np.sqrt(eph["A"]), P2_19)
        pk.u(sqa >> 24, 8)
        pk.u(sqa & 0xFFFFFF, 24)
        pk.u(_q(eph["toes"], 16.0), 16)
        pk.u(0, 1 + 5 + 2)
    elif sf_id == 3:
        pk.u(_q(eph["cic"], P2_29), 16)
        om0 = _q(_semi(eph["OMG0"]), P2_31)
        pk.u(om0 >> 24, 8)
        pk.u(om0 & 0xFFFFFF, 24)
        pk.u(_q(eph["cis"], P2_29), 16)
        i0 = _q(_semi(eph["i0"]), P2_31)
        pk.u(i0 >> 24, 8)
        pk.u(i0 & 0xFFFFFF, 24)
        pk.u(_q(eph["crc"], P2_5), 16)
        om = _q(_semi(eph["omg"]), P2_31)
        pk.u(om >> 24, 8)
        pk.u(om & 0xFFFFFF, 24)
        pk.u(_q(eph["OMGd"] / SC2RAD, P2_43), 24)
        pk.u(eph["iode"], 8)
        pk.u(_q(eph["idot"] / SC2RAD, P2_43), 14)
        pk.u(0, 2)
    else:
        # almanac pages: pseudo-random filler, so no word repeats and
        # false-matches a preamble
        state = (sf_id * 2654435761 + tow_6s * 40503) & 0xFFFFFFFF
        for _ in range(192):
            state ^= (state << 13) & 0xFFFFFFFF
            state ^= state >> 17
            state ^= (state << 5) & 0xFFFFFFFF
            pk.bits.append(state & 1)
    assert len(pk.bits) == 240
    return pk.bits


def bitstream(eph: dict, first_tow_6s: int, subframe_ids) -> np.ndarray:
    """Transmitted LNAV bits (0/1 int8, 300 a subframe); subframe k's
    HOW carries ``first_tow_6s + k``, the TOW of its end."""
    d29 = d30 = 0
    out = []
    for k, sf_id in enumerate(subframe_ids):
        words, d29, d30 = _words(_subframe(eph, sf_id, first_tow_6s + k),
                                 d29, d30)
        out.extend(words)
    return np.asarray(out, dtype=np.int8)


def broadcast(eph: dict) -> dict:
    """The ephemeris as its LNAV fields carry it: every value at the
    resolution of its field, angles in radians, ``A`` in metres."""
    out = dict(eph)
    for k, sc in (("tgd", P2_31), ("f2", P2_55), ("f1", P2_43),
                  ("f0", P2_31), ("crs", P2_5), ("cuc", P2_29),
                  ("e", P2_33), ("cus", P2_29), ("cic", P2_29),
                  ("cis", P2_29), ("crc", P2_5)):
        out[k] = _q(eph[k], sc) * sc
    for k in ("toes", "toc_s"):
        out[k] = _q(eph[k], 16.0) * 16.0
    for k in ("M0", "OMG0", "i0", "omg"):
        out[k] = _q(_semi(eph[k]), P2_31) * P2_31 * SC2RAD
    for k in ("deln", "OMGd", "idot"):
        out[k] = _q(eph[k] / SC2RAD, P2_43) * P2_43 * SC2RAD
    out["A"] = (_q(np.sqrt(eph["A"]), P2_19) * P2_19) ** 2
    return out


#: each compared field and its resolution (radians for angles)
FIELD_QUANTUM = {
    "A": None, "e": P2_33, "i0": P2_31 * SC2RAD, "OMG0": P2_31 * SC2RAD,
    "omg": P2_31 * SC2RAD, "M0": P2_31 * SC2RAD, "deln": P2_43 * SC2RAD,
    "OMGd": P2_43 * SC2RAD, "idot": P2_43 * SC2RAD, "crc": P2_5,
    "crs": P2_5, "cuc": P2_29, "cus": P2_29, "cic": P2_29, "cis": P2_29,
    "toes": 16.0, "f0": P2_31, "f1": P2_43, "f2": P2_55, "tgd": P2_31,
    "iode": 1, "iodc": 1, "week": 1,
}
