"""RTCM v3 encoder/decoder: framing, ephemeris 1019, MSM4/MSM5 obs.

The capability of the firmware's RTCM path (``GPS/RTK/rtcm3e.c`` +
``GPS/obs_publish.c``): 0xD3 framing with CRC-24Q (obs_publish.c:23-56,
101-136), GPS broadcast ephemeris message 1019 (rtcm3e.c:156-222) and
MSM observation messages 1074/1075 (rtcm3e.c:246-641).  A decoder is
included so round-trip integrity is testable without external tools
(the firmware could only emit).

Restrictions match the firmware: GPS only, signal L1 C/A (MSM signal
id 2).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..config import CLIGHT
from ..pvt.gpstime import time2gpst
from .bits import BitReader, BitWriter

RTCM_PREAMBLE = 0xD3
CRC24_POLY = 0x1864CFB

P2_5 = 2.0 ** -5
P2_19 = 2.0 ** -19
P2_29 = 2.0 ** -29
P2_31 = 2.0 ** -31
P2_33 = 2.0 ** -33
P2_43 = 2.0 ** -43
P2_55 = 2.0 ** -55
SC2RAD = 3.1415926535898

RANGE_MS = CLIGHT * 1e-3          # meters per millisecond of range
GPS_L1CA_SIGNAL_ID = 2            # MSM signal id for L1 C/A


def _crc_table():
    table = []
    for i in range(256):
        crc = i << 16
        for _ in range(8):
            crc <<= 1
            if crc & 0x1000000:
                crc ^= CRC24_POLY
        table.append(crc & 0xFFFFFF)
    return table


_CRC24 = _crc_table()


def crc24q(data: bytes) -> int:
    """CRC-24Q (obs_publish.c:23-64 table method)."""
    crc = 0
    for b in data:
        crc = ((crc << 8) & 0xFFFFFF) ^ _CRC24[(crc >> 16) ^ b]
    return crc


def frame(payload: bytes) -> bytes:
    """Wrap a payload in the RTCM3 transport frame
    (gen_rtcm3 framing, obs_publish.c:101-136)."""
    if len(payload) > 1023:
        raise ValueError("RTCM payload too long")
    hdr = bytes([RTCM_PREAMBLE, len(payload) >> 8, len(payload) & 0xFF])
    body = hdr + payload
    crc = crc24q(body)
    return body + bytes([crc >> 16, (crc >> 8) & 0xFF, crc & 0xFF])


def deframe(data: bytes) -> Optional[bytes]:
    """Validate one frame; returns the payload or None."""
    if len(data) < 6 or data[0] != RTCM_PREAMBLE:
        return None
    length = ((data[1] & 0x3) << 8) | data[2]
    if len(data) < 3 + length + 3:
        return None
    body = data[: 3 + length]
    crc = (data[3 + length] << 16) | (data[4 + length] << 8) | data[5 + length]
    if crc24q(body) != crc:
        return None
    return data[3: 3 + length]


# ---------------------------------------------------------------------------
# Message 1019: GPS broadcast ephemeris
# ---------------------------------------------------------------------------

def _q(value: float, scale: float) -> int:
    return int(round(value / scale))


def encode_1019(eph) -> bytes:
    """GPS ephemeris message (field order of encode_type1019,
    rtcm3e.c:156-222)."""
    w = BitWriter()
    toes, _ = (eph.toes, None)
    tow_toc, _ = time2gpst(eph.toc)
    w.set_u(1019, 12)
    w.set_u(eph.sat, 6)
    w.set_u(eph.week % 1024, 10)
    w.set_u(eph.sva, 4)
    w.set_u(eph.code, 2)
    w.set_s(_q(eph.idot / SC2RAD, P2_43), 14)
    w.set_u(eph.iode, 8)
    w.set_u(_q(tow_toc % 604800, 16.0), 16)
    w.set_s(_q(eph.f2, P2_55), 8)
    w.set_s(_q(eph.f1, P2_43), 16)
    w.set_s(_q(eph.f0, P2_31), 22)
    w.set_u(eph.iodc, 10)
    w.set_s(_q(eph.crs, P2_5), 16)
    w.set_s(_q(eph.deln / SC2RAD, P2_43), 16)
    w.set_s(_q(eph.M0 / SC2RAD, P2_31), 32)
    w.set_s(_q(eph.cuc, P2_29), 16)
    w.set_u(_q(eph.e, P2_33), 32)
    w.set_s(_q(eph.cus, P2_29), 16)
    w.set_u(_q(np.sqrt(eph.A), P2_19), 32)
    w.set_u(_q(eph.toes, 16.0), 16)
    w.set_s(_q(eph.cic, P2_29), 16)
    w.set_s(_q(eph.OMG0 / SC2RAD, P2_31), 32)
    w.set_s(_q(eph.cis, P2_29), 16)
    w.set_s(_q(eph.i0 / SC2RAD, P2_31), 32)
    w.set_s(_q(eph.crc, P2_5), 16)
    w.set_s(_q(eph.omg / SC2RAD, P2_31), 32)
    w.set_s(_q(eph.OMGd / SC2RAD, P2_43), 24)
    w.set_s(_q(eph.tgd, P2_31), 8)
    w.set_u(eph.svh, 6)
    w.set_u(eph.flag, 1)
    w.set_u(int(eph.fit), 1)
    w.pad_to_byte()
    return w.bytes()


def decode_1019(payload: bytes) -> dict:
    r = BitReader(payload)
    msg = r.get_u(12)
    assert msg == 1019
    out = {}
    out["sat"] = r.get_u(6)
    out["week"] = r.get_u(10)
    out["sva"] = r.get_u(4)
    out["code"] = r.get_u(2)
    out["idot"] = r.get_s(14) * P2_43 * SC2RAD
    out["iode"] = r.get_u(8)
    out["toc"] = r.get_u(16) * 16.0
    out["f2"] = r.get_s(8) * P2_55
    out["f1"] = r.get_s(16) * P2_43
    out["f0"] = r.get_s(22) * P2_31
    out["iodc"] = r.get_u(10)
    out["crs"] = r.get_s(16) * P2_5
    out["deln"] = r.get_s(16) * P2_43 * SC2RAD
    out["M0"] = r.get_s(32) * P2_31 * SC2RAD
    out["cuc"] = r.get_s(16) * P2_29
    out["e"] = r.get_u(32) * P2_33
    out["cus"] = r.get_s(16) * P2_29
    out["sqrtA"] = r.get_u(32) * P2_19
    out["toes"] = r.get_u(16) * 16.0
    out["cic"] = r.get_s(16) * P2_29
    out["OMG0"] = r.get_s(32) * P2_31 * SC2RAD
    out["cis"] = r.get_s(16) * P2_29
    out["i0"] = r.get_s(32) * P2_31 * SC2RAD
    out["crc"] = r.get_s(16) * P2_5
    out["omg"] = r.get_s(32) * P2_31 * SC2RAD
    out["OMGd"] = r.get_s(24) * P2_43 * SC2RAD
    out["tgd"] = r.get_s(8) * P2_31
    out["svh"] = r.get_u(6)
    out["flag"] = r.get_u(1)
    out["fit"] = r.get_u(1)
    return out


# ---------------------------------------------------------------------------
# MSM4 / MSM5 observations (messages 1074 / 1075)
# ---------------------------------------------------------------------------

@dataclass
class MsmObs:
    """One satellite's L1C/A observation for MSM encoding."""

    sat: int                 # PRN 1..32
    pseudorange_m: float
    doppler_hz: float = 0.0
    cn0_dbhz: float = 40.0
    lock_time_s: float = 0.0
    phaserange_m: float = 0.0   # carrier phaserange (0 = not available)
    # DF420: True until the receiver resolves the Costas half-cycle
    # ambiguity (nav polarity known -> carrier phase known mod 1 cycle,
    # not just mod 1/2)
    half_cycle_ambiguous: bool = True


_L1_WAVELENGTH = CLIGHT / 1.57542e9


def _lock_indicator(lock_time_s: float) -> int:
    """4-bit MSM lock time indicator (DF402)."""
    thresholds = [0.032, 0.064, 0.128, 0.256, 0.512, 1.024, 2.048, 4.096,
                  8.192, 16.384, 32.768, 65.536, 131.072, 262.144, 524.288]
    for i, t in enumerate(thresholds):
        if lock_time_s < t:
            return i
    return 15


def encode_msm(msg_type: int, tow_s: float, obs: List[MsmObs],
               station_id: int = 0, sync: bool = False) -> bytes:
    """MSM4 (1074) or MSM5 (1075) for GPS L1 C/A
    (encode_msm4/encode_msm5, rtcm3e.c:246-641)."""
    assert msg_type in (1074, 1075)
    msm5 = msg_type == 1075
    obs = sorted(obs, key=lambda o: o.sat)
    w = BitWriter()
    # MSM header
    w.set_u(msg_type, 12)
    w.set_u(station_id, 12)
    w.set_u(int(round(tow_s * 1000.0)) % (7 * 86400 * 1000), 30)
    w.set_u(1 if sync else 0, 1)
    w.set_u(0, 3)     # IODS
    w.set_u(0, 7)     # reserved
    w.set_u(0, 2)     # clock steering
    w.set_u(0, 2)     # external clock
    w.set_u(0, 1)     # smoothing
    w.set_u(0, 3)     # smoothing interval
    sat_mask = 0
    for o in obs:
        sat_mask |= 1 << (64 - o.sat)
    w.set_u(sat_mask, 64)
    w.set_u(1 << (32 - GPS_L1CA_SIGNAL_ID), 32)   # signal mask: L1C only
    for _ in obs:                                  # cell mask: all on
        w.set_u(1, 1)

    # satellite data.  Quantize once to 1/1024 ms so the rounding carry
    # propagates into the integer-ms field (a fractional part that
    # rounds to 1024 must increment the rough range, not wrap to 0).
    ranges_ms = [o.pseudorange_m / RANGE_MS for o in obs]
    rough_units = [int(round(r * 1024.0)) for r in ranges_ms]
    for u in rough_units:
        w.set_u(u >> 10, 8)                        # rough range, int ms
    if msm5:
        for o in obs:
            w.set_u(0, 4)                          # extended sat info
    for u in rough_units:
        w.set_u(u & 0x3FF, 10)
    if msm5:
        for o in obs:
            rate = -o.doppler_hz * _L1_WAVELENGTH  # range rate m/s
            w.set_s(int(round(rate)), 14)

    # signal data
    for u, rng in zip(rough_units, ranges_ms):
        fine = rng - u / 1024.0                    # ms
        w.set_s(int(round(fine / 2.0 ** -24)), 15)
    for o, u in zip(obs, rough_units):
        if o.phaserange_m:
            fine_ph = o.phaserange_m / RANGE_MS - u / 1024.0   # ms
            q = int(round(fine_ph / 2.0 ** -29))
            # DF401 range: clamp instead of wrapping
            q = max(min(q, (1 << 21) - 1), -(1 << 21))
            w.set_s(q, 22)
        else:
            w.set_s(-(1 << 21), 22)                # invalid marker
    for o in obs:
        w.set_u(_lock_indicator(o.lock_time_s), 4)
    for o in obs:
        w.set_u(1 if o.half_cycle_ambiguous else 0, 1)   # DF420
    for o in obs:
        w.set_u(int(round(o.cn0_dbhz)) & 0x3F, 6)
    if msm5:
        for o in obs:
            rate = -o.doppler_hz * _L1_WAVELENGTH
            w.set_s(int(round((rate - int(round(rate))) / 1e-4)), 15)
    w.pad_to_byte()
    return w.bytes()


def decode_msm(payload: bytes) -> dict:
    """Decode an MSM4/MSM5 GPS message produced by :func:`encode_msm`."""
    r = BitReader(payload)
    msg = r.get_u(12)
    assert msg in (1074, 1075)
    msm5 = msg == 1075
    out = {"msg": msg}
    out["station_id"] = r.get_u(12)
    out["tow_ms"] = r.get_u(30)
    out["sync"] = r.get_u(1)
    r.get_u(3 + 7 + 2 + 2 + 1 + 3)
    sat_mask = r.get_u(64)
    sats = [64 - i for i in range(64) if sat_mask & (1 << i)]
    sats.sort()
    sig_mask = r.get_u(32)
    assert sig_mask == 1 << (32 - GPS_L1CA_SIGNAL_ID)
    ncell = 0
    cells = []
    for _ in sats:
        cells.append(r.get_u(1))
        ncell += cells[-1]
    rough_int = [r.get_u(8) for _ in sats]
    if msm5:
        _ = [r.get_u(4) for _ in sats]
    rough_fine = [r.get_u(10) for _ in sats]
    rates = [r.get_s(14) for _ in sats] if msm5 else [0] * len(sats)
    fine = [r.get_s(15) for _ in range(ncell)]
    phase = [r.get_s(22) for _ in range(ncell)]
    locks = [r.get_u(4) for _ in range(ncell)]
    half = [r.get_u(1) for _ in range(ncell)]
    cnr = [r.get_u(6) for _ in range(ncell)]
    fine_rate = [r.get_s(15) for _ in range(ncell)] if msm5 else [0] * ncell
    obs = []
    for i, sat in enumerate(sats):
        rng_ms = rough_int[i] + rough_fine[i] / 1024.0 + fine[i] * 2.0 ** -24
        rate = rates[i] + fine_rate[i] * 1e-4
        ph_m = 0.0
        if phase[i] != -(1 << 21):
            ph_m = (rough_int[i] + rough_fine[i] / 1024.0
                    + phase[i] * 2.0 ** -29) * RANGE_MS
        obs.append(
            dict(sat=sat, pseudorange_m=rng_ms * RANGE_MS,
                 range_rate_ms=rate, cn0_dbhz=cnr[i], lock=locks[i],
                 phaserange_m=ph_m, half_cycle_ambiguous=bool(half[i]))
        )
    out["obs"] = obs
    return out
