"""LNAV ephemeris field extraction (IS-GPS-200 subframes 1-3).

Host-side decode matching ``nav_data_decode.c:33-141`` field maps and
scale factors (P2_xx constants, rtk_common.h:9-32), including the week
rollover adjustment pinned to the build week (``adjgpsweek``,
nav_data_decode.c:184-187).  Operates on the 300 source bits produced by
:mod:`stm32f4_sdr_gps_torch.nav.frame` (MSB-first field packing, identical
bit positions to the firmware's ``subframe_data``).
"""

from __future__ import annotations

from dataclasses import dataclass, field as dfield

from ..config import GPS_BUILD_WEEK
from ..pvt.gpstime import GTime, gpst2time

# Scale factors (rtk_common.h).
P2_5 = 2.0 ** -5
P2_19 = 2.0 ** -19
P2_29 = 2.0 ** -29
P2_31 = 2.0 ** -31
P2_33 = 2.0 ** -33
P2_43 = 2.0 ** -43
P2_55 = 2.0 ** -55
SC2RAD = 3.1415926535898


def getbitu(bits, pos: int, length: int) -> int:
    """Unsigned field [pos, pos+length) MSB-first (nav_data_decode.c:145).

    The firmware reads from LSB-first packed bytes; our framer keeps the
    subframe as a flat bit list, so this is a direct slice."""
    v = 0
    for b in bits[pos: pos + length]:
        v = (v << 1) | int(b)
    return v


def getbits(bits, pos: int, length: int) -> int:
    v = getbitu(bits, pos, length)
    if length > 0 and v & (1 << (length - 1)):
        v -= 1 << length
    return v


def getbitu2(bits, p1, l1, p2, l2) -> int:
    return (getbitu(bits, p1, l1) << l2) + getbitu(bits, p2, l2)


def getbits2(bits, p1, l1, p2, l2) -> int:
    if getbitu(bits, p1, 1):
        return (getbits(bits, p1, l1) << l2) + getbitu(bits, p2, l2)
    return getbitu2(bits, p1, l1, p2, l2)


def adjgpsweek(week: int, build_week: int = GPS_BUILD_WEEK) -> int:
    """10-bit week -> full week near the build week
    (nav_data_decode.c:184-187)."""
    return week + (build_week - week + 512) // 1024 * 1024


@dataclass
class Ephemeris:
    """Broadcast ephemeris (eph_t, gps_misc.h:148-165) + decode state
    (sdreph_t, gps_misc.h:167-182)."""

    sat: int = 0
    iode: int = 0
    iodc: int = 0
    sva: int = 0
    svh: int = 0
    week: int = 0
    code: int = 0
    flag: int = 0
    A: float = 0.0
    e: float = 0.0
    i0: float = 0.0
    OMG0: float = 0.0
    omg: float = 0.0
    M0: float = 0.0
    deln: float = 0.0
    OMGd: float = 0.0
    idot: float = 0.0
    crc: float = 0.0
    crs: float = 0.0
    cuc: float = 0.0
    cus: float = 0.0
    cic: float = 0.0
    cis: float = 0.0
    toes: float = 0.0
    fit: float = 0.0
    f0: float = 0.0
    f1: float = 0.0
    f2: float = 0.0
    tgd: float = 0.0
    toe: GTime = dfield(default_factory=GTime)
    toc: GTime = dfield(default_factory=GTime)
    ttr: GTime = dfield(default_factory=GTime)
    # decode bookkeeping
    tow_gpst: float = 0.0
    week_gpst: int = 0
    received_mask: int = 0        # bit n-1 set after subframe n (RTCM gate)
    received_mask_proc: int = 0   # not cleared (PVT gate, gps_master.c:414)
    decode_cnt: int = 0
    # per-subframe issue-of-data, -1 = subframe not decoded through the
    # tracker (ephemeris injected directly).  The firmware keeps a
    # commented-out oldiode check (nav_data_decode.c:85, :109) and will
    # happily mix subframes from two broadcast datasets across a
    # cutover; here a mixed set is held out of PVT until it re-matches.
    iode_sf2: int = -1
    iode_sf3: int = -1

    @property
    def dataset_consistent(self) -> bool:
        """IS-GPS-200 §20.3.4.4 matched-dataset rule: IODE(sf2) ==
        IODE(sf3) == 8 LSBs of IODC(sf1).  Subframes not decoded
        through the tracker (-1) are exempt so directly-injected
        ephemerides stay usable."""
        vals = [v for v in (self.iode_sf2, self.iode_sf3) if v >= 0]
        if (self.received_mask_proc & 1) and vals:
            vals.append(self.iodc & 0xFF)
        return len(set(vals)) <= 1

    @property
    def has_full_set(self) -> bool:
        """Subframes 1-3 decoded (mask 0x7, gps_master.c:414) AND from
        one broadcast dataset (IODE/IODC matched)."""
        return ((self.received_mask_proc & 0x7) == 0x7
                and self.dataset_consistent)


def decode_subframe(bits, eph: Ephemeris) -> int:
    """Dispatch on subframe ID and update ``eph`` in place; returns the ID
    (gps_nav_data_decode_subframe, nav_data_decode.c:33-51)."""
    sf_id = getbitu(bits, 49, 3)
    tow = getbitu(bits, 30, 17) * 6.0
    eph.tow_gpst = tow
    if sf_id == 1:
        week = getbitu(bits, 60, 10) + 1024
        eph.code = getbitu(bits, 70, 2)
        eph.sva = getbitu(bits, 72, 4)
        eph.svh = getbitu(bits, 76, 6)
        eph.iodc = getbitu2(bits, 82, 2, 210, 8)
        eph.flag = getbitu(bits, 90, 1)
        eph.tgd = getbits(bits, 196, 8) * P2_31
        toc = getbitu(bits, 218, 16) * 16.0
        eph.f2 = getbits(bits, 240, 8) * P2_55
        eph.f1 = getbits(bits, 248, 16) * P2_43
        eph.f0 = getbits(bits, 270, 22) * P2_31
        eph.week = adjgpsweek(week - 1024)
        eph.week_gpst = eph.week
        eph.ttr = gpst2time(eph.week, tow)
        eph.toc = gpst2time(eph.week, toc)
        eph.received_mask |= 1
        eph.received_mask_proc |= 1
    elif sf_id == 2:
        eph.iode = getbitu(bits, 60, 8)
        eph.iode_sf2 = eph.iode
        eph.crs = getbits(bits, 68, 16) * P2_5
        eph.deln = getbits(bits, 90, 16) * P2_43 * SC2RAD
        eph.M0 = getbits2(bits, 106, 8, 120, 24) * P2_31 * SC2RAD
        eph.cuc = getbits(bits, 150, 16) * P2_29
        eph.e = getbitu2(bits, 166, 8, 180, 24) * P2_33
        eph.cus = getbits(bits, 210, 16) * P2_29
        sqrt_a = getbitu2(bits, 226, 8, 240, 24) * P2_19
        eph.toes = getbitu(bits, 270, 16) * 16.0
        eph.fit = getbitu(bits, 286, 1)
        eph.A = sqrt_a * sqrt_a
        eph.toe = gpst2time(eph.week, eph.toes)
        eph.received_mask |= 2
        eph.received_mask_proc |= 2
    elif sf_id == 3:
        eph.cic = getbits(bits, 60, 16) * P2_29
        eph.OMG0 = getbits2(bits, 76, 8, 90, 24) * P2_31 * SC2RAD
        eph.cis = getbits(bits, 120, 16) * P2_29
        eph.i0 = getbits2(bits, 136, 8, 150, 24) * P2_31 * SC2RAD
        eph.crc = getbits(bits, 180, 16) * P2_5
        eph.omg = getbits2(bits, 196, 8, 210, 24) * P2_31 * SC2RAD
        eph.OMGd = getbits(bits, 240, 24) * P2_43 * SC2RAD
        eph.iode = getbitu(bits, 270, 8)
        eph.iode_sf3 = eph.iode
        eph.idot = getbits(bits, 278, 14) * P2_43 * SC2RAD
        eph.received_mask |= 4
        eph.received_mask_proc |= 4
    elif sf_id == 4:
        eph.received_mask |= 8
        eph.received_mask_proc |= 8
    elif sf_id == 5:
        eph.received_mask |= 16
        eph.received_mask_proc |= 16
    eph.decode_cnt += 1
    return sf_id
