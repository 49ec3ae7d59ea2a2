"""GPS time arithmetic (gtime_t equivalents).

Mirrors ``rtklib_common.c:26-73`` (timediff/gpst2time/timeadd/time2gpst)
with the same Unix↔GPS epoch offset.  Python ints keep the integer-second
part exact; the fractional part is a float64 in [0, 1).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..config import UNIX2GPS_S

SECONDS_PER_WEEK = 86400 * 7


@dataclass
class GTime:
    """Integer seconds + fraction (gtime_t, gps_misc.h:143-146)."""

    time: int = 0
    sec: float = 0.0

    def __float__(self):
        return self.time + self.sec


def gpst2time(week: int, sec: float) -> GTime:
    """(week, tow) -> GTime (rtklib_common.c:32-43)."""
    if sec < -1e9 or sec > 1e9:
        sec = 0.0
    t = UNIX2GPS_S + SECONDS_PER_WEEK * int(week) + int(sec)
    return GTime(time=t, sec=sec - int(sec))


def time2gpst(t: GTime):
    """GTime -> (tow_seconds, week) (rtklib_common.c:62-73)."""
    sec = t.time - UNIX2GPS_S
    week = sec // SECONDS_PER_WEEK
    return float(sec - week * SECONDS_PER_WEEK) + t.sec, int(week)


def timeadd(t: GTime, sec: float) -> GTime:
    total = t.sec + sec
    import math

    whole = math.floor(total)
    return GTime(time=t.time + whole, sec=total - whole)


def timediff(t1: GTime, t2: GTime) -> float:
    return (t1.time - t2.time) + (t1.sec - t2.sec)
