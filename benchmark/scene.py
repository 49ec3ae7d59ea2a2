"""The sky of one capture, made on the host from the configuration and
the seed: which satellites are up, their broadcast ephemerides and LNAV
bit streams, and each one's signal delay as a quadratic in capture
time (delay, Doppler, Doppler rate from the light-time solution at the
start, middle and end of the capture).

Two kinds of sky, as the configuration's ``sky`` says:

* ``fixed``: the satellites, orbits and site that the configuration
  lists (the firmware's own capture generator, ``native/capture_gen``);
* ``open_sky``: a 32-satellite constellation of six planes; a site
  drawn from the seed among those that see at least ``visible`` of them
  above ``min_elevation_deg``, and the ``visible`` highest planted, each
  at a C/N0 that rises with elevation.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import physics as ph


@dataclass
class Sat:
    prn: int
    eph: dict                 # as broadcast (physics.broadcast)
    bits: np.ndarray          # transmitted LNAV bits, 0/1
    delay_s: float            # tau(0)
    doppler_hz: float         # -fL1 tau'(0)
    doppler_rate_hz_s: float  # -fL1 tau''(0)
    cn0_dbhz: float
    elevation_deg: float
    carrier_phase_cycles: float


@dataclass
class Scene:
    sats: list
    rr: np.ndarray            # receiver ECEF, m
    t0_gps_s: float           # GPS seconds of week at capture t = 0
    bit_s: float              # codes_in_bit ms
    codes_in_bit: int
    first_tow_6s: int         # HOW of the first subframe
    prefix_bits: int
    subframe_ids: tuple

    @property
    def prns(self) -> tuple:
        return tuple(s.prn for s in self.sats)

    def subframe_end_s(self, sat: Sat, k: int) -> float:
        """Capture time at which subframe k's last bit has arrived."""
        return sat.delay_s + (self.prefix_bits + 300 * (k + 1)) * self.bit_s


def _rng(seed: int, capture: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & 0xFFFFFFFFFFFFFFFF, capture,
                                  0x5C3E])


def _constellation(cfg: dict) -> list:
    """32 ephemerides: six planes 60 degrees apart, 6/6/5/5/5/5 slots,
    the configuration's orbit elements otherwise."""
    base = cfg["orbit"]
    ephs, prn = [], 1
    for plane, slots in enumerate((6, 6, 5, 5, 5, 5)):
        for j in range(slots):
            eph = dict(base)
            eph["OMG0"] = -np.pi + plane * np.pi / 3.0
            eph["M0"] = ((j * 2.0 * np.pi / slots + plane * 0.45 + np.pi)
                         % (2.0 * np.pi)) - np.pi
            eph["prn"] = prn
            ephs.append(eph)
            prn += 1
    return ephs


def _delay_fit(eph: dict, rr: np.ndarray, t0: float,
               span_s: float) -> tuple:
    """tau(t) = a + b t + c t^2 / 2 through the light-time solutions at
    t = 0, span/2 and span."""
    h = span_s / 2.0
    ta, tb, tc = (ph.signal_delay(eph, rr, t0 + x) for x in (0.0, h, 2 * h))
    b = (4.0 * tb - 3.0 * ta - tc) / (2.0 * h)
    c = (tc - 2.0 * tb + ta) / (h * h)
    return ta, b, c


def build(cfg: dict, seed: int, capture: int, span_s: float) -> Scene:
    """The scene of capture ``capture`` (0, 1, ...) of a run with
    ``seed``, good for ``span_s`` seconds of signal."""
    rng = _rng(seed, capture)
    sky = cfg["sky"]
    nav = cfg["nav"]
    first_tow_6s = int(nav["first_tow_6s"])
    prefix = int(nav["prefix_bits"])
    ids = tuple(nav["subframe_ids"]) * int(nav["repeats"])
    cib = int(nav.get("codes_in_bit", 20))
    bit_s = cib * 1e-3
    # the prefix starts leaving the satellites at t0 (their clocks)
    t0 = (first_tow_6s - 1) * 6.0 - prefix * bit_s
    if sky["kind"] == "fixed":
        lat, lon, h = (np.radians(sky["lat_deg"]),
                       np.radians(sky["lon_deg"]), sky["height_m"])
        ephs = []
        for s in sky["sats"]:
            eph = dict(cfg["orbit"])
            eph.update(s)
            ephs.append(eph)
        rr = ph.pos2ecef(lat, lon, h)
        chosen = []
        for eph in ephs:
            rs, _ = ph.eph2pos(t0, ph.broadcast(eph))
            chosen.append((eph, ph.elevation_deg(rs, rr, lat, lon)))
    else:
        ephs = _constellation(cfg)
        while True:
            lat = np.arcsin(rng.uniform(-1.0, 1.0) *
                            np.sin(np.radians(sky["max_abs_lat_deg"])))
            lon = rng.uniform(-np.pi, np.pi)
            h = float(rng.uniform(0.0, 500.0))
            rr = ph.pos2ecef(lat, lon, h)
            els = []
            for eph in ephs:
                rs, _ = ph.eph2pos(t0, ph.broadcast(eph))
                els.append((ph.elevation_deg(rs, rr, lat, lon), eph))
            up = sorted((e for e in els if e[0] >= sky["min_elevation_deg"]),
                        key=lambda e: -e[0])
            if len(up) >= sky["visible"]:
                chosen = [(eph, el) for el, eph in up[: sky["visible"]]]
                break
    lo, hi = sky["cn0_dbhz"]
    sats = []
    for eph, el in sorted(chosen, key=lambda c: c[0]["prn"]):
        b = ph.broadcast(eph)
        a, tau1, tau2 = _delay_fit(b, rr, t0, span_s)
        frac = np.clip((el - sky.get("min_elevation_deg", 0.0))
                       / (90.0 - sky.get("min_elevation_deg", 0.0)), 0, 1)
        sats.append(Sat(
            prn=int(eph["prn"]), eph=b,
            bits=np.concatenate([np.arange(prefix, dtype=np.int8) % 2,
                                 ph.bitstream(eph, first_tow_6s, ids)]),
            delay_s=a, doppler_hz=-ph.FREQ_L1_HZ * tau1,
            doppler_rate_hz_s=-ph.FREQ_L1_HZ * tau2,
            cn0_dbhz=float(lo + (hi - lo) * frac), elevation_deg=el,
            carrier_phase_cycles=float(rng.uniform())))
    return Scene(sats=sats, rr=rr, t0_gps_s=t0, bit_s=bit_s, codes_in_bit=cib,
                 first_tow_6s=first_tow_6s, prefix_bits=prefix,
                 subframe_ids=ids)
