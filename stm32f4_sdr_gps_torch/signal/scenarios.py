"""Ready-made simulation scenarios.

The reference project's only fixture is a single-satellite square-wave
generator (project_single_sat/GPS/simulator.c); these scenarios give
users physically consistent multi-satellite captures where the planted
TOFs, Doppler and broadcast ephemerides all agree with one receiver
position — sufficient to drive the receiver to a position fix with a
known ground truth.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import numpy as np

from ..config import CLIGHT
from ..nav.ephemeris import Ephemeris
from ..pvt.ephpos import ephpos
from ..pvt.gpstime import gpst2time, timeadd
from ..pvt.solve import geodist, pos2ecef
from .nav_message import build_bitstream
from .simulator import SimSat, simulate_capture

WEEK = 2290
TOE = 352800.0

#: canonical broadcast values (field-representable at LNAV scale factors)
CANONICAL_EPH = dict(
    week=WEEK, iodc=57, iode=57, sva=2, svh=0, tgd=-1.2107193470e-08,
    toc_s=TOE, f0=2.5634365156e-04, f1=-3.5242919693e-12, f2=0.0,
    crs=-115.21875, deln=4.0465882771e-09, cuc=-6.0573220253e-06,
    e=0.0110899875, cus=5.1585957408e-06, A=26560278.1, toes=TOE, fit=0,
    cic=-1.1175870895e-08, cis=1.1548399925e-07, i0=0.9884864476,
    crc=287.46875, OMGd=-8.1625543586e-09, idot=-4.8930396158e-10,
    omg=0.6811469216,
)


def _make_eph(prn: int, m0: float, omg0: float) -> Ephemeris:
    eph = Ephemeris(sat=prn)
    for k, v in CANONICAL_EPH.items():
        if k in ("toc_s",):
            continue
        if hasattr(eph, k):
            setattr(eph, k, v)
    eph.M0 = m0
    eph.OMG0 = omg0
    eph.toe = gpst2time(WEEK, TOE)
    eph.toc = gpst2time(WEEK, TOE)
    eph.received_mask_proc = 0x7
    return eph


@dataclass
class FixScenario:
    samples: np.ndarray
    truth: object
    rr_true: np.ndarray
    eph_map: Dict[int, Ephemeris]
    prns: Tuple[int, ...]


def fix_scenario(
    num_epochs: int,
    cn0_dbhz: float = 48.0,
    seed: int = 21,
    lat_deg: float = 51.5,
    lon_deg: float = -0.1,
    height_m: float = 80.0,
    geom: Sequence[Tuple[float, float]] = (
        (1.5, 4.65), (0.5, 0.52), (2.0, 3.62), (1.5, 3.62),
    ),
    prns: Tuple[int, ...] = (2, 7, 15, 24),
    prefix_bits: int = 100,
    frame_repeats: int = 1,
    impairments=None,
    multipath: Dict[int, Tuple[float, float, float]] = None,
    codes_in_bit: int = 20,
) -> FixScenario:
    """4-satellite capture with geometry-consistent TOFs and Dopplers.

    Per satellite: the TOF of the signal arriving at capture t=0 comes
    from the planted receiver position and the (M0, OMG0) orbit; the
    Doppler is set from the true range rate so the simulator's
    code-Doppler drift reproduces the physical TOF evolution over the
    capture; the broadcast LNAV stream carries EXACTLY the planted
    ephemeris.  Subframe order (5,1,2,3,4): the leading subframe 5's TLM
    sacrificially resolves the 180-degree polarity ambiguity.
    """
    rr_true = pos2ecef(np.array([
        np.radians(lat_deg), np.radians(lon_deg), height_m
    ]))
    start_tow_6s = int(TOE + 60) // 6
    # Back-date capture t=0 by the PHYSICAL duration of the prefix +
    # first subframe (0.001*codes_in_bit per bit) so the first decoded
    # boundary's TOW label coincides with the planted physics.  With
    # compressed bits (codes_in_bit < 20) later boundaries still skew
    # (+6 s of TOW per +0.3*cib s of physics) — compressed-time fixes
    # are km-scale; only real 20 ms captures meet the <500 m bar.
    bit_s = 0.001 * codes_in_bit
    t_gps0 = gpst2time(
        WEEK, start_tow_6s * 6.0 - (prefix_bits + 300) * bit_s
    )
    lam_l1 = CLIGHT / 1.57542e9

    sats, eph_map = [], {}
    for prn, (m0, omg0) in zip(prns, geom):
        eph = _make_eph(prn, m0, omg0)
        d = dict(CANONICAL_EPH)
        d.update(M0=m0, OMG0=omg0)
        prefix = np.tile([0, 1], prefix_bits // 2).astype(np.int8)
        # frame_repeats > 1 rebroadcasts subframes 1-3 with correctly
        # advancing TOWs (the real 30 s frame cadence) so a weak-signal
        # receiver that loses one subframe to a cycle slip gets another
        # chance (IS-GPS-200 frame structure)
        body = build_bitstream(
            d, start_tow_6s=start_tow_6s - 1,
            num_subframes=5 * frame_repeats,
            subframe_ids=(5, 1, 2, 3, 4) * frame_repeats,
        )
        bits = np.concatenate([prefix, body])

        delay_s = 0.070
        for _ in range(3):
            t_tx = timeadd(t_gps0, -delay_s)
            rs, dts, _, _ = ephpos(t_tx, eph)
            rng_m, e = geodist(rs, rr_true)
            delay_s = rng_m / CLIGHT - dts[0]
        rdot = float(np.dot(rs[3:], e))
        mp_d, mp_a, mp_p = (multipath or {}).get(prn, (0.0, 0.0, 0.0))
        sats.append(SimSat(
            prn=prn, doppler_hz=float(-rdot / lam_l1), cn0_dbhz=cn0_dbhz,
            nav_bits=bits, delay_ms=float(delay_s * 1000.0),
            codes_in_bit=codes_in_bit,
            multipath_delay_chips=mp_d, multipath_amp=mp_a,
            multipath_phase_cycles=mp_p,
        ))
        eph_map[prn] = eph
    samples, truth = simulate_capture(sats, num_epochs=num_epochs,
                                      seed=seed, impairments=impairments)
    return FixScenario(samples=samples, truth=truth, rr_true=rr_true,
                       eph_map=eph_map, prns=tuple(prns))
