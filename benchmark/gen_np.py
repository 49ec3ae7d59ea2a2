"""Frozen NumPy copy of the generator's noiseless signal and its wire
packing (the port's ``signal/simulator.py`` ``_simulate_chunk`` with a
delay polynomial, and ``signal/capture.py`` ``pack_bits_lsb16``), which
the CPU tests hold ``gen`` to."""

from __future__ import annotations

import numpy as np

from . import physics as ph


def signal_chunk(scene, fe: dict, sample0: int, n: int) -> np.ndarray:
    fs = fe["sample_rate_hz"]
    t = (sample0 + np.arange(n, dtype=np.float64)) / fs
    total = np.zeros(n, dtype=np.complex128 if fe["complex"] else np.float64)
    for sat in scene.sats:
        code = ph.ca_bipolar(sat.prn)
        dop_int = sat.doppler_hz * t + 0.5 * sat.doppler_rate_hz_s * t ** 2
        chip_total = ph.CODE_RATE_HZ * (t + dop_int / ph.FREQ_L1_HZ
                                        - sat.delay_s)
        chip_idx = np.floor(chip_total).astype(np.int64)
        c = code[chip_idx % ph.CODE_LENGTH]
        bits = np.asarray(sat.bits, dtype=np.int64)
        bit_idx = np.floor_divide(np.floor_divide(chip_idx, ph.CODE_LENGTH),
                                  scene.codes_in_bit) % len(bits)
        d = (1 - 2 * bits[bit_idx]).astype(np.float64)
        phase = sat.carrier_phase_cycles + fe.get("if_hz", 0.0) * t + dop_int
        amp = np.sqrt(10.0 ** (sat.cn0_dbhz / 10.0) / fs)
        if fe["complex"]:
            total += amp * d * c * np.exp(2j * np.pi * phase)
        else:
            total += amp * np.sqrt(2.0) * d * c * np.cos(2 * np.pi * phase)
    return total


def pack_words(signs: np.ndarray) -> np.ndarray:
    bits = (np.asarray(signs).reshape(-1) >= 0).astype(np.uint32)
    weights = 1 << np.arange(16, dtype=np.uint32)
    return (bits.reshape(-1, 16) @ weights).astype(np.uint16)
