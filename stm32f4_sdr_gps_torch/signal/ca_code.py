"""GPS L1 C/A PRN code generation (IS-GPS-200).

Equivalent capability to the firmware's ``gps_generate_prn``
(``Firmware/project_main/GPS/gps_misc.c:317-372``), which
uses a G2-delay table.  We generate the codes from the two 10-stage LFSRs
with per-PRN G2 phase-select taps (the IS-GPS-200 definition); the G2-delay
table is kept only as an independent test oracle
(:data:`G2_DELAY_CHIPS`, tests/test_ca_code.py).

Conventions:
* chip bits are 0/1 with the first transmitted chip at index 0
* bipolar mapping is ``+1`` for bit 0 and ``-1`` for bit 1 (BPSK)
"""

from __future__ import annotations

import functools

import numpy as np

from ..config import CODE_LENGTH

# G2 phase-select taps for PRN 1..32 (IS-GPS-200 table 3-Ia), 1-indexed
# register stages. PRN i output = G1 xor (G2[t1] xor G2[t2]).
_PHASE_TAPS = {
    1: (2, 6), 2: (3, 7), 3: (4, 8), 4: (5, 9), 5: (1, 9), 6: (2, 10),
    7: (1, 8), 8: (2, 9), 9: (3, 10), 10: (2, 3), 11: (3, 4), 12: (5, 6),
    13: (6, 7), 14: (7, 8), 15: (8, 9), 16: (9, 10), 17: (1, 4), 18: (2, 5),
    19: (3, 6), 20: (4, 7), 21: (5, 8), 22: (6, 9), 23: (1, 3), 24: (4, 6),
    25: (5, 7), 26: (6, 8), 27: (7, 9), 28: (8, 10), 29: (1, 6), 30: (2, 7),
    31: (3, 8), 32: (4, 9),
}

# Equivalent G2 delays in chips for PRN 1..32 — the representation the
# firmware uses (gps_misc.c:319-341, first 32 entries). Used as a test
# oracle only, never for generation.
G2_DELAY_CHIPS = (
    5, 6, 7, 8, 17, 18, 139, 140, 141, 251,
    252, 254, 255, 256, 257, 258, 469, 470, 471, 472,
    473, 474, 509, 512, 513, 514, 515, 516, 859, 860,
    861, 862,
)

MAX_PRN = 32


@functools.lru_cache(maxsize=None)
def _g1_g2_sequences() -> tuple:
    """Full-period outputs of G1 and all 10 G2 register stages."""
    r1 = np.ones(10, dtype=np.int8)
    r2 = np.ones(10, dtype=np.int8)
    g1 = np.empty(CODE_LENGTH, dtype=np.int8)
    g2_stages = np.empty((CODE_LENGTH, 10), dtype=np.int8)
    for i in range(CODE_LENGTH):
        g1[i] = r1[9]
        g2_stages[i] = r2
        fb1 = r1[2] ^ r1[9]            # taps 3,10
        fb2 = r2[1] ^ r2[2] ^ r2[5] ^ r2[7] ^ r2[8] ^ r2[9]  # taps 2,3,6,8,9,10
        r1 = np.roll(r1, 1)
        r2 = np.roll(r2, 1)
        r1[0] = fb1
        r2[0] = fb2
    return g1, g2_stages


@functools.lru_cache(maxsize=None)
def ca_code_bits(prn: int) -> np.ndarray:
    """1023-chip C/A code for ``prn`` (1..32) as 0/1 int8."""
    if not 1 <= prn <= MAX_PRN:
        raise ValueError(f"PRN must be in 1..{MAX_PRN}, got {prn}")
    g1, g2_stages = _g1_g2_sequences()
    t1, t2 = _PHASE_TAPS[prn]
    g2 = g2_stages[:, t1 - 1] ^ g2_stages[:, t2 - 1]
    out = (g1 ^ g2).astype(np.int8)
    out.setflags(write=False)
    return out


def ca_code_bipolar(prn: int, dtype=np.float32) -> np.ndarray:
    """C/A code as +/-1 (bit 0 -> +1, bit 1 -> -1)."""
    return (1 - 2 * ca_code_bits(prn).astype(np.int32)).astype(dtype)


def ca_table_bipolar(prns, dtype=np.float32) -> np.ndarray:
    """(len(prns), 1023) bipolar code table."""
    return np.stack([ca_code_bipolar(p, dtype) for p in prns])


def first_chips_octal(prn: int, n_chips: int = 10) -> int:
    """First ``n_chips`` chips as an octal integer (IS-GPS-200 table form)."""
    bits = ca_code_bits(prn)[:n_chips]
    val = 0
    for b in bits:
        val = (val << 1) | int(b)
    return int(oct(val)[2:])


def sample_code(
    code_bits: np.ndarray,
    code_phase_chips: float,
    samples_per_chip: float,
    num_samples: int,
) -> np.ndarray:
    """Sample a 1023-chip code at a fractional code phase (NumPy host path).

    ``code_phase_chips`` is the code phase of sample 0; sample ``k`` reads
    chip ``floor(code_phase + k/samples_per_chip) mod 1023``.  The device
    equivalent lives in :mod:`stm32f4_sdr_gps_torch.ops.replica`.
    """
    idx = (
        np.floor(code_phase_chips + np.arange(num_samples) / samples_per_chip)
        .astype(np.int64) % CODE_LENGTH
    )
    return code_bits[idx]
