"""GPS LNAV navigation-message *encoder* (IS-GPS-200).

The reference firmware only decodes nav data; its single test fixture
(``project_single_sat/GPS/simulator.c``) modulates no nav message at all.
Our simulator-based test strategy (SURVEY.md §4) needs real subframes with
valid parity so the decode chain (bit sync → preamble → parity → ephemeris,
``nav_data.c`` / ``nav_data_decode.c``) can be tested bit-exactly end to
end.  This module builds subframes 1-3 from an ephemeris dict using the
inverse of the scale factors in ``nav_data_decode.c:53-126`` and the D29/D30
parity chaining of ``nav_data.c:433-453``.
"""

from __future__ import annotations

import numpy as np

from ..config import PREAMBLE_BITS, WORD_LENGTH_BITS, WORDS_IN_SUBFRAME

# Parity XOR index sets (1-based data-bit indices d1..d24 feeding D25..D30),
# IS-GPS-200 table 20-XIV; same equations as nav_data.c:443-448.
_PARITY_TAPS = (
    (1, 2, 3, 5, 6, 10, 11, 12, 13, 14, 17, 18, 20, 23),
    (2, 3, 4, 6, 7, 11, 12, 13, 14, 15, 18, 19, 21, 24),
    (1, 3, 4, 5, 7, 8, 12, 13, 14, 15, 16, 19, 20, 22),
    (2, 4, 5, 6, 8, 9, 13, 14, 15, 16, 17, 20, 21, 23),
    (1, 3, 5, 6, 7, 9, 10, 14, 15, 16, 17, 18, 21, 22, 24),
    (3, 5, 6, 8, 9, 10, 11, 13, 15, 19, 22, 23, 24),
)
# Which previous parity bit (D29 or D30) seeds each equation.
_PARITY_SEED = ("D29", "D30", "D29", "D30", "D30", "D29")

# Scale factors (rtk_common.h:9-32).
P2_5 = 2.0 ** -5
P2_19 = 2.0 ** -19
P2_29 = 2.0 ** -29
P2_31 = 2.0 ** -31
P2_33 = 2.0 ** -33
P2_43 = 2.0 ** -43
P2_55 = 2.0 ** -55
SC2RAD = 3.1415926535898  # semicircle -> rad (rtk_common.h:45)


def word_parity(data_bits, d29: int, d30: int) -> list:
    """Compute D25..D30 from 24 *source* data bits and previous D29/D30."""
    assert len(data_bits) == 24
    parity = []
    for taps, seed in zip(_PARITY_TAPS, _PARITY_SEED):
        p = d29 if seed == "D29" else d30
        for t in taps:
            p ^= data_bits[t - 1]
        parity.append(p)
    return parity


def encode_word(data_bits, d29: int, d30: int) -> list:
    """Encode one 30-bit word: transmitted bits 1-24 are the source bits
    XOR previous D30 (IS-GPS-200 20.3.5.2); bits 25-30 are the parity of
    the *source* bits (the check in nav_data.c:439-449 un-inverts with D30
    before applying the equations, so this matches its acceptance rule)."""
    parity = word_parity(data_bits, d29, d30)
    tx = [b ^ d30 for b in data_bits] + parity
    assert len(tx) == WORD_LENGTH_BITS
    return tx


def _solve_tail_bits(src, d29: int, d30: int) -> list:
    """Solve source bits 23-24 of HOW / word-10 so the transmitted parity
    ends D29=D30=0 (IS-GPS-200 20.3.3.2), which keeps the following word's
    bits 1-24 non-inverted — this is why the TLM preamble is searchable in
    the raw stream (nav_data.c:381-391)."""
    src = list(src)
    src[22] = src[23] = 0
    p = word_parity(src, d29, d30)
    # D29 equation (index 4) contains d24 only; D30 (index 5) has d23+d24.
    src[23] = p[4]
    src[22] = p[5] ^ src[23]
    p = word_parity(src, d29, d30)
    assert p[4] == 0 and p[5] == 0
    return src


class _BitPacker:
    """Accumulates the 240 source data bits of a subframe (MSB-first
    fields), then emits parity-encoded 30-bit words."""

    def __init__(self):
        self.bits: list = []

    def u(self, value: int, width: int):
        value = int(value) & ((1 << width) - 1)
        for i in range(width - 1, -1, -1):
            self.bits.append((value >> i) & 1)

    def s(self, value: int, width: int):
        self.u(value & ((1 << width) - 1), width)


def _wrap_semicircles(rad: float) -> float:
    """Wrap an angle in radians to [-pi, pi) semicircle field range."""
    x = rad / SC2RAD
    return (x + 1.0) % 2.0 - 1.0


def _scaled(value: float, scale: float, width: int, signed: bool) -> int:
    q = int(round(value / scale))
    lim = 1 << (width - 1) if signed else 1 << width
    if signed:
        if not -lim <= q < lim:
            raise ValueError(f"value {value} does not fit s{width} @ {scale}")
    else:
        if not 0 <= q < lim:
            raise ValueError(f"value {value} does not fit u{width} @ {scale}")
    return q


def _subframe_words(data_bits, d29: int, d30: int):
    """Split 10x24 source bits into parity-chained transmitted words."""
    assert len(data_bits) == 240
    words = []
    for w in range(WORDS_IN_SUBFRAME):
        src = list(data_bits[w * 24: (w + 1) * 24])
        if w in (1, 9):
            src = _solve_tail_bits(src, d29, d30)
        tx = encode_word(src, d29, d30)
        words.append(tx)
        # Next word chains on the *transmitted* parity bits 29/30, exactly
        # what the decoder latches (nav_data.c:427-428).
        d29, d30 = tx[28], tx[29]
    return words, d29, d30


def _header_bits(pk: _BitPacker, tow_6s: int, subframe_id: int):
    """TLM + HOW words (source-bit level)."""
    for b in PREAMBLE_BITS:          # TLM preamble
        pk.bits.append(b)
    pk.u(0, 14)                      # TLM message
    pk.u(0, 2)                       # integrity/reserved
    pk.u(tow_6s, 17)                 # HOW: truncated TOW count (6 s units)
    pk.u(0, 2)                       # alert / anti-spoof
    pk.u(subframe_id, 3)             # subframe ID
    pk.u(0, 2)                       # parity-solve placeholder bits 23-24


def encode_subframe1(eph: dict, tow_6s: int) -> list:
    """Subframe 1 source bits.  Field map inverse of decode_subfrm1
    (nav_data_decode.c:53-80)."""
    pk = _BitPacker()
    _header_bits(pk, tow_6s, 1)
    pk.u(eph["week"] % 1024, 10)
    pk.u(eph.get("code", 0), 2)
    pk.u(eph.get("sva", 0), 4)
    pk.u(eph.get("svh", 0), 6)
    iodc = int(eph.get("iodc", 0))
    pk.u(iodc >> 8, 2)               # IODC MSBs (bits 83-84)
    pk.u(0, 1)                       # L2P flag
    pk.u(0, 23)                      # reserved (word 4 fill)
    pk.u(0, 24)                      # reserved word 5
    pk.u(0, 24)                      # reserved word 6
    pk.u(0, 16)                      # reserved word 7 high
    pk.s(_scaled(eph.get("tgd", 0.0), P2_31, 8, True), 8)
    pk.u(iodc & 0xFF, 8)
    pk.u(_scaled(eph["toc_s"], 16.0, 16, False), 16)
    pk.s(_scaled(eph.get("f2", 0.0), P2_55, 8, True), 8)
    pk.s(_scaled(eph.get("f1", 0.0), P2_43, 16, True), 16)
    pk.s(_scaled(eph.get("f0", 0.0), P2_31, 22, True), 22)
    pk.u(0, 2)
    assert len(pk.bits) == 240, len(pk.bits)
    return pk.bits


def encode_subframe2(eph: dict, tow_6s: int) -> list:
    """Subframe 2 source bits (inverse of decode_subfrm2,
    nav_data_decode.c:82-105)."""
    pk = _BitPacker()
    _header_bits(pk, tow_6s, 2)
    pk.u(eph.get("iode", 0), 8)
    pk.s(_scaled(eph.get("crs", 0.0), P2_5, 16, True), 16)
    pk.s(_scaled(eph.get("deln", 0.0) / SC2RAD, P2_43, 16, True), 16)
    m0 = _scaled(_wrap_semicircles(eph.get("M0", 0.0)), P2_31, 32, True)
    pk.s(m0 >> 24, 8)
    pk.u(m0 & 0xFFFFFF, 24)
    pk.s(_scaled(eph.get("cuc", 0.0), P2_29, 16, True), 16)
    e = _scaled(eph.get("e", 0.0), P2_33, 32, False)
    pk.u(e >> 24, 8)
    pk.u(e & 0xFFFFFF, 24)
    pk.s(_scaled(eph.get("cus", 0.0), P2_29, 16, True), 16)
    sqrt_a = _scaled(np.sqrt(eph["A"]), P2_19, 32, False)
    pk.u(sqrt_a >> 24, 8)
    pk.u(sqrt_a & 0xFFFFFF, 24)
    pk.u(_scaled(eph["toes"], 16.0, 16, False), 16)
    pk.u(eph.get("fit", 0), 1)
    pk.u(0, 5)                       # AODO
    pk.u(0, 2)
    assert len(pk.bits) == 240, len(pk.bits)
    return pk.bits


def encode_subframe3(eph: dict, tow_6s: int) -> list:
    """Subframe 3 source bits (inverse of decode_subfrm3,
    nav_data_decode.c:107-126)."""
    pk = _BitPacker()
    _header_bits(pk, tow_6s, 3)
    pk.s(_scaled(eph.get("cic", 0.0), P2_29, 16, True), 16)
    omg0 = _scaled(_wrap_semicircles(eph.get("OMG0", 0.0)), P2_31, 32, True)
    pk.s(omg0 >> 24, 8)
    pk.u(omg0 & 0xFFFFFF, 24)
    pk.s(_scaled(eph.get("cis", 0.0), P2_29, 16, True), 16)
    i0 = _scaled(_wrap_semicircles(eph.get("i0", 0.0)), P2_31, 32, True)
    pk.s(i0 >> 24, 8)
    pk.u(i0 & 0xFFFFFF, 24)
    pk.s(_scaled(eph.get("crc", 0.0), P2_5, 16, True), 16)
    omg = _scaled(_wrap_semicircles(eph.get("omg", 0.0)), P2_31, 32, True)
    pk.s(omg >> 24, 8)
    pk.u(omg & 0xFFFFFF, 24)
    pk.s(_scaled(eph.get("OMGd", 0.0) / SC2RAD, P2_43, 24, True), 24)
    pk.u(eph.get("iode", 0), 8)
    pk.s(_scaled(eph.get("idot", 0.0) / SC2RAD, P2_43, 14, True), 14)
    pk.u(0, 2)
    assert len(pk.bits) == 240, len(pk.bits)
    return pk.bits


def encode_subframe_filler(subframe_id: int, tow_6s: int) -> list:
    """Subframes 4/5: the decoder only reads their TOW
    (decode_subfrm4/5, nav_data_decode.c:128-141), but the payload must
    be *non-degenerate* — real almanac pages are pseudo-random, and an
    all-zeros payload produces periodic words that false-match the
    preamble and can even satisfy chained parity at wrong alignments."""
    pk = _BitPacker()
    _header_bits(pk, tow_6s, subframe_id)
    state = (subframe_id * 2654435761 + tow_6s * 40503) & 0xFFFFFFFF
    for _ in range(192):
        # xorshift32 — deterministic filler bits
        state ^= (state << 13) & 0xFFFFFFFF
        state ^= state >> 17
        state ^= (state << 5) & 0xFFFFFFFF
        pk.bits.append(state & 1)
    assert len(pk.bits) == 240
    return pk.bits


def build_bitstream(eph: dict, start_tow_6s: int, num_subframes: int,
                    d29: int = 0, d30: int = 0,
                    subframe_ids=None) -> np.ndarray:
    """Build a transmitted LNAV bit stream of ``num_subframes`` subframes
    cycling 1,2,3,4,5 starting at subframe 1 (or an explicit
    ``subframe_ids`` sequence), with correct cross-word and
    cross-subframe parity chaining.  Returns int8 bits (0/1), 300 bits per
    subframe, 50 bps.

    Note: each subframe's HOW carries the TOW of the *next* subframe
    boundary per IS-GPS-200; the decoder (decode_subfrm*) simply reads it,
    so the simulator follows the same convention.
    """
    encoders = {
        1: lambda tow: encode_subframe1(eph, tow),
        2: lambda tow: encode_subframe2(eph, tow),
        3: lambda tow: encode_subframe3(eph, tow),
        4: lambda tow: encode_subframe_filler(4, tow),
        5: lambda tow: encode_subframe_filler(5, tow),
    }
    if subframe_ids is None:
        subframe_ids = [(k % 5) + 1 for k in range(num_subframes)]
    stream = []
    for k, sf_id in enumerate(subframe_ids):
        src = encoders[sf_id](start_tow_6s + k + 1)
        words, d29, d30 = _subframe_words(src, d29, d30)
        for w in words:
            stream.extend(w)
    return np.asarray(stream, dtype=np.int8)
