"""MSB-first bit packing for RTCM3 (setbitu/setbits, rtcm3e.c style).

RTCM 10403 packs fields MSB-first across a byte buffer — the convention
of RTKLIB's setbitu/getbitu (referenced at obs_publish.c:101-136); note
the *nav subframe* store in this framework uses flat bit lists instead
(nav/ephemeris.py).
"""

from __future__ import annotations


class BitWriter:
    def __init__(self):
        self.buf = bytearray()
        self.bitpos = 0

    def set_u(self, value: int, width: int):
        value &= (1 << width) - 1
        for i in range(width - 1, -1, -1):
            byte, bit = divmod(self.bitpos, 8)
            if byte >= len(self.buf):
                self.buf.append(0)
            if (value >> i) & 1:
                self.buf[byte] |= 0x80 >> bit
            self.bitpos += 1

    def set_s(self, value: int, width: int):
        self.set_u(value & ((1 << width) - 1), width)

    def pad_to_byte(self):
        while self.bitpos % 8:
            self.set_u(0, 1)

    def bytes(self) -> bytes:
        return bytes(self.buf)


class BitReader:
    def __init__(self, data: bytes, bitpos: int = 0):
        self.data = data
        self.bitpos = bitpos

    def get_u(self, width: int) -> int:
        v = 0
        for _ in range(width):
            byte, bit = divmod(self.bitpos, 8)
            v = (v << 1) | ((self.data[byte] >> (7 - bit)) & 1)
            self.bitpos += 1
        return v

    def get_s(self, width: int) -> int:
        v = self.get_u(width)
        if v & (1 << (width - 1)):
            v -= 1 << width
        return v
