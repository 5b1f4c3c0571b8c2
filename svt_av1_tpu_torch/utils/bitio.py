"""Plain (non-arithmetic) bit IO for AV1 OBU header syntax.

Implements the AV1 spec descriptors: f(n), uvlc(), leb128(), su(n), ns(n),
le(n).  Used for sequence/frame OBU headers which are uncompressed
(reference: entropy_coding.c OBU writers + bitstream_unit.h OutputBitstream).
"""
from __future__ import annotations


class BitWriter:
    """MSB-first bit writer."""

    def __init__(self):
        self._bytes = bytearray()
        self._bitpos = 0  # bits used in current (last) byte

    def write_bit(self, bit: int):
        if self._bitpos == 0:
            self._bytes.append(0)
        if bit:
            self._bytes[-1] |= 0x80 >> self._bitpos
        self._bitpos = (self._bitpos + 1) & 7

    def f(self, value: int, n: int):
        """Fixed-width unsigned, MSB first."""
        for i in range(n - 1, -1, -1):
            self.write_bit((value >> i) & 1)

    def su(self, value: int, n: int):
        """Signed integer in n+1 bits: value then sign... spec su(1+n)?

        AV1's su(n) writes an n-bit two's-complement value: MSB is sign.
        """
        self.f(value & ((1 << n) - 1), n)

    def uvlc(self, value: int):
        v = value + 1
        leading = v.bit_length() - 1
        self.f(0, leading)
        self.f(v, leading + 1)

    def ns(self, value: int, n: int):
        """Non-symmetric unsigned ns(n) encoding (spec 4.10.7)."""
        w = n.bit_length()
        m = (1 << w) - n
        if value < m:
            self.f(value, w - 1)
        else:
            extra = value - m
            self.f(m + (extra >> 1), w - 1)
            self.write_bit(extra & 1)

    def byte_align(self):
        while self._bitpos != 0:
            self.write_bit(0)

    def trailing_bits(self):
        """OBU trailing bits: a 1 then zeros to byte alignment."""
        self.write_bit(1)
        self.byte_align()

    @property
    def bit_count(self) -> int:
        return len(self._bytes) * 8 - ((8 - self._bitpos) & 7)

    def data(self) -> bytes:
        return bytes(self._bytes)


class BitReader:
    """MSB-first bit reader (for the verification decoder)."""

    def __init__(self, data: bytes, start_bit: int = 0):
        self._data = data
        self._pos = start_bit

    def f(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self._data[self._pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self._pos & 7))) & 1)
            self._pos += 1
        return v

    def su(self, n: int) -> int:
        v = self.f(n)
        if v >= 1 << (n - 1):
            v -= 1 << n
        return v

    def uvlc(self) -> int:
        leading = 0
        while self.f(1) == 0:
            leading += 1
            if leading > 32:
                raise ValueError("bad uvlc")
        if leading == 0:
            return 0
        return (1 << leading) - 1 + self.f(leading)

    def ns(self, n: int) -> int:
        w = n.bit_length()
        m = (1 << w) - n
        v = self.f(w - 1)
        if v < m:
            return v
        return (v << 1) - m + self.f(1)

    def byte_align(self):
        self._pos = (self._pos + 7) & ~7

    @property
    def bit_pos(self) -> int:
        return self._pos

    @property
    def byte_pos(self) -> int:
        return (self._pos + 7) >> 3


def leb128(value: int) -> bytes:
    """LEB128 encoding (spec 4.10.5) for OBU sizes."""
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def read_leb128(data: bytes, pos: int):
    """Returns (value, new_pos)."""
    v = 0
    for i in range(8):
        b = data[pos + i]
        v |= (b & 0x7F) << (7 * i)
        if not (b & 0x80):
            return v, pos + i + 1
    raise ValueError("leb128 too long")
