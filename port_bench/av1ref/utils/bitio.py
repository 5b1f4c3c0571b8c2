"""Plain (non-arithmetic) bit IO for AV1 OBU header syntax.

Implements the AV1 spec descriptors: f(n), uvlc(), leb128(), su(n), ns(n),
le(n).  Used for sequence/frame OBU headers which are uncompressed
(reference: entropy_coding.c OBU writers + bitstream_unit.h OutputBitstream).
"""
from __future__ import annotations


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


def read_leb128(data: bytes, pos: int):
    """Returns (value, new_pos)."""
    v = 0
    for i in range(8):
        b = data[pos + i]
        v |= (b & 0x7F) << (7 * i)
        if not (b & 0x80):
            return v, pos + i + 1
    raise ValueError("leb128 too long")
