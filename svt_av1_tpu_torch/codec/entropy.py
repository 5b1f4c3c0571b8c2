"""AV1 multi-symbol range (entropy) coder — the daala `od_ec` coder.

Bit-exact re-implementation of the normative AV1 arithmetic coder
(AV1 spec §8.2; behavioral reference: bitstream_unit.c in SVT-AV1 —
svt_od_ec_enc_* / daala entdec).  Conventions follow the AV1 ecosystem:

  * CDFs are stored *inverted* ("icdf"): icdf[i] = 32768 - cum_prob(i),
    monotonically decreasing, icdf[nsyms-1] == 0.  Tables carry one extra
    trailing slot used as the adaptation counter.
  * Probabilities are Q15 (CDF_PROB_TOP = 32768), coded with
    EC_PROB_SHIFT = 6 and EC_MIN_PROB = 4 (each symbol reserves a floor
    probability so zero-probability symbols stay decodable).

The Python classes here are the *reference implementation* used for tests
and for low-rate paths; the hot coefficient loop is delegated to the C
extension in svt_av1_tpu_torch/native (same algorithm) when available.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

CDF_PROB_TOP = 1 << 15
EC_PROB_SHIFT = 6
EC_MIN_PROB = 4
_WINDOW_BITS = 32
_WMASK = (1 << _WINDOW_BITS) - 1


def _ilog_nz(x: int) -> int:
    """Number of bits needed to represent x (x > 0); OD_ILOG_NZ."""
    return x.bit_length()


def infer_nsyms(icdf) -> int:
    """Symbol count from a *default* (never-adapted) table: trailing slots
    are zero (icdf[nsyms-1] == 0, counter == 0).  NOT valid once the
    counter slot is nonzero — pass nsyms explicitly in that case."""
    nsyms = len(icdf)
    while nsyms > 1 and icdf[nsyms - 1] == 0 and icdf[nsyms - 2] == 0:
        nsyms -= 1
    return nsyms


class RangeEncoder:
    """daala range encoder producing AV1-conformant entropy-coded bytes."""

    __slots__ = ("low", "rng", "cnt", "precarry")

    def __init__(self):
        self.reset()

    def reset(self):
        self.low = 0
        self.rng = 0x8000
        # crosses zero after one byte + one carry bit has accumulated
        self.cnt = -9
        self.precarry: List[int] = []

    # -- core --------------------------------------------------------------

    def _normalize(self, low: int, rng: int):
        d = 16 - _ilog_nz(rng)
        c = self.cnt
        s = c + d
        if s >= 0:
            c += 16
            m = (1 << c) - 1
            if s >= 8:
                self.precarry.append((low >> c) & 0xFFFF)
                low &= m
                c -= 8
                m >>= 8
            self.precarry.append((low >> c) & 0xFFFF)
            s = c + d - 24
            low &= m
        self.low = (low << d) & _WMASK
        self.rng = (rng << d) & 0xFFFF
        self.cnt = s

    def _encode_q15(self, fl: int, fh: int, s: int, nsyms: int):
        l = self.low
        r = self.rng
        n = nsyms - 1
        if fl < CDF_PROB_TOP:
            u = ((r >> 8) * (fl >> EC_PROB_SHIFT) >> (7 - EC_PROB_SHIFT)) \
                + EC_MIN_PROB * (n - (s - 1))
            v = ((r >> 8) * (fh >> EC_PROB_SHIFT) >> (7 - EC_PROB_SHIFT)) \
                + EC_MIN_PROB * (n - s)
            l = (l + r - u) & _WMASK
            r = u - v
        else:
            r -= ((r >> 8) * (fh >> EC_PROB_SHIFT) >> (7 - EC_PROB_SHIFT)) \
                + EC_MIN_PROB * (n - s)
        self._normalize(l, r)

    # -- public API ---------------------------------------------------------

    def encode_symbol(self, s: int, icdf, nsyms: Optional[int] = None
                      ) -> None:
        """Encode symbol index ``s`` with inverted CDF ``icdf``.

        ``nsyms`` should be passed explicitly for adapted tables — the
        trailing-zero inference below is only valid for *default* tables
        (the adaptation counter slot becomes nonzero after updates).
        """
        if nsyms is None:
            nsyms = infer_nsyms(icdf)
        fl = CDF_PROB_TOP if s == 0 else int(icdf[s - 1])
        fh = int(icdf[s])
        self._encode_q15(fl, fh, s, nsyms)

    def encode_bool(self, val: int, f: int) -> None:
        """Encode one bit; ``f`` is Q15 scaled P(val == 1) subrange."""
        l = self.low
        r = self.rng
        v = ((r >> 8) * (f >> EC_PROB_SHIFT) >> (7 - EC_PROB_SHIFT)) + EC_MIN_PROB
        if val:
            l = (l + r - v) & _WMASK
            r = v
        else:
            r -= v
        self._normalize(l, r)

    def encode_literal(self, v: int, bits: int) -> None:
        """Raw ``bits`` equiprobable bits, MSB first (spec L(n))."""
        for i in range(bits - 1, -1, -1):
            self.encode_bool((v >> i) & 1, 16384)

    def tell_bits(self) -> int:
        """Upper bound of bits used so far (od_ec_enc_tell)."""
        return self.cnt + 10 + len(self.precarry) * 8

    def done(self) -> bytes:
        """Finalize and return the coded byte string."""
        l = self.low
        c = self.cnt
        s = 10
        m = 0x3FFF
        e = ((l + m) & ~m & _WMASK) | (m + 1)
        s += c
        pre = list(self.precarry)
        if s > 0:
            n = (1 << (c + 16)) - 1
            while True:
                pre.append((e >> (c + 16)) & 0xFFFF)
                e &= n
                s -= 8
                c -= 8
                n >>= 8
                if s <= 0:
                    break
        # carry propagation
        out = bytearray(len(pre))
        carry = 0
        for i in range(len(pre) - 1, -1, -1):
            v = pre[i] + carry
            out[i] = v & 0xFF
            carry = v >> 8
        return bytes(out)


class RangeDecoder:
    """daala range decoder (mirror of RangeEncoder; AV1 spec §8.2.2)."""

    __slots__ = ("buf", "bptr", "end", "dif", "rng", "cnt")

    def __init__(self, data: bytes):
        self.buf = data
        self.bptr = 0
        self.end = len(data)
        self.dif = ((1 << (_WINDOW_BITS - 1)) - 1) & _WMASK
        self.rng = 0x8000
        self.cnt = -15
        self._refill()

    def _refill(self):
        s = _WINDOW_BITS - 9 - (self.cnt + 15)
        dif = self.dif
        while s >= 0 and self.bptr < self.end:
            dif ^= self.buf[self.bptr] << s
            self.cnt += 8
            self.bptr += 1
            s -= 8
        if self.bptr >= self.end:
            self.cnt = 0x4000  # "lots of bits"
        self.dif = dif

    def _normalize(self, dif: int, rng: int):
        d = 16 - _ilog_nz(rng)
        self.cnt -= d
        self.dif = (((dif + 1) << d) - 1) & _WMASK
        self.rng = (rng << d) & 0xFFFF
        if self.cnt < 0:
            self._refill()

    def read_symbol(self, icdf, nsyms: Optional[int] = None) -> int:
        if nsyms is None:
            nsyms = infer_nsyms(icdf)
        dif = self.dif
        r = self.rng
        n = nsyms - 1
        c = dif >> (_WINDOW_BITS - 16)
        v = r
        ret = -1
        u = v
        while True:
            ret += 1
            u = v
            v = ((r >> 8) * (int(icdf[ret]) >> EC_PROB_SHIFT) >> (7 - EC_PROB_SHIFT)) \
                + EC_MIN_PROB * (n - ret)
            if c >= v:
                break
        r = u - v
        dif -= v << (_WINDOW_BITS - 16)
        self._normalize(dif, r)
        return ret

    def read_bool(self, f: int) -> int:
        dif = self.dif
        r = self.rng
        v = ((r >> 8) * (f >> EC_PROB_SHIFT) >> (7 - EC_PROB_SHIFT)) + EC_MIN_PROB
        vw = v << (_WINDOW_BITS - 16)
        if dif >= vw:
            r_new = r - v
            dif -= vw
            ret = 0
        else:
            r_new = v
            ret = 1
        self._normalize(dif, r_new)
        return ret

    def read_literal(self, bits: int) -> int:
        x = 0
        for _ in range(bits):
            x = (x << 1) | self.read_bool(16384)
        return x


def update_cdf(icdf: np.ndarray, val: int, nsyms: Optional[int] = None) -> None:
    """In-place adaptation of an inverted CDF after coding symbol ``val``.

    Normative CDF update (AV1 spec §8.4 "CDF update process"), in the
    inverted-table convention.  ``icdf`` must include the trailing counter
    slot: icdf[nsyms] counts coded symbols (saturating at 32).
    """
    if nsyms is None:
        nsyms = len(icdf) - 1
    count = int(icdf[nsyms])
    rate = 3 + (count > 15) + (count > 31) + min(_ilog_nz(nsyms) - 1, 2)
    # In inverted convention: move icdf[i] toward 32768 for i < val,
    # toward 0 for i >= val.
    for i in range(nsyms - 1):
        cur = int(icdf[i])
        if i < val:
            icdf[i] = cur + ((CDF_PROB_TOP - cur) >> rate)
        else:
            icdf[i] = cur - (cur >> rate)
    icdf[nsyms] = count + (count < 32)
