"""Finite subexponential codes on the range coder's equiprobable bits.

Used by loop-restoration filter coefficients (AV1 spec §4.10.x
su/ns-style primitives; behavioral reference: entropy_coding.c
svt_aom_write_primitive_refsubexpfin / recenter_finite_nonneg /
svt_aom_write_primitive_quniform)."""
from __future__ import annotations


def _unrecenter_nonneg(r: int, v: int) -> int:
    if v > (r << 1):
        return v
    if v & 1:
        return r - ((v + 1) >> 1)
    return r + (v >> 1)


def _unrecenter_finite_nonneg(n: int, r: int, v: int) -> int:
    if (r << 1) <= n:
        return _unrecenter_nonneg(r, v)
    return n - 1 - _unrecenter_nonneg(n - 1 - r, v)


def read_quniform(dec, n: int) -> int:
    if n <= 1:
        return 0
    lbits = (n - 1).bit_length()
    m = (1 << lbits) - n
    v = dec.read_literal(lbits - 1)
    if v < m:
        return v
    return (v << 1) - m + dec.read_literal(1)


def read_subexpfin(dec, n: int, k: int) -> int:
    i = 0
    mk = 0
    while True:
        b = k + i - 1 if i else k
        a = 1 << b
        if n <= mk + 3 * a:
            return mk + read_quniform(dec, n - mk)
        if dec.read_literal(1):
            i += 1
            mk += a
        else:
            return mk + dec.read_literal(b)


def read_refsubexpfin(dec, n: int, k: int, ref: int) -> int:
    return _unrecenter_finite_nonneg(n, ref, read_subexpfin(dec, n, k))
