"""AV1 coefficient (transform block) entropy coding.

Encoder and mirror decoder for one txb, following the normative syntax
(AV1 spec §5.11.39 coeffs(); behavioral reference: entropy_coding.c
av1_write_coeffs_txb_1d, coefficients.h context helpers,
C_DEFAULT/encode_txb_ref_c.c).

This is the Python reference implementation; the per-symbol loop is the
hot host path and is mirrored by the C extension (av1ref/native)
once built.  Context computation is numpy-vectorized where possible.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from av1ref.codec import constants as cc
from av1ref.codec import tables as tb
from av1ref.codec.entropy import RangeDecoder, update_cdf
from av1ref.codec.cdf import FrameCDFs


def br_ctx(levels: np.ndarray, pos: int, bwl: int, tx_class: int) -> int:
    """Level-above-2 ("base range") context (get_br_ctx)."""
    row = pos >> bwl
    col = pos - (row << bwl)
    mag = int(levels[row, col + 1]) + int(levels[row + 1, col])
    if tx_class == tb.TX_CLASS_2D:
        mag += int(levels[row + 1, col + 1])
        mag = min((mag + 1) >> 1, 6)
        if pos == 0:
            return mag
        if row < 2 and col < 2:
            return mag + 7
    elif tx_class == tb.TX_CLASS_HORIZ:
        mag += int(levels[row, col + 2])
        mag = min((mag + 1) >> 1, 6)
        if pos == 0:
            return mag
        if col == 0:
            return mag + 7
    else:  # VERT
        mag += int(levels[row + 2, col])
        mag = min((mag + 1) >> 1, 6)
        if pos == 0:
            return mag
        if row == 0:
            return mag + 7
    return mag + 14


def _read_golomb(dec: RangeDecoder) -> int:
    length = 1
    while dec.read_bool(16384) == 0:
        length += 1
        if length > 32:
            raise ValueError("bad golomb")
    x = 1
    for _ in range(length - 1):
        x = (x << 1) | dec.read_bool(16384)
    return x - 1


def decode_txb(dec: RangeDecoder, cdfs: FrameCDFs, tx_size: int,
               plane_type: int, txb_skip_ctx: int, dc_sign_ctx: int,
               read_tx_type=None, update: bool = True
               ) -> Tuple[np.ndarray, int, int]:
    """Mirror of encode_txb.  ``read_tx_type``: callback returning the
    tx_type (invoked after nonzero txb_skip for luma; pass a constant
    lambda for chroma / implied types).  Returns (qcoeff (kh,kw) int32
    unsigned-level*sign, eob, cul_level)."""
    sctx = tb.txs_ctx(tx_size)
    cdf = cdfs.txb_skip[sctx][txb_skip_ctx]
    all_zero = dec.read_symbol(cdf, 2)
    if update:
        update_cdf(cdf, all_zero, 2)
    bwl, w, h = tb.txb_dims(tx_size)
    if all_zero:
        return np.zeros((h, w), dtype=np.int32), 0, 0

    tx_type = read_tx_type() if read_tx_type is not None else cc.DCT_DCT
    tx_class = int(tb.tx_type_class[tx_type])
    scan = tb.get_scan(tx_size, tx_type)

    # ---- eob ----
    eob_multi_size = tb.txsize_log2_minus4(tx_size)
    eob_multi_ctx = 0 if tx_class == tb.TX_CLASS_2D else 1
    ncoeffs = 16 << eob_multi_size
    ecdf = cdfs.eob_flag[ncoeffs][plane_type][eob_multi_ctx]
    nsyms = eob_multi_size + 5
    eob_pt = dec.read_symbol(ecdf, nsyms) + 1
    if update:
        update_cdf(ecdf, eob_pt - 1, nsyms)
    eob = int(tb.K_EOB_GROUP_START[eob_pt])
    eob_offset_bits = int(tb.K_EOB_OFFSET_BITS[eob_pt])
    if eob_offset_bits > 0:
        xcdf = cdfs.eob_extra[sctx][plane_type][eob_pt]
        bit = dec.read_symbol(xcdf, 2)
        if update:
            update_cdf(xcdf, bit, 2)
        eob_extra = bit << (eob_offset_bits - 1)
        for i in range(1, eob_offset_bits):
            eob_extra |= dec.read_bool(16384) << (eob_offset_bits - 1 - i)
        eob += eob_extra

    # ---- levels ----
    qc = np.zeros(h * w, dtype=np.int32)
    levels = np.zeros((h + 4, w + tb.TX_PAD_HOR), dtype=np.int32)
    brc = min(sctx, cc.TX_32X32)
    for c in range(eob - 1, -1, -1):
        pos = int(scan[c])
        row, col = pos >> bwl, pos & (w - 1)
        if c == eob - 1:
            si = c
            if si == 0:
                ctx = 0
            elif si <= (h * w) // 8:
                ctx = 1
            elif si <= (h * w) // 4:
                ctx = 2
            else:
                ctx = 3
            bcdf = cdfs.coeff_base_eob[sctx][plane_type][ctx]
            level = dec.read_symbol(bcdf, 3) + 1
            if update:
                update_cdf(bcdf, level - 1, 3)
        else:
            ctx = _nz_ctx_single(levels, pos, bwl, w, tx_size, tx_class)
            bcdf = cdfs.coeff_base[sctx][plane_type][ctx]
            level = dec.read_symbol(bcdf, 4)
            if update:
                update_cdf(bcdf, level, 4)
        if level > tb.NUM_BASE_LEVELS:
            bctx = br_ctx(levels, pos, bwl, tx_class)
            rcdf = cdfs.coeff_br[brc][plane_type][bctx]
            for idx in range(0, tb.COEFF_BASE_RANGE, tb.BR_CDF_SIZE - 1):
                k = dec.read_symbol(rcdf, tb.BR_CDF_SIZE)
                if update:
                    update_cdf(rcdf, k, tb.BR_CDF_SIZE)
                level += k
                if k < tb.BR_CDF_SIZE - 1:
                    break
        qc[pos] = level
        levels[row, col] = min(level, 127)

    # ---- signs + golomb ----
    cul_level = 0
    for c in range(eob):
        pos = int(scan[c])
        level = int(qc[pos])
        if level:
            if c == 0:
                scdf = cdfs.dc_sign[plane_type][dc_sign_ctx]
                sign = dec.read_symbol(scdf, 2)
                if update:
                    update_cdf(scdf, sign, 2)
            else:
                sign = dec.read_bool(16384)
            if level > tb.COEFF_BASE_RANGE + tb.NUM_BASE_LEVELS:
                level += _read_golomb(dec)
                qc[pos] = level
            if sign:
                qc[pos] = -level
        cul_level += level
    cul_level = min(tb.COEFF_CONTEXT_MASK, cul_level)
    dc = int(qc[0])
    if dc < 0:
        cul_level |= 1 << tb.COEFF_CONTEXT_BITS
    elif dc > 0:
        cul_level += 2 << tb.COEFF_CONTEXT_BITS
    return qc.reshape(h, w), eob, cul_level


def _nz_ctx_single(levels: np.ndarray, pos: int, bwl: int, w: int,
                   tx_size: int, tx_class: int) -> int:
    """Base context for one position during decode (levels partial)."""
    row, col = pos >> bwl, pos & (w - 1)
    lv = levels  # already small ints; min(.,3) below
    def l3(r, c):
        return min(int(lv[r, c]), 3)
    if tx_class == tb.TX_CLASS_2D:
        if pos == 0:
            return 0
        mag = (l3(row, col + 1) + l3(row + 1, col) + l3(row + 1, col + 1)
               + l3(row, col + 2) + l3(row + 2, col))
        ctx = min((mag + 1) >> 1, 4)
        return ctx + int(tb.nz_map_ctx_offset(tx_size)[pos])
    if tx_class == tb.TX_CLASS_VERT:
        mag = (l3(row, col + 1) + l3(row + 1, col) + l3(row + 2, col)
               + l3(row + 3, col) + l3(row + 4, col))
        ctx = min((mag + 1) >> 1, 4)
        return ctx + int(tb.NZ_MAP_CTX_OFFSET_1D[row])
    mag = (l3(row, col + 1) + l3(row + 1, col) + l3(row, col + 2)
           + l3(row, col + 3) + l3(row, col + 4))
    ctx = min((mag + 1) >> 1, 4)
    return ctx + int(tb.NZ_MAP_CTX_OFFSET_1D[col])
