"""AV1 coefficient (transform block) entropy coding.

Encoder and mirror decoder for one txb, following the normative syntax
(AV1 spec §5.11.39 coeffs(); behavioral reference: entropy_coding.c
av1_write_coeffs_txb_1d, coefficients.h context helpers,
C_DEFAULT/encode_txb_ref_c.c).

This is the Python reference implementation; the per-symbol loop is the
hot host path and is mirrored by the C extension (svt_av1_tpu_torch/native)
once built.  Context computation is numpy-vectorized where possible.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from svt_av1_tpu_torch.codec import constants as cc
from svt_av1_tpu_torch.codec import tables as tb
from svt_av1_tpu_torch.codec.entropy import RangeDecoder, RangeEncoder, update_cdf
from svt_av1_tpu_torch.codec.cdf import FrameCDFs

_CLIP3 = np.minimum


def init_levels(qcoeff: np.ndarray) -> np.ndarray:
    """Padded |level| buffer: (h + 4, w + 4) uint8, levels capped at 127.

    Layout matches the reference (TX_PAD_HOR = 4 on the right, 4 rows
    below) so neighbor reads never go out of bounds."""
    h, w = qcoeff.shape
    levels = np.zeros((h + 4, w + tb.TX_PAD_HOR), dtype=np.int32)
    levels[:h, :w] = np.minimum(np.abs(qcoeff), 127)
    return levels


def eob_pos_token(eob: int) -> Tuple[int, int]:
    """(eob_pt, eob_extra): token class + offset (get_eob_pos_token)."""
    if eob < 2:
        t = eob
    elif eob < 3:
        t = 2
    elif eob < 5:
        t = 3
    elif eob < 9:
        t = 4
    elif eob < 17:
        t = 5
    elif eob < 33:
        t = 6
    elif eob < 65:
        t = 7
    elif eob < 129:
        t = 8
    elif eob < 257:
        t = 9
    elif eob < 513:
        t = 10
    else:
        t = 11
    return t, eob - int(tb.K_EOB_GROUP_START[t])


def nz_map_contexts(levels: np.ndarray, scan: np.ndarray, eob: int,
                    tx_size: int, tx_class: int) -> np.ndarray:
    """Per-scan-position coeff_base contexts (svt_av1_get_nz_map_contexts).

    Vectorized over all eob positions at once."""
    bwl, w, h = tb.txb_dims(tx_size)
    pos = scan[:eob]
    row = pos >> bwl
    col = pos & (w - 1)
    lv = np.minimum(levels, 3)
    if tx_class == tb.TX_CLASS_2D:
        mag = (lv[row, col + 1] + lv[row + 1, col] + lv[row + 1, col + 1]
               + lv[row, col + 2] + lv[row + 2, col])
        ctx = np.minimum((mag + 1) >> 1, 4)
        base = ctx + tb.nz_map_ctx_offset(tx_size)[pos]
        base[pos == 0] = 0
    elif tx_class == tb.TX_CLASS_VERT:
        mag = (lv[row, col + 1] + lv[row + 1, col]
               + lv[row + 2, col] + lv[row + 3, col] + lv[row + 4, col])
        ctx = np.minimum((mag + 1) >> 1, 4)
        base = ctx + tb.NZ_MAP_CTX_OFFSET_1D[row]
    else:  # TX_CLASS_HORIZ
        mag = (lv[row, col + 1] + lv[row + 1, col]
               + lv[row, col + 2] + lv[row, col + 3] + lv[row, col + 4])
        ctx = np.minimum((mag + 1) >> 1, 4)
        base = ctx + tb.NZ_MAP_CTX_OFFSET_1D[col]
    # eob position context (is_eob): class by scan index
    last = eob - 1
    si = last
    if si == 0:
        eob_ctx = 0
    elif si <= (h * w) // 8:
        eob_ctx = 1
    elif si <= (h * w) // 4:
        eob_ctx = 2
    else:
        eob_ctx = 3
    base[last] = eob_ctx
    return base


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


def _br_levels(levels: np.ndarray) -> np.ndarray:
    """levels clipped to 15 for br context (MAX_BASE_BR_RANGE)."""
    return np.minimum(levels, tb.COEFF_BASE_RANGE + tb.NUM_BASE_LEVELS + 1)


def write_coeffs_txb(enc: RangeEncoder, cdfs: FrameCDFs, qcoeff: np.ndarray,
                     tx_size: int, tx_type: int, plane_type: int,
                     txb_skip_ctx: int, dc_sign_ctx: int,
                     update: bool = True) -> int:
    """Encode one txb's coefficients.  qcoeff: (kh, kw) int32 levels with
    sign, coded (adjusted) dims.  Returns cul_level (context feedback for
    neighboring blocks: min(63, sum|level|) + dc sign in high bits).

    NOTE: tx_type must already have been signaled by the caller (mode
    syntax layer) right after a nonzero txb_skip, per spec ordering —
    this function emits txb_skip and, via callback-free design, expects
    the caller to interleave tx_type; see encode_txb() below for the
    combined helper."""
    raise NotImplementedError("use encode_txb")


def encode_txb(enc: RangeEncoder, cdfs: FrameCDFs, qcoeff: np.ndarray,
               tx_size: int, tx_type: int, plane_type: int,
               txb_skip_ctx: int, dc_sign_ctx: int,
               write_tx_type=None, update: bool = True) -> int:
    """Encode one transform block (txb_skip + [tx_type] + eob + levels
    + signs).  ``write_tx_type``: optional callback invoked after a
    nonzero txb_skip for luma tx-type signaling.  Returns cul_level."""
    tx_class = int(tb.tx_type_class[tx_type])
    scan = tb.get_scan(tx_size, tx_type)
    bwl, w, h = tb.txb_dims(tx_size)
    sctx = tb.txs_ctx(tx_size)

    flat = qcoeff.reshape(-1)
    nz = np.nonzero(flat[scan])[0]
    eob = 0 if len(nz) == 0 else int(nz[-1]) + 1

    cdf = cdfs.txb_skip[sctx][txb_skip_ctx]
    enc.encode_symbol(int(eob == 0), cdf, 2)
    if update:
        update_cdf(cdf, int(eob == 0), 2)
    if eob == 0:
        return 0

    if write_tx_type is not None:
        write_tx_type()

    if getattr(enc, "is_native", False):
        # whole-block C fast path (bit-identical; tested vs this function)
        return enc.encode_coeffs(qcoeff, tx_size, tx_type, plane_type,
                                 dc_sign_ctx, eob, cdfs, update)

    levels = init_levels(qcoeff)

    # ---- eob position ----
    eob_pt, eob_extra = eob_pos_token(eob)
    eob_multi_size = tb.txsize_log2_minus4(tx_size)
    eob_multi_ctx = 0 if tx_class == tb.TX_CLASS_2D else 1
    ncoeffs = 16 << eob_multi_size
    ecdf = cdfs.eob_flag[ncoeffs][plane_type][eob_multi_ctx]
    nsyms = eob_multi_size + 5
    enc.encode_symbol(eob_pt - 1, ecdf, nsyms)
    if update:
        update_cdf(ecdf, eob_pt - 1, nsyms)

    eob_offset_bits = int(tb.K_EOB_OFFSET_BITS[eob_pt])
    if eob_offset_bits > 0:
        eob_shift = eob_offset_bits - 1
        bit = (eob_extra >> eob_shift) & 1
        xcdf = cdfs.eob_extra[sctx][plane_type][eob_pt]
        enc.encode_symbol(bit, xcdf, 2)
        if update:
            update_cdf(xcdf, bit, 2)
        for i in range(1, eob_offset_bits):
            eob_shift = eob_offset_bits - 1 - i
            enc.encode_bool((eob_extra >> eob_shift) & 1, 16384)

    # ---- base + br levels, reverse scan ----
    coeff_ctxs = nz_map_contexts(levels, scan, eob, tx_size, tx_class)
    brc = min(sctx, cc.TX_32X32)
    for c in range(eob - 1, -1, -1):
        pos = int(scan[c])
        level = int(abs(flat[pos]))
        ctx = int(coeff_ctxs[c])
        if c == eob - 1:
            s = min(level, 3) - 1
            bcdf = cdfs.coeff_base_eob[sctx][plane_type][ctx]
            enc.encode_symbol(s, bcdf, 3)
            if update:
                update_cdf(bcdf, s, 3)
        else:
            s = min(level, 3)
            bcdf = cdfs.coeff_base[sctx][plane_type][ctx]
            enc.encode_symbol(s, bcdf, 4)
            if update:
                update_cdf(bcdf, s, 4)
        if level > tb.NUM_BASE_LEVELS:
            base_range = level - 1 - tb.NUM_BASE_LEVELS
            bctx = br_ctx(levels, pos, bwl, tx_class)
            rcdf = cdfs.coeff_br[brc][plane_type][bctx]
            for idx in range(0, tb.COEFF_BASE_RANGE, tb.BR_CDF_SIZE - 1):
                k = min(base_range - idx, tb.BR_CDF_SIZE - 1)
                enc.encode_symbol(k, rcdf, tb.BR_CDF_SIZE)
                if update:
                    update_cdf(rcdf, k, tb.BR_CDF_SIZE)
                if k < tb.BR_CDF_SIZE - 1:
                    break

    # ---- signs + golomb remainders, forward scan ----
    cul_level = 0
    for c in range(eob):
        pos = int(scan[c])
        v = int(flat[pos])
        level = abs(v)
        cul_level += level
        if level:
            sign = 1 if v < 0 else 0
            if c == 0:
                scdf = cdfs.dc_sign[plane_type][dc_sign_ctx]
                enc.encode_symbol(sign, scdf, 2)
                if update:
                    update_cdf(scdf, sign, 2)
            else:
                enc.encode_bool(sign, 16384)
            if level > tb.COEFF_BASE_RANGE + tb.NUM_BASE_LEVELS:
                _write_golomb(
                    enc, level - tb.COEFF_BASE_RANGE - 1 - tb.NUM_BASE_LEVELS)

    cul_level = min(tb.COEFF_CONTEXT_MASK, cul_level)
    dc = int(flat[0])
    if dc < 0:
        cul_level |= 1 << tb.COEFF_CONTEXT_BITS
    elif dc > 0:
        cul_level += 2 << tb.COEFF_CONTEXT_BITS
    return cul_level


def _write_golomb(enc: RangeEncoder, level: int):
    x = level + 1
    length = x.bit_length()
    for _ in range(length - 1):
        enc.encode_bool(0, 16384)
    for i in range(length - 1, -1, -1):
        enc.encode_bool((x >> i) & 1, 16384)


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
