"""Hybrid entropy encoder: Python-compatible interface backed by the
native C range coder + C coefficient loop (svt_av1_tpu_torch/native).

Drop-in for codec.entropy.RangeEncoder in the TileEncoder; mode and
partition symbols go through the C range coder one call at a time, and
whole transform blocks are encoded by one C call (encode_coeffs).
Byte-identical to the pure Python path (tested)."""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np

from svt_av1_tpu_torch import native
from svt_av1_tpu_torch.codec import tables as tb


def available() -> bool:
    return native.get_ec() is not None


class HybridEncoder:
    """RangeEncoder-compatible wrapper over ec_native."""

    is_native = True

    def __init__(self):
        self._n = native.get_ec().RangeEncoder()

    def encode_symbol(self, s: int, icdf, nsyms: Optional[int] = None
                      ) -> None:
        if nsyms is None:
            from svt_av1_tpu_torch.codec.entropy import infer_nsyms
            nsyms = infer_nsyms(icdf)
        arr = np.ascontiguousarray(icdf[:nsyms + 1]
                                   if len(icdf) > nsyms + 1 else icdf,
                                   dtype=np.uint16)
        self._n.encode_symbol(int(s), arr, int(nsyms), False)
        # arr may be a copy; no update requested so no write-back needed

    def encode_symbol_update(self, s: int, icdf: np.ndarray,
                             nsyms: int) -> None:
        """Symbol + in-place CDF adaptation (icdf must be a contiguous
        writable numpy row)."""
        self._n.encode_symbol(int(s), icdf, int(nsyms), True)

    def encode_bool(self, val: int, f: int) -> None:
        self._n.encode_bool(int(val), int(f))

    def encode_literal(self, v: int, bits: int) -> None:
        self._n.encode_literal(int(v), int(bits))

    def tell_bits(self) -> int:
        return self._n.tell_bits()

    def done(self) -> bytes:
        return self._n.done()

    # -- fast coefficient path -------------------------------------------
    def encode_coeffs(self, qcoeff: np.ndarray, tx_size: int, tx_type: int,
                      plane_type: int, dc_sign_ctx: int, eob: int,
                      cdfs, update: bool) -> int:
        tx_class = int(tb.tx_type_class[tx_type])
        bwl, kw, kh = tb.txb_dims(tx_size)
        sctx = tb.txs_ctx(tx_size)
        eob_multi_size = tb.txsize_log2_minus4(tx_size)
        eob_multi_ctx = 0 if tx_class == tb.TX_CLASS_2D else 1
        ncoeffs = 16 << eob_multi_size
        import svt_av1_tpu_torch.codec.constants as cc
        brc = min(sctx, cc.TX_32X32)
        q = np.ascontiguousarray(qcoeff.reshape(-1), dtype=np.int32)
        return self._n.encode_coeffs(
            q, _scan16(tx_size, tx_type), _ctx_offsets8(tx_size),
            kh, kw, bwl, tx_class, eob_multi_size,
            cdfs.eob_flag[ncoeffs][plane_type][eob_multi_ctx],
            cdfs.eob_extra[sctx][plane_type],
            cdfs.dc_sign[plane_type][dc_sign_ctx],
            cdfs.coeff_base[sctx][plane_type],
            cdfs.coeff_base_eob[sctx][plane_type],
            cdfs.coeff_br[brc][plane_type],
            int(eob), int(dc_sign_ctx), bool(update))


def encode_intra_tile_arrays(tenc, ym, um, qy, qu, qv) -> bytes:
    """Array-native whole-tile C path (no per-block Python objects)."""
    tx_types = np.zeros_like(ym)
    return _run_tile(tenc, ym, um, tx_types,
                     np.ascontiguousarray(qy, np.int32),
                     np.ascontiguousarray(qu, np.int32),
                     np.ascontiguousarray(qv, np.int32))


def _run_tile(tenc, y_modes, uv_modes, tx_types, qy, qu, qv) -> bytes:
    import svt_av1_tpu_torch.codec.constants as cc
    from svt_av1_tpu_torch.codec.syntax import (AV1_EXT_TX_IND,
                                          EXT_TX_SET_DTT4_IDTX)
    cdfs = tenc.cdfs
    scans = (_scan16(cc.TX_16X16, cc.DCT_DCT), _ctx_offsets8(cc.TX_16X16),
             _scan16(cc.TX_8X8, cc.DCT_DCT), _ctx_offsets8(cc.TX_8X8),
             np.ascontiguousarray(AV1_EXT_TX_IND[EXT_TX_SET_DTT4_IDTX],
                                  dtype=np.uint8))
    kf = cdfs.kf_y_mode
    cdf_list = (
        cdfs.partition,
        kf.reshape(kf.shape[0] * kf.shape[1], kf.shape[2]),
        cdfs.angle_delta,
        cdfs.uv_mode[1],
        cdfs.skip,
        cdfs.intra_ext_tx[2][2],
        cdfs.txb_skip[2], cdfs.txb_skip[1],
        cdfs.eob_flag[256][0][0], cdfs.eob_flag[64][1][0],
        cdfs.eob_extra[2][0], cdfs.eob_extra[1][1],
        cdfs.dc_sign[0], cdfs.dc_sign[1],
        cdfs.coeff_base[2][0], cdfs.coeff_base[1][1],
        cdfs.coeff_base_eob[2][0], cdfs.coeff_base_eob[1][1],
        cdfs.coeff_br[2][0], cdfs.coeff_br[1][1],
    )
    enc = HybridEncoder()
    enc._n.encode_intra_tile(
        int(tenc.mi_rows), int(tenc.mi_cols), 1, bool(tenc.update),
        (np.ascontiguousarray(y_modes, np.uint8),
         np.ascontiguousarray(uv_modes, np.uint8),
         np.ascontiguousarray(tx_types, np.uint8),
         qy, qu, qv), scans, cdf_list)
    return enc.done()


def encode_intra_tile(tenc, blocks) -> bytes:
    """Whole-tile C fast path for the fixed 16x16 intra grid.

    Byte-identical to the Python TileEncoder walk (tested); CDF arrays
    adapt in place so primary-ref chaining still sees the final state."""
    import svt_av1_tpu_torch.codec.constants as cc
    from svt_av1_tpu_torch.codec.syntax import (AV1_EXT_TX_IND,
                                          EXT_TX_SET_DTT4_IDTX)
    cdfs = tenc.cdfs
    gh = (tenc.mi_rows + 3) >> 2
    gw = (tenc.mi_cols + 3) >> 2
    y_modes = np.zeros(gh * gw, np.uint8)
    uv_modes = np.zeros(gh * gw, np.uint8)
    tx_types = np.zeros(gh * gw, np.uint8)
    qy = np.zeros((gh * gw, 256), np.int32)
    qu = np.zeros((gh * gw, 64), np.int32)
    qv = np.zeros((gh * gw, 64), np.int32)
    for (r4, c4), d in blocks.items():
        bi = (r4 >> 2) * gw + (c4 >> 2)
        y_modes[bi] = d.y_mode
        uv_modes[bi] = d.uv_mode
        tx_types[bi] = d.tx_type
        qy[bi] = np.asarray(d.qcoeff_y, np.int32).reshape(-1)
        qu[bi] = np.asarray(d.qcoeff_u, np.int32).reshape(-1)
        qv[bi] = np.asarray(d.qcoeff_v, np.int32).reshape(-1)
    return _run_tile(tenc, y_modes, uv_modes, tx_types, qy, qu, qv)


@functools.lru_cache(maxsize=None)
def _scan16(tx_size: int, tx_type: int) -> np.ndarray:
    return np.ascontiguousarray(tb.get_scan(tx_size, tx_type),
                                dtype=np.int16)


@functools.lru_cache(maxsize=None)
def _ctx_offsets8(tx_size: int) -> np.ndarray:
    return np.ascontiguousarray(tb.nz_map_ctx_offset(tx_size),
                                dtype=np.int8)
