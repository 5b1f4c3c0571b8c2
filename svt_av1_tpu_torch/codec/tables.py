"""Derived lookup tables for coefficient coding: scan orders, context
offsets, tx-size maps.

Scan orders are normative spec data (codec/data/av1_scan_tables.npz).
The 2-D nz-map context offsets are generated here from the normative rule
(documented in the spec / coefficients.h get_nz_map_ctx_from_stats) and
verified in tests against the reference tables."""
from __future__ import annotations

import functools
import os

import numpy as np

from svt_av1_tpu_torch.codec import constants as cc

_DATA_DIR = os.path.join(os.path.dirname(__file__), "data")

TX_CLASS_2D = 0
TX_CLASS_HORIZ = 1
TX_CLASS_VERT = 2

TX_PAD_HOR = 4
NUM_BASE_LEVELS = 2
COEFF_BASE_RANGE = 12
BR_CDF_SIZE = 4
COEFF_CONTEXT_BITS = 6
COEFF_CONTEXT_MASK = (1 << COEFF_CONTEXT_BITS) - 1
SIG_COEF_CONTEXTS_2D = 26

# tx_type -> coefficient-coding class
tx_type_class = np.array(
    [TX_CLASS_2D] * 10 +
    [TX_CLASS_VERT, TX_CLASS_HORIZ, TX_CLASS_VERT, TX_CLASS_HORIZ,
     TX_CLASS_VERT, TX_CLASS_HORIZ], dtype=np.int32)

# eob group tables (spec k_eob_group_start / k_eob_offset_bits)
K_EOB_GROUP_START = np.array(
    [0, 1, 2, 3, 5, 9, 17, 33, 65, 129, 257, 513], dtype=np.int32)
K_EOB_OFFSET_BITS = np.array(
    [0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9], dtype=np.int32)


@functools.lru_cache(maxsize=1)
def _scans():
    return dict(np.load(os.path.join(_DATA_DIR, "av1_scan_tables.npz")))


def adjusted_tx_size(tx_size: int) -> int:
    """64-point dimensions are coded as 32 (av1_get_adjusted_tx_size)."""
    return {cc.TX_64X64: cc.TX_32X32, cc.TX_64X32: cc.TX_32X32,
            cc.TX_32X64: cc.TX_32X32, cc.TX_64X16: cc.TX_32X16,
            cc.TX_16X64: cc.TX_16X32}.get(tx_size, tx_size)


def txb_dims(tx_size: int):
    """(bwl, width, height) of the *coded* txb (adjusted size)."""
    adj = adjusted_tx_size(tx_size)
    w = int(cc.tx_size_wide[adj])
    h = int(cc.tx_size_high[adj])
    return int(np.log2(w)), w, h


@functools.lru_cache(maxsize=None)
def get_scan(tx_size: int, tx_type: int) -> np.ndarray:
    """Scan table: array of raster positions in scan order (coded dims)."""
    adj = adjusted_tx_size(tx_size)
    w = int(cc.tx_size_wide[adj])
    h = int(cc.tx_size_high[adj])
    cls = int(tx_type_class[tx_type])
    kind = {TX_CLASS_2D: "default", TX_CLASS_VERT: "mrow",
            TX_CLASS_HORIZ: "mcol"}[cls]
    name = f"{kind}_scan_{w}x{h}"
    # scan tables are named by the canonical (w x h) of their definition;
    # the reference stores rect scans under WxH as coded
    s = _scans()
    if name in s:
        return s[name].astype(np.int32)
    raise KeyError(name)


@functools.lru_cache(maxsize=None)
def txsize_log2_minus4(tx_size: int) -> int:
    _, w, h = txb_dims(tx_size)
    return int(np.log2(w * h)) - 4


def txs_ctx(tx_size: int) -> int:
    """Context tx-size index: (sqr + sqr_up + 1) >> 1."""
    return (int(cc.tx_size_sqr[tx_size]) +
            int(cc.tx_size_sqr_up[tx_size]) + 1) >> 1


@functools.lru_cache(maxsize=None)
def nz_map_ctx_offset(tx_size: int) -> np.ndarray:
    """2-D-class base-level context offsets per raster position.

    Normative generation rule (spec / get_nz_map_ctx_from_stats comment);
    uses the *unadjusted* aspect for the branch and the coded grid for
    indexing.  Verified against the reference tables in tests."""
    width = int(cc.tx_size_wide[tx_size])
    height = int(cc.tx_size_high[tx_size])
    bwl, w, h = txb_dims(tx_size)
    out = np.zeros(h * w, dtype=np.int32)
    for row in range(h):
        for col in range(w):
            idx = (row << bwl) + col
            if width < height and row < 2:
                out[idx] = 11
            elif width > height and col < 2:
                out[idx] = 16
            elif row + col < 2:
                out[idx] = 1
            elif row + col < 4:
                out[idx] = 6
            else:
                out[idx] = 21
    out[0] = 0  # DC in 2-D class short-circuits to context 0
    return out


NZ_MAP_CTX_OFFSET_1D = np.array(
    [SIG_COEF_CONTEXTS_2D, SIG_COEF_CONTEXTS_2D + 5] +
    [SIG_COEF_CONTEXTS_2D + 10] * 30, dtype=np.int32)
