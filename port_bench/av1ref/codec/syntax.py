"""Tile-level AV1 syntax: partition tree, intra mode info, residual
coding, and all neighbor-context state.

Behavioral reference: entropy_coding.c (write_modes_b / svt_aom_write_sb,
partition + kf mode contexts) and the AV1 spec decode_partition /
intra_frame_mode_info / residual.  Encoder (`TileEncoder`) and parser
(`TileDecoder`) share the context machinery so they stay in lockstep by
construction.

Round-1 scope: key/intra frames, 4:2:0, single tile, square partitions
(NONE / SPLIT), TX_MODE_LARGEST.  Frame dims must be multiples of 8.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from av1ref.codec import constants as cc
from av1ref.codec import tables as tb
from av1ref.codec import coeff as coeff_mod
from av1ref.codec import mv as mv_mod
from av1ref.codec import mv_pred
from av1ref.codec.cdf import FrameCDFs
from av1ref.codec.entropy import RangeDecoder, update_cdf

# spec tables ---------------------------------------------------------------

INTRA_MODE_CONTEXT = np.array([0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0],
                              dtype=np.int32)

# partition_context_lookup (above, left) per block size
PARTITION_CTX_LOOKUP = np.array([
    (31, 31), (31, 30), (30, 31), (30, 30), (30, 28), (28, 30), (28, 28),
    (28, 24), (24, 28), (24, 24), (24, 16), (16, 24), (16, 16), (16, 0),
    (0, 16), (0, 0), (31, 28), (28, 31), (30, 24), (24, 30), (28, 16),
    (16, 28)], dtype=np.int32)

# square block size per partition depth starting at 64x64
SQ_BSIZE = {64: cc.BLOCK_64X64, 32: cc.BLOCK_32X32, 16: cc.BLOCK_16X16,
            8: cc.BLOCK_8X8, 4: cc.BLOCK_4X4}
# max rect tx size for block sizes (TX_MODE_LARGEST)
MAX_TX = {cc.BLOCK_8X8: cc.TX_8X8, cc.BLOCK_16X16: cc.TX_16X16,
          cc.BLOCK_32X32: cc.TX_32X32, cc.BLOCK_64X64: cc.TX_64X64,
          cc.BLOCK_16X8: cc.TX_16X8, cc.BLOCK_8X16: cc.TX_8X16,
          cc.BLOCK_32X16: cc.TX_32X16, cc.BLOCK_16X32: cc.TX_16X32,
          cc.BLOCK_64X32: cc.TX_64X32, cc.BLOCK_32X64: cc.TX_32X64}
# square parent -> rect child for PARTITION_HORZ / PARTITION_VERT
HORZ_SUBSIZE = {cc.BLOCK_64X64: cc.BLOCK_64X32,
                cc.BLOCK_32X32: cc.BLOCK_32X16,
                cc.BLOCK_16X16: cc.BLOCK_16X8}
VERT_SUBSIZE = {cc.BLOCK_64X64: cc.BLOCK_32X64,
                cc.BLOCK_32X32: cc.BLOCK_16X32,
                cc.BLOCK_16X16: cc.BLOCK_8X16}

# ext-tx signaling tables (definitions.h / cabac_context_model.h)
EXT_TX_SET_DCTONLY = 0
EXT_TX_SET_DCT_IDTX = 1
EXT_TX_SET_DTT4_IDTX = 2
EXT_TX_SET_DTT4_IDTX_1DDCT = 3
EXT_TX_SET_DTT9_IDTX_1DDCT = 4
EXT_TX_SET_ALL16 = 5

AV1_NUM_EXT_TX_SET = [1, 2, 5, 7, 12, 16]
AV1_EXT_TX_IND = np.array([
    [0] * 16,
    [1] + [0] * 8 + [0] + [0] * 6,
    [1, 3, 4, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    [1, 5, 6, 4, 0, 0, 0, 0, 0, 0, 2, 3, 0, 0, 0, 0],
    [3, 4, 5, 8, 6, 7, 9, 10, 11, 0, 1, 2, 0, 0, 0, 0],
    [7, 8, 9, 12, 10, 11, 13, 14, 15, 0, 1, 2, 3, 4, 5, 6]],
    dtype=np.int32)
AV1_EXT_TX_USED = np.array([
    [1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    [1, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0],
    [1, 1, 1, 1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0],
    [1, 1, 1, 1, 0, 0, 0, 0, 0, 1, 1, 1, 0, 0, 0, 0],
    [1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0],
    [1] * 16], dtype=np.int32)
EXT_TX_SET_INDEX_INTRA = {EXT_TX_SET_DCTONLY: 0,
                          EXT_TX_SET_DTT4_IDTX_1DDCT: 1,
                          EXT_TX_SET_DTT4_IDTX: 2}

# y_mode size-group contexts (definitions.h:1600 size_group_lookup)
SIZE_GROUP = np.array([0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3,
                       0, 0, 1, 1, 2, 2], dtype=np.int32)

# ext-tx set index for inter frames (get_ext_tx_set: ext_tx_set_index[1])
EXT_TX_SET_INDEX_INTER = {EXT_TX_SET_DCTONLY: 0, EXT_TX_SET_ALL16: 1,
                          EXT_TX_SET_DTT9_IDTX_1DDCT: 2,
                          EXT_TX_SET_DCT_IDTX: 3}

# intra mode -> implied tx type (chroma / unsignaled; common_utils.h)
INTRA_MODE_TO_TX_TYPE = np.array([
    cc.DCT_DCT, cc.ADST_DCT, cc.DCT_ADST, cc.DCT_DCT, cc.ADST_ADST,
    cc.ADST_DCT, cc.DCT_ADST, cc.DCT_ADST, cc.ADST_DCT, cc.ADST_ADST,
    cc.ADST_DCT, cc.DCT_ADST, cc.ADST_ADST], dtype=np.int32)


def get_ext_tx_set_type(tx_size: int, is_inter: bool, reduced: bool) -> int:
    sqr_up = int(cc.tx_size_sqr_up[tx_size])
    if sqr_up > cc.TX_32X32:
        return EXT_TX_SET_DCTONLY
    if sqr_up == cc.TX_32X32:
        return EXT_TX_SET_DCT_IDTX if is_inter else EXT_TX_SET_DCTONLY
    if reduced:
        return EXT_TX_SET_DCT_IDTX if is_inter else EXT_TX_SET_DTT4_IDTX
    sqr = int(cc.tx_size_sqr[tx_size])
    if is_inter:
        return (EXT_TX_SET_DTT9_IDTX_1DDCT if sqr == cc.TX_16X16
                else EXT_TX_SET_ALL16)
    return (EXT_TX_SET_DTT4_IDTX if sqr == cc.TX_16X16
            else EXT_TX_SET_DTT4_IDTX_1DDCT)


def max_chroma_tx_size(luma_bsize: int) -> int:
    """Chroma tx size for 4:2:0 blocks (TX_MODE_LARGEST)."""
    return {cc.BLOCK_8X8: cc.TX_4X4, cc.BLOCK_16X16: cc.TX_8X8,
            cc.BLOCK_32X32: cc.TX_16X16, cc.BLOCK_64X64: cc.TX_32X32,
            cc.BLOCK_16X8: cc.TX_8X4, cc.BLOCK_8X16: cc.TX_4X8,
            cc.BLOCK_32X16: cc.TX_16X8, cc.BLOCK_16X32: cc.TX_8X16,
            cc.BLOCK_64X32: cc.TX_32X16, cc.BLOCK_32X64: cc.TX_16X32}[
                luma_bsize]


@dataclasses.dataclass
class BlockDecision:
    """Leaf coding decisions for one square block."""
    r4: int                 # mi row
    c4: int                 # mi col
    bsize: int
    y_mode: int
    uv_mode: int
    tx_type: int            # luma tx type
    qcoeff_y: np.ndarray    # (txh, txw) int32 levels
    qcoeff_u: Optional[np.ndarray]
    qcoeff_v: Optional[np.ndarray]
    # directional-mode angle refinement (spec AngleDeltaY/UV, +-3)
    angle_delta_y: int = 0
    angle_delta_uv: int = 0
    # CfL alphas, signed q3 in [-16, 16] (uv_mode == UV_CFL_PRED)
    cfl_alpha_u: int = 0
    cfl_alpha_v: int = 0
    # inter fields (inter frames only)
    is_inter: bool = False
    mv: tuple = (0, 0)      # (row, col) 1/8 pel
    ref: int = mv_pred.LAST_FRAME
    # GLOBALMV with a non-translation model: warped prediction
    use_warp: bool = False
    # compound: second reference (0 = NONE) and its MV
    ref2: int = 0
    mv2: tuple = (0, 0)
    # masked compound: 0 = COMPOUND_AVERAGE, 1 = COMPOUND_WEDGE,
    # 2 = COMPOUND_DIFFWTD (wedge_sign doubles as the mask_type)
    comp_type: int = 0
    wedge_idx: int = 0
    wedge_sign: int = 0
    # motion mode: 0 = SIMPLE_TRANSLATION, 1 = OBMC_CAUSAL
    motion_mode: int = 0
    # inter-intra: -1 = off, else II_DC..II_SMOOTH; ii_wedge_idx >= 0
    # switches the blend to the wedge mask (sign 0)
    interintra_mode: int = -1
    ii_wedge_idx: int = -1
    # per-SB adaptive quantization (0 = frame base_q_idx)
    qindex: int = 0
    # recursive filter-intra (y_mode == DC_PRED carrier); -1 = off
    filter_intra_mode: int = -1
    # palette (y_mode == DC_PRED carrier): sorted base colors + the
    # per-pixel color index map (block luma dims)
    palette: Optional[np.ndarray] = None
    palette_map: Optional[np.ndarray] = None
    # AV1 skip_mode: block coded as one symbol implying compound
    # NEAREST_NEARESTMV on the frame's skip-mode ref pair with skip=1
    # (set by the tile coder on eligible blocks; decode mirrors)
    skip_mode: bool = False

    @property
    def skip(self) -> bool:
        return (not self.qcoeff_y.any()
                and (self.qcoeff_u is None or not self.qcoeff_u.any())
                and (self.qcoeff_v is None or not self.qcoeff_v.any()))


class ContextState:
    """All neighbor-context state for one tile."""

    def __init__(self, mi_rows: int, mi_cols: int):
        self.mi_rows = mi_rows
        self.mi_cols = mi_cols
        self.above_part = np.zeros(mi_cols, dtype=np.int32)
        self.left_part = np.zeros(mi_rows, dtype=np.int32)
        # entropy (cul_level | dc_sign<<6) per plane, in plane 4x4 units
        self.above_coeff = [np.zeros((mi_cols + 1) >> s, dtype=np.int32)
                            for s in (0, 1, 1)]
        self.left_coeff = [np.zeros((mi_rows + 1) >> s, dtype=np.int32)
                           for s in (0, 1, 1)]
        # MI grids
        self.mi_mode = np.full((mi_rows, mi_cols), cc.DC_PRED, np.int32)
        self.mi_skip = np.zeros((mi_rows, mi_cols), np.int32)
        self.mi_coded = np.zeros((mi_rows, mi_cols), bool)
        self.mi_is_inter = np.zeros((mi_rows, mi_cols), np.int32)
        self.mi_ref = np.zeros((mi_rows, mi_cols), np.int32)  # 0 = INTRA
        self.mi_ref2 = np.zeros((mi_rows, mi_cols), np.int32)  # 0 = NONE
        self.mi_skip_mode = np.zeros((mi_rows, mi_cols), np.int32)

    def start_sb_row(self):
        self.left_part[:] = 0
        for p in range(3):
            self.left_coeff[p][:] = 0

    # ---- partition ----
    def partition_ctx(self, r4, c4, bsize) -> int:
        bsl = int(np.log2(cc.block_size_wide[bsize])) - 3
        above = (int(self.above_part[c4]) >> bsl) & 1
        left = (int(self.left_part[r4]) >> bsl) & 1
        return (left * 2 + above) + bsl * 4

    def update_partition(self, r4, c4, subsize, bsize):
        w4 = int(cc.block_size_wide[bsize]) >> 2
        h4 = int(cc.block_size_high[bsize]) >> 2
        av, lv = PARTITION_CTX_LOOKUP[subsize]
        self.above_part[c4:c4 + w4] = av
        self.left_part[r4:r4 + h4] = lv

    # ---- modes ----
    def kf_y_ctx(self, r4, c4):
        above = (int(self.mi_mode[r4 - 1, c4])
                 if r4 > 0 and self.mi_coded[r4 - 1, c4] else cc.DC_PRED)
        left = (int(self.mi_mode[r4, c4 - 1])
                if c4 > 0 and self.mi_coded[r4, c4 - 1] else cc.DC_PRED)
        return int(INTRA_MODE_CONTEXT[above]), int(INTRA_MODE_CONTEXT[left])

    def skip_ctx(self, r4, c4):
        above = (int(self.mi_skip[r4 - 1, c4])
                 if r4 > 0 and self.mi_coded[r4 - 1, c4] else 0)
        left = (int(self.mi_skip[r4, c4 - 1])
                if c4 > 0 and self.mi_coded[r4, c4 - 1] else 0)
        return above + left

    def skip_mode_ctx(self, r4, c4):
        above = (int(self.mi_skip_mode[r4 - 1, c4])
                 if r4 > 0 and self.mi_coded[r4 - 1, c4] else 0)
        left = (int(self.mi_skip_mode[r4, c4 - 1])
                if c4 > 0 and self.mi_coded[r4, c4 - 1] else 0)
        return above + left

    def set_block(self, r4, c4, bsize, mode, skip, is_inter=False,
                  ref=0, ref2=0, skip_mode=0):
        w4 = int(cc.block_size_wide[bsize]) >> 2
        h4 = int(cc.block_size_high[bsize]) >> 2
        self.mi_mode[r4:r4 + h4, c4:c4 + w4] = mode
        self.mi_skip[r4:r4 + h4, c4:c4 + w4] = int(skip)
        self.mi_coded[r4:r4 + h4, c4:c4 + w4] = True
        self.mi_is_inter[r4:r4 + h4, c4:c4 + w4] = int(is_inter)
        self.mi_ref[r4:r4 + h4, c4:c4 + w4] = ref if is_inter else 0
        self.mi_ref2[r4:r4 + h4, c4:c4 + w4] = ref2 if is_inter else 0
        self.mi_skip_mode[r4:r4 + h4, c4:c4 + w4] = int(skip_mode)

    def comp_mode_ctx(self, r4, c4) -> int:
        """av1_get_reference_mode_context (single-vs-compound flag)."""
        def bwd(r, c):
            return (self.mi_is_inter[r, c]
                    and self.mi_ref[r, c] >= mv_pred.BWDREF_FRAME)

        def comp(r, c):
            return self.mi_ref2[r, c] > 0

        has_a = r4 > 0 and self.mi_coded[r4 - 1, c4]
        has_l = c4 > 0 and self.mi_coded[r4, c4 - 1]
        a = (r4 - 1, c4)
        l = (r4, c4 - 1)
        if has_a and has_l:
            if not comp(*a) and not comp(*l):
                return int(bool(bwd(*a)) ^ bool(bwd(*l)))
            if not comp(*a):
                return 2 + int(bwd(*a) or not self.mi_is_inter[a])
            if not comp(*l):
                return 2 + int(bwd(*l) or not self.mi_is_inter[l])
            return 4
        if has_a:
            return int(bool(bwd(*a))) if not comp(*a) else 3
        if has_l:
            return int(bool(bwd(*l))) if not comp(*l) else 3
        return 1

    def comp_ref_type_ctx(self, r4, c4) -> int:
        """av1_get_comp_reference_type_context (uni vs bidir pairs;
        our streams only code BIDIR, all pairs here are fwd+bwd)."""
        def inter(r, c):
            return bool(self.mi_is_inter[r, c])

        def comp(r, c):
            return self.mi_ref2[r, c] > 0

        def bwd0(r, c):
            return self.mi_ref[r, c] >= mv_pred.BWDREF_FRAME

        has_a = r4 > 0 and self.mi_coded[r4 - 1, c4]
        has_l = c4 > 0 and self.mi_coded[r4, c4 - 1]
        a = (r4 - 1, c4)
        l = (r4, c4 - 1)
        if has_a and has_l:
            ai, li = inter(*a), inter(*l)
            if not ai and not li:
                return 2
            if not ai or not li:
                e = l if not ai else a
                if not comp(*e):
                    return 2
                return 3  # bidir pairs only in our streams
            asg, lsg = not comp(*a), not comp(*l)
            if asg and lsg:
                return 1 + 2 * int(not (bool(bwd0(*a)) ^ bool(bwd0(*l))))
            if asg or lsg:
                return 3
            return 4
        if has_a or has_l:
            e = a if has_a else l
            if not inter(*e):
                return 2
            if not comp(*e):
                return 2
            return 3
        return 2

    # ---- inter contexts ----
    def intra_inter_ctx(self, r4, c4) -> int:
        """svt_av1_get_intra_inter_context (entropy_coding.c:1202)."""
        has_above = r4 > 0 and self.mi_coded[r4 - 1, c4]
        has_left = c4 > 0 and self.mi_coded[r4, c4 - 1]
        if has_above and has_left:
            ai = int(not self.mi_is_inter[r4 - 1, c4])
            li = int(not self.mi_is_inter[r4, c4 - 1])
            return 3 if (ai and li) else (ai or li)
        if has_above:
            return 2 * int(not self.mi_is_inter[r4 - 1, c4])
        if has_left:
            return 2 * int(not self.mi_is_inter[r4, c4 - 1])
        return 0

    def neighbor_ref_counts(self, r4, c4) -> np.ndarray:
        """Counts per MvReferenceFrame (1..7) over above/left mbmi."""
        counts = np.zeros(8, np.int32)
        if r4 > 0 and self.mi_coded[r4 - 1, c4]:
            ref = int(self.mi_ref[r4 - 1, c4])
            if ref > 0:
                counts[ref] += 1
        if c4 > 0 and self.mi_coded[r4, c4 - 1]:
            ref = int(self.mi_ref[r4, c4 - 1])
            if ref > 0:
                counts[ref] += 1
        return counts

    def single_ref_ctxs(self, r4, c4):
        """(p1..p6) contexts (entropy_coding.c:2031-2081): each is the
        equal?1 : (a<b ? 0 : 2) comparison over neighbor ref counts."""
        n = self.neighbor_ref_counts(r4, c4)

        def cmp(a, b):
            return 1 if a == b else (0 if a < b else 2)

        fwd = int(n[1] + n[2] + n[3] + n[4])
        bwd = int(n[5] + n[6] + n[7])
        ll2 = int(n[1] + n[2])
        l3g = int(n[3] + n[4])
        brfarf2 = int(n[5] + n[6])
        return (cmp(fwd, bwd),                 # p1: fwd vs bwd
                cmp(brfarf2, int(n[7])),       # p2: BWD/ALT2 vs ALT
                cmp(ll2, l3g),                 # p3
                cmp(int(n[1]), int(n[2])),     # p4: LAST vs LAST2
                cmp(int(n[3]), int(n[4])),     # p5: LAST3 vs GOLDEN
                cmp(int(n[5]), int(n[6])))     # p6: BWD vs ALT2

    # ---- coefficients ----
    def txb_ctx(self, plane: int, pr4: int, pc4: int, tx_size: int,
                plane_bsize_eq_tx: bool):
        """(txb_skip_ctx, dc_sign_ctx) at plane 4x4 coords.

        Mirrors svt_aom_get_txb_ctx."""
        _, tw, th = tb.txb_dims(tx_size)
        w_unit = tw >> 2
        h_unit = th >> 2
        above = self.above_coeff[plane][pc4:pc4 + w_unit]
        left = self.left_coeff[plane][pr4:pr4 + h_unit]
        # dc sign
        signs = np.array([0, -1, 1], dtype=np.int32)
        dc_sign = int(signs[(above >> tb.COEFF_CONTEXT_BITS)].sum()
                      + signs[(left >> tb.COEFF_CONTEXT_BITS)].sum())
        dc_sign_ctx = 2 if dc_sign > 0 else (1 if dc_sign < 0 else 0)
        if plane == 0:
            if plane_bsize_eq_tx:
                skip_ctx = 0
            else:
                skip_contexts = np.array(
                    [[1, 2, 2, 2, 3], [1, 4, 4, 4, 5], [1, 4, 4, 4, 5],
                     [1, 4, 4, 4, 5], [1, 4, 4, 4, 6]], dtype=np.int32)
                top = int(np.bitwise_or.reduce(above)
                          if len(above) else 0) & tb.COEFF_CONTEXT_MASK
                lft = int(np.bitwise_or.reduce(left)
                          if len(left) else 0) & tb.COEFF_CONTEXT_MASK
                mx = min(top | lft, 4)
                mn = min(min(top, lft), 4)
                skip_ctx = int(skip_contexts[mn][mx])
        else:
            ca = int((above != 0).sum() != 0)
            cl = int((left != 0).sum() != 0)
            # ctx_offset: 7 when plane bsize == tx coverage else 10
            skip_ctx = (7 if plane_bsize_eq_tx else 10) + ca + cl
        return skip_ctx, dc_sign_ctx

    def set_txb_ctx(self, plane: int, pr4: int, pc4: int, tx_size: int,
                    cul_level: int):
        _, tw, th = tb.txb_dims(tx_size)
        self.above_coeff[plane][pc4:pc4 + (tw >> 2)] = cul_level
        self.left_coeff[plane][pr4:pr4 + (th >> 2)] = cul_level


class TileCoderBase:
    def __init__(self, width: int, height: int, base_q_idx: int,
                 reduced_tx_set: bool = False, update_cdfs: bool = True,
                 frame_is_intra: bool = True, init_cdfs=None,
                 init_nmv=None):
        self.width = width
        self.height = height
        self.mi_rows = (height + 3) >> 2
        self.mi_cols = (width + 3) >> 2
        self.base_q_idx = base_q_idx
        self.reduced_tx_set = reduced_tx_set
        self.update = update_cdfs
        self.frame_is_intra = frame_is_intra
        # primary_ref_frame chaining: start from the reference frame's
        # end-of-frame CDF state when provided (spec init_non_coeff_cdfs)
        self.cdfs = init_cdfs.clone() if init_cdfs is not None \
            else FrameCDFs(base_q_idx)
        self.nmv = init_nmv.clone() if init_nmv is not None \
            else mv_mod.NmvCDFs()
        # loop restoration: list of codec.lr.PlaneLrInfo or None
        self.lr = None
        self.lr_ref = None
        # global motion: {ref_enum: (row, col) 1/8-pel}; absent = identity
        self.gm = {}
        # MV coding precision (frame allow_high_precision_mv)
        self.mv_precision = mv_mod.MV_SUBPEL_LOW
        # per-SB delta_q (None = disabled)
        self.delta_q_res = None
        self.current_qindex = base_q_idx
        self._read_deltas = False
        self.ctx = ContextState(self.mi_rows, self.mi_cols)
        self.migrid = mv_pred.MiGrid(self.mi_rows, self.mi_cols)
        # motion-mode switching (frame header bit; OBMC flag coding)
        self.is_motion_mode_switchable = False
        # inter-intra compound (sequence enable_interintra_compound)
        self.enable_interintra = False
        # masked compound (wedge): sequence gate + per-mi neighbor
        # contribution for the comp_group_idx context
        # (svt_aom_get_comp_group_idx_context_enc: comp_group_idx of a
        # compound neighbor, 3 for a single-ref ALTREF neighbor, else 0)
        self.enable_masked_compound = False
        self.cgi_map = np.zeros((self.mi_rows, self.mi_cols), np.int8)
        self.sb_cols = (self.mi_cols + 15) >> 4
        self.sb_rows = (self.mi_rows + 15) >> 4
        # per-SB CDEF strength index (cdef_bits > 0); -1 = not coded
        # yet — written/read at the first non-skip block of each SB
        # (spec read_cdef, 5.11.56)
        self.cdef_bits = 0
        self.cdef_idx = np.full((self.sb_rows, self.sb_cols), -1,
                                np.int32)
        self._cdef_map = None
        # sequence-level enable_filter_intra: eligible DC blocks code a
        # use_filter_intra flag (spec filter_intra_mode_info, 5.11.31)
        self.enable_filter_intra = False
        # frame-level reference_select: inter blocks code a comp_mode
        # flag (single vs compound reference)
        self.reference_select = False
        # frame-level skip mode (spec 5.9.22 / 5.11.11): when present,
        # eligible blocks code one skip_mode symbol implying compound
        # NEAREST_NEARESTMV on skip_mode_frames with skip=1.
        # interp_filter mirrors the frame header: conversion requires
        # REGULAR (a spec decoder predicts skip-mode blocks with
        # REGULAR, av1_is_interp_needed==0) unless the MV pair is
        # full-pel (filter irrelevant)
        self.skip_mode_present = False
        self.skip_mode_frames = (0, 0)
        self.interp_filter = 0
        # palette (spec 5.11.46-49): allowed when the frame signals
        # allow_screen_content_tools; per-mi size/colors feed the mode
        # context and color cache of later blocks
        self.allow_palette = False
        self.bit_depth = 8
        self.pal_size = np.zeros((self.mi_rows, self.mi_cols), np.int8)
        self.pal_colors = np.zeros((self.mi_rows, self.mi_cols, 8),
                                   np.uint16)
        # temporal MVP (spec 7.9/7.10.2): projected motion field of
        # the current frame + order-hint context for per-ref offsets
        self.tmvp = None
        self.cur_hint = 0
        self.ref_hints = {}
        self.order_hint_bits = 0
        # segmentation (SEG_LVL_ALT_Q on intra frames): params + coded
        # per-mi segment-id map (spec read_segment_id, 5.11.14)
        self.seg = None
        self.seg_ids = None
        self._seg_map = None

    def set_segmentation(self, seg, seg_map=None) -> None:
        """seg: SegmentationParams; seg_map (encoder side): (mi_rows,
        mi_cols) desired segment ids."""
        self.seg = seg
        self.seg_ids = np.zeros((self.mi_rows, self.mi_cols), np.int32)
        if seg_map is not None:
            self._seg_map = np.asarray(seg_map, np.int32)

    def _skip_mode_block_allowed(self, bsize) -> bool:
        """Per-block skip_mode gate: frame-level present + compound
        refs allowed for the size (is_comp_ref_allowed: w, h >= 8)."""
        return (self.skip_mode_present and not self.frame_is_intra
                and int(cc.block_size_wide[bsize]) >= 8
                and int(cc.block_size_high[bsize]) >= 8)

    def _code_segment_id(self, r4, c4, bsize, skip, dec=None) -> int:
        """Spatially-predicted segment id (spec 5.11.14); encoder side
        when dec is None.  Returns the coded id and records it for the
        block's mi region (future neighbor prediction)."""
        from av1ref.codec import segmentation as seg_mod
        pred, ctx_id = seg_mod.seg_pred_and_ctx(self.seg_ids, r4, c4)
        mx = self.seg.last_active_seg_id + 1
        if skip:
            sid = pred
        else:
            cdf = self.cdfs.spatial_pred_seg[ctx_id]
            if dec is None:
                sid = min(int(self._seg_map[r4, c4]), mx - 1)
                diff = seg_mod.neg_interleave(sid, pred, mx)
                self.enc.encode_symbol(diff, cdf, seg_mod.MAX_SEGMENTS)
            else:
                diff = dec.read_symbol(cdf, seg_mod.MAX_SEGMENTS)
                sid = int(np.clip(
                    seg_mod.neg_deinterleave(diff, pred, mx), 0, mx - 1))
            if self.update:
                update_cdf(cdf, diff, seg_mod.MAX_SEGMENTS)
        w4 = int(cc.block_size_wide[bsize]) >> 2
        h4 = int(cc.block_size_high[bsize]) >> 2
        self.seg_ids[r4:r4 + h4, c4:c4 + w4] = sid
        return sid

    # compound_mode_ctx_map (aom av1_mode_context_analyzer)
    _COMP_MODE_CTX_MAP = ((0, 1, 1, 1, 1), (1, 2, 3, 4, 4),
                          (4, 4, 5, 6, 7))

    def _comp_mode_cdf_ctx(self, mode_context: int) -> int:
        newmv_ctx = mode_context & 7
        refmv_ctx = (mode_context >> mv_pred.REFMV_OFFSET) & 0xF
        return self._COMP_MODE_CTX_MAP[min(refmv_ctx >> 1, 2)][
            min(newmv_ctx, 4)]

    def _code_comp_refs(self, r4, c4, dec=None, refs=None):
        """Compound reference-pair coding (BIDIR only; trees from
        write_ref_frames compound branch).  Encoder: refs=(fwd, bwd);
        decoder returns the pair."""
        enc_or_dec = self.enc if dec is None else dec
        p1, p2, p3, p4, p5, p6 = self.ctx.single_ref_ctxs(r4, c4)
        tctx = self.ctx.comp_ref_type_ctx(r4, c4)

        def bit(cdf, val=None):
            if dec is None:
                enc_or_dec.encode_symbol(int(val), cdf, 2)
                out = int(val)
            else:
                out = dec.read_symbol(cdf, 2)
            if self.update:
                update_cdf(cdf, out, 2)
            return out

        # comp_reference_type: 1 = BIDIR
        t = bit(self.cdfs.comp_ref_type[tctx],
                1 if dec is None else None)
        assert t == 1, "unidirectional compound unsupported"
        if dec is None:
            fwd, bwd = refs
            assert fwd == mv_pred.LAST_FRAME \
                and bwd == mv_pred.ALTREF_FRAME
            bit(self.cdfs.comp_ref[p3][0], 0)   # LAST/LAST2 group
            bit(self.cdfs.comp_ref[p4][1], 0)   # LAST
            bit(self.cdfs.comp_bwdref[p2][0], 1)  # ALTREF
            return fwd, bwd
        b0 = bit(self.cdfs.comp_ref[p3][0])
        if b0 == 0:
            b1 = bit(self.cdfs.comp_ref[p4][1])
            fwd = mv_pred.LAST2_FRAME if b1 else mv_pred.LAST_FRAME
        else:
            b2 = bit(self.cdfs.comp_ref[p5][2])
            fwd = mv_pred.GOLDEN_FRAME if b2 else mv_pred.LAST3_FRAME
        c0 = bit(self.cdfs.comp_bwdref[p2][0])
        if c0:
            bwd = mv_pred.ALTREF_FRAME
        else:
            c1 = bit(self.cdfs.comp_bwdref[p6][1])
            bwd = mv_pred.ALTREF2_FRAME if c1 else mv_pred.BWDREF_FRAME
        return fwd, bwd

    def _code_comp_mode_and_drl(self, cmode, stackc, dec=None):
        """inter_compound_mode symbol (+ drl for NEW_NEWMV, idx 0)."""
        cctx = self._comp_mode_cdf_ctx(stackc.mode_context)
        cdf = self.cdfs.inter_compound_mode[cctx]
        if dec is None:
            self.enc.encode_symbol(cmode, cdf, 8)
        else:
            cmode = dec.read_symbol(cdf, 8)
        if self.update:
            update_cdf(cdf, cmode, 8)
        if cmode == 7:      # NEW_NEWMV: drl (always index 0)
            if stackc.count > 1:
                dctx = stackc.drl_ctx(0)
                dcdf = self.cdfs.drl[dctx]
                if dec is None:
                    self.enc.encode_symbol(0, dcdf, 2)
                    d0 = 0
                else:
                    d0 = dec.read_symbol(dcdf, 2)
                if self.update:
                    update_cdf(dcdf, d0, 2)
                assert d0 == 0, "drl > 0 unsupported in compound"
        return cmode

    def _motion_mode_allowed(self, r4, c4, bsize, use_warp) -> bool:
        """motion_mode_allowed (single-ref callers only): block >= 8x8,
        not a global-warp block, and at least one overlappable (inter)
        neighbor above or left (check_num_overlappable_neighbors)."""
        if not self.is_motion_mode_switchable or use_warp:
            return False
        bw = int(cc.block_size_wide[bsize])
        bh = int(cc.block_size_high[bsize])
        if min(bw, bh) < 8:
            return False
        w4 = bw >> 2
        h4 = bh >> 2
        rf = self.migrid.ref_frame
        if r4 > 0 and (rf[r4 - 1, c4:min(c4 + w4, self.mi_cols)]
                       > mv_pred.INTRA_FRAME).any():
            return True
        if c4 > 0 and (rf[r4:min(r4 + h4, self.mi_rows), c4 - 1]
                       > mv_pred.INTRA_FRAME).any():
            return True
        return False

    def _code_motion_mode(self, r4, c4, bsize, use_warp,
                          motion_mode=0, dec=None) -> int:
        """OBMC flag (obmc_cdf) for eligible single-ref blocks — the
        seq has enable_warped_motion = 0, so the motion-mode choice is
        binary SIMPLE vs OBMC_CAUSAL (read_motion_mode; write side
        entropy_coding.c write_motion_mode)."""
        if not self._motion_mode_allowed(r4, c4, bsize, use_warp):
            return 0
        cdf = self.cdfs.obmc[bsize]
        if dec is None:
            self.enc.encode_symbol(motion_mode, cdf, 2)
            mm = motion_mode
        else:
            mm = dec.read_symbol(cdf, 2)
        if self.update:
            update_cdf(cdf, mm, 2)
        return mm

    def _interintra_allowed(self, bsize, ref2) -> bool:
        """is_interintra_allowed: sequence gate, single ref, wedge-class
        sizes (8x8..32x32)."""
        bw = int(cc.block_size_wide[bsize])
        bh = int(cc.block_size_high[bsize])
        return (self.enable_interintra and not ref2
                and min(bw, bh) >= 8 and max(bw, bh) <= 32)

    def _code_interintra(self, bsize, ii_mode=-1, ii_wedge=-1,
                         dec=None):
        """interintra flag + mode [+ wedge flag + index] for an
        eligible single-ref block (entropy_coding.c:5109-5137).
        ii_mode: -1 = off, else II_DC..II_SMOOTH.  ii_wedge: -1 =
        smooth blend, else wedge index (sign fixed 0).  Returns the
        coded (ii_mode, ii_wedge)."""
        grp = int(SIZE_GROUP[bsize])
        fcdf = self.cdfs.interintra[grp]
        use = int(ii_mode >= 0)
        if dec is None:
            self.enc.encode_symbol(use, fcdf, 2)
        else:
            use = dec.read_symbol(fcdf, 2)
        if self.update:
            update_cdf(fcdf, use, 2)
        if not use:
            return -1, -1
        mcdf = self.cdfs.interintra_mode[grp]
        if dec is None:
            self.enc.encode_symbol(ii_mode, mcdf, 4)
            mm = ii_mode
        else:
            mm = dec.read_symbol(mcdf, 4)
        if self.update:
            update_cdf(mcdf, mm, 4)
        # wedge-interintra availability == wedge sizes, which equals
        # the interintra eligibility set (8x8..32x32) — always coded
        wi = -1
        wcdf = self.cdfs.wedge_interintra[bsize]
        uw = int(ii_wedge >= 0)
        if dec is None:
            self.enc.encode_symbol(uw, wcdf, 2)
        else:
            uw = dec.read_symbol(wcdf, 2)
        if self.update:
            update_cdf(wcdf, uw, 2)
        if uw:
            icdf = self.cdfs.wedge_idx[bsize]
            if dec is None:
                self.enc.encode_symbol(ii_wedge, icdf, 16)
                wi = ii_wedge
            else:
                wi = dec.read_symbol(icdf, 16)
            if self.update:
                update_cdf(icdf, wi, 16)
        return mm, wi

    def _masked_compound_allowed(self, bsize) -> bool:
        """is_any_masked_compound_used: DIFFWTD is available for every
        comp-ref size (>= 8x8); wedge only for 8x8..32x32."""
        bw = int(cc.block_size_wide[bsize])
        bh = int(cc.block_size_high[bsize])
        return self.enable_masked_compound and min(bw, bh) >= 8

    @staticmethod
    def _wedge_available(bsize) -> bool:
        bw = int(cc.block_size_wide[bsize])
        bh = int(cc.block_size_high[bsize])
        return min(bw, bh) >= 8 and max(bw, bh) <= 32

    def _code_compound_type(self, r4, c4, bsize, comp_type=0,
                            wedge_idx=0, wedge_sign=0, dec=None):
        """comp_group_idx + compound_type + wedge/diffwtd syntax for a
        compound block (spec read_compound_type; write side
        entropy_coding.c:5146-5200).  comp_type: 0 COMPOUND_AVERAGE,
        1 COMPOUND_WEDGE, 2 COMPOUND_DIFFWTD (wedge_sign doubles as the
        DIFFWTD_38_INV mask_type).  With enable_jnt_comp = 0 (our
        sequence), comp_group_idx == 0 implies compound_idx = 1 (plain
        average), so no compound_idx symbol is coded.  Returns the
        coded (comp_type, wedge_idx, wedge_sign/mask_type)."""
        if not self._masked_compound_allowed(bsize):
            return 0, 0, 0
        above = int(self.cgi_map[r4 - 1, c4]) if r4 > 0 else 0
        left = int(self.cgi_map[r4, c4 - 1]) if c4 > 0 else 0
        gcdf = self.cdfs.comp_group_idx[min(5, above + left)]
        gi = int(comp_type > 0)
        if dec is None:
            self.enc.encode_symbol(gi, gcdf, 2)
        else:
            gi = dec.read_symbol(gcdf, 2)
        if self.update:
            update_cdf(gcdf, gi, 2)
        if not gi:
            return 0, 0, 0
        if not self._wedge_available(bsize):
            t = 1                  # DIFFWTD implied (no wedge masks)
        else:
            tcdf = self.cdfs.compound_type[bsize]
            if dec is None:
                t = comp_type - 1      # 0 WEDGE, 1 DIFFWTD
                self.enc.encode_symbol(t, tcdf, 2)
            else:
                t = dec.read_symbol(tcdf, 2)
            if self.update:
                update_cdf(tcdf, t, 2)
        if t == 1:                 # DIFFWTD: mask_type literal
            if dec is None:
                self.enc.encode_literal(wedge_sign, 1)
                mt = wedge_sign
            else:
                mt = dec.read_literal(1)
            return 2, 0, mt
        wcdf = self.cdfs.wedge_idx[bsize]
        if dec is None:
            self.enc.encode_symbol(wedge_idx, wcdf, 16)
            self.enc.encode_literal(wedge_sign, 1)
            wi, ws = wedge_idx, wedge_sign
        else:
            wi = dec.read_symbol(wcdf, 16)
            ws = dec.read_literal(1)
        if self.update:
            update_cdf(wcdf, wi, 16)
        return 1, wi, ws

    def _filter_intra_allowed(self, bsize, is_inter, y_mode,
                              pal_n: int = 0) -> bool:
        """Spec FilterIntraAllowed (requires PaletteSizeY == 0)."""
        return (self.enable_filter_intra and not is_inter
                and y_mode == cc.DC_PRED and pal_n == 0
                and int(cc.block_size_wide[bsize]) <= 32
                and int(cc.block_size_high[bsize]) <= 32)

    # ---- palette (spec 5.11.46-49) ----
    def _palette_block_allowed(self, bsize, is_inter) -> bool:
        """palette_mode_info gate WITHOUT the luma-mode condition
        (spec 5.11.46 / entropy_coding.c:4272): inside the block gate,
        the y bit is coded only for y_mode==DC_PRED but the uv bit is
        coded for ANY intra luma mode when uv_mode==DC_PRED."""
        return (self.allow_palette and self.frame_is_intra
                and not is_inter
                and 8 <= int(cc.block_size_wide[bsize]) <= 64
                and 8 <= int(cc.block_size_high[bsize]) <= 64)

    def _palette_allowed(self, bsize, is_inter, y_mode) -> bool:
        return (self._palette_block_allowed(bsize, is_inter)
                and y_mode == cc.DC_PRED)

    def _palette_cache(self, r4, c4):
        from av1ref.codec import palette as pal
        above = None
        # above palettes are not referenced across a 64px SB row
        if r4 > 0 and (r4 % 16) != 0 and self.pal_size[r4 - 1, c4] > 0:
            n = int(self.pal_size[r4 - 1, c4])
            above = self.pal_colors[r4 - 1, c4, :n]
        left = None
        if c4 > 0 and self.pal_size[r4, c4 - 1] > 0:
            n = int(self.pal_size[r4, c4 - 1])
            left = self.pal_colors[r4, c4 - 1, :n]
        return pal.merge_cache(above, left)

    def _palette_mode_ctx(self, r4, c4) -> int:
        ctx = 0
        if r4 > 0:
            ctx += int(self.pal_size[r4 - 1, c4] > 0)
        if c4 > 0:
            ctx += int(self.pal_size[r4, c4 - 1] > 0)
        return ctx

    def _set_palette_maps(self, r4, c4, bsize, colors) -> None:
        w4 = int(cc.block_size_wide[bsize]) >> 2
        h4 = int(cc.block_size_high[bsize]) >> 2
        sl = (slice(r4, r4 + h4), slice(c4, c4 + w4))
        n = 0 if colors is None else len(colors)
        self.pal_size[sl] = n
        if n:
            self.pal_colors[sl + (slice(0, n),)] = \
                np.asarray(colors, np.uint16)

    def set_cdef(self, bits: int, idx_map=None) -> None:
        """Enable per-SB cdef_idx coding.  idx_map: (sb_rows, sb_cols)
        chosen strength indices (encoder side only)."""
        self.cdef_bits = int(bits)
        if idx_map is not None:
            self._cdef_map = np.asarray(idx_map, np.int32)

    def set_gm(self, gm_trans) -> None:
        """gm_trans: FrameParams.gm_trans tuple (index 0 = LAST)."""
        self.gm = {i + 1: mv for i, mv in enumerate(gm_trans)
                   if mv is not None}

    def set_lr(self, lr) -> None:
        from av1ref.codec import lr as lr_mod
        self.lr = lr
        self.lr_ref = lr_mod._RefState()

    def set_delta_q(self, res_log2: int) -> None:
        """Enable per-SB delta_q coding (spec read_delta_qindex)."""
        self.delta_q_res = res_log2
        self.current_qindex = self.base_q_idx
        self._read_deltas = False

    def _code_delta_q(self, coder, target_qindex: int,
                      is_decoder: bool) -> None:
        """Code/parse one SB's qindex delta; updates current_qindex."""
        cdf = self.cdfs.delta_q
        if is_decoder:
            ab = coder.read_symbol(cdf, 4)
            if self.update:
                update_cdf(cdf, ab, 4)
            if ab == 3:
                rem = coder.read_literal(3) + 1
                ab = coder.read_literal(rem) + (1 << rem) + 1
            reduced = 0
            if ab:
                reduced = -ab if coder.read_literal(1) else ab
        else:
            want = target_qindex if target_qindex else self.base_q_idx
            reduced = (want - self.current_qindex) >> self.delta_q_res
            ab = abs(reduced)
            sym = min(ab, 3)
            coder.encode_symbol(sym, cdf, 4)
            if self.update:
                update_cdf(cdf, sym, 4)
            if ab >= 3:
                rem = (ab - 1).bit_length() - 1
                coder.encode_literal(rem - 1, 3)
                coder.encode_literal(ab - 1 - (1 << rem), rem)
            if ab:
                coder.encode_literal(int(reduced < 0), 1)
        self.current_qindex = int(np.clip(
            self.current_qindex + (reduced << self.delta_q_res), 1, 255))

    # shared helpers ---------------------------------------------------------
    def _tmvp_off(self, ref: int) -> int:
        """get_relative_dist(cur, ref) for the temporal-MV projection."""
        return mv_pred.get_relative_dist(
            self.order_hint_bits, self.cur_hint,
            self.ref_hints.get(ref, 0))

    def tx_type_signaled(self, tx_size: int, is_inter: bool = False) -> bool:
        set_type = get_ext_tx_set_type(tx_size, is_inter,
                                       self.reduced_tx_set)
        return (AV1_NUM_EXT_TX_SET[set_type] > 1) and (self.base_q_idx > 0)

    def _map_inter_mode(self, mv, stack: mv_pred.MvStack, gm_mv=(0, 0),
                        use_warp=False, gm_is_warp=False):
        """Cheapest legal signaling of ``mv`` given the MV stack.

        With a non-translation gm model, GLOBALMV implies the warped
        prediction: warped winners MUST signal GLOBALMV and
        translational winners must NOT."""
        if use_warp:
            return mv_pred.GLOBALMV
        if tuple(mv) == tuple(stack.mvs[0]):
            return mv_pred.NEARESTMV
        if not gm_is_warp and tuple(mv) == tuple(gm_mv):
            return mv_pred.GLOBALMV
        if len(stack.mvs) > 1 and tuple(mv) == tuple(stack.mvs[1]):
            return mv_pred.NEARMV
        return mv_pred.NEWMV

    def _set_migrid(self, r4, c4, bsize, d, is_inter, inter_mode):
        """Record this block in the MV-prediction grid.  The stored mode
        matters downstream: NEWMV feeds later blocks' newmv counts and
        GLOBALMV substitutes (0,0) in their stacks."""
        w4 = int(cc.block_size_wide[bsize]) >> 2
        h4 = int(cc.block_size_high[bsize]) >> 2
        if is_inter:
            self.migrid.set_block(r4, c4, w4, h4, d.ref, inter_mode,
                                  d.mv[0], d.mv[1], ref2=d.ref2,
                                  mv2=d.mv2)
            cgi = (int(d.comp_type > 0) if d.ref2
                   else 3 if d.ref == mv_pred.ALTREF_FRAME else 0)
        else:
            self.migrid.set_block(r4, c4, w4, h4, mv_pred.INTRA_FRAME,
                                  0, 0, 0, ref2=0, mv2=(0, 0))
            cgi = 0
        self.cgi_map[r4:r4 + h4, c4:c4 + w4] = cgi


class TileDecoder(TileCoderBase):
    """Parses one tile; returns BlockDecisions (for recon by the shared
    reconstruction pipeline) — the verification mirror of TileEncoder."""

    def decode(self, data: bytes) -> Dict[tuple, BlockDecision]:
        self.dec = RangeDecoder(data)
        self.out: Dict[tuple, BlockDecision] = {}
        for sb_r in range(self.sb_rows):
            self.ctx.start_sb_row()
            for sb_c in range(self.sb_cols):
                if self.lr is not None:
                    from av1ref.codec import lr as lr_mod
                    lr_mod.read_lr_for_sb(
                        self.dec, self.cdfs, self.lr, self.lr_ref,
                        sb_r * 16, sb_c * 16, self.mi_rows, self.mi_cols,
                        self.update)
                self._read_deltas = self.delta_q_res is not None
                self._decode_partition(sb_r * 16, sb_c * 16, cc.BLOCK_64X64)
        return self.out

    def _decode_partition(self, r4, c4, bsize):
        if r4 >= self.mi_rows or c4 >= self.mi_cols:
            return
        w4 = int(cc.block_size_wide[bsize]) >> 2
        half = w4 >> 1
        has_rows = (r4 + half) < self.mi_rows
        has_cols = (c4 + half) < self.mi_cols
        size = int(cc.block_size_wide[bsize])

        ctx_id = self.ctx.partition_ctx(r4, c4, bsize)
        cdf = self.cdfs.partition[ctx_id]
        nsyms = _partition_nsyms(bsize)
        if size == 4:
            part = cc.PARTITION_NONE
        elif has_rows and has_cols:
            part = self.dec.read_symbol(cdf, nsyms)
            if self.update:
                update_cdf(cdf, part, nsyms)
        elif has_cols:
            bit = self.dec.read_bool(_gather_horz_alike(cdf, bsize, nsyms))
            part = cc.PARTITION_SPLIT if bit else cc.PARTITION_HORZ
        elif has_rows:
            bit = self.dec.read_bool(_gather_vert_alike(cdf, bsize, nsyms))
            part = cc.PARTITION_SPLIT if bit else cc.PARTITION_VERT
        else:
            part = cc.PARTITION_SPLIT

        if part == cc.PARTITION_NONE:
            self._decode_block(r4, c4, bsize)
            self.ctx.update_partition(r4, c4, bsize, bsize)
        elif part == cc.PARTITION_SPLIT:
            sub = SQ_BSIZE[size >> 1]
            self._decode_partition(r4, c4, sub)
            self._decode_partition(r4, c4 + half, sub)
            self._decode_partition(r4 + half, c4, sub)
            self._decode_partition(r4 + half, c4 + half, sub)
        elif part == cc.PARTITION_HORZ:
            sub = HORZ_SUBSIZE[bsize]
            self._decode_block(r4, c4, sub)
            if has_rows:
                self._decode_block(r4 + half, c4, sub)
            self.ctx.update_partition(r4, c4, sub, bsize)
        elif part == cc.PARTITION_VERT:
            sub = VERT_SUBSIZE[bsize]
            self._decode_block(r4, c4, sub)
            if has_cols:
                self._decode_block(r4, c4 + half, sub)
            self.ctx.update_partition(r4, c4, sub, bsize)
        else:
            raise NotImplementedError("ext (AB/4) partitions")

    def _decode_block(self, r4, c4, bsize):
        dec, cdfs, ctx = self.dec, self.cdfs, self.ctx
        sm = 0
        if self._skip_mode_block_allowed(bsize):
            smctx = ctx.skip_mode_ctx(r4, c4)
            sm = dec.read_symbol(cdfs.skip_mode[smctx], 2)
            if self.update:
                update_cdf(cdfs.skip_mode[smctx], sm, 2)
        if sm:
            skip = 1
        else:
            sctx = ctx.skip_ctx(r4, c4)
            skip = dec.read_symbol(cdfs.skip[sctx], 2)
            if self.update:
                update_cdf(cdfs.skip[sctx], skip, 2)

        seg_id = 0
        if self.seg is not None and self.frame_is_intra:
            assert not self.seg.seg_id_pre_skip
            seg_id = self._code_segment_id(r4, c4, bsize, skip, dec=dec)

        if self.cdef_bits and not skip:
            sr, sc = r4 >> 4, c4 >> 4
            if self.cdef_idx[sr, sc] < 0:
                self.cdef_idx[sr, sc] = dec.read_literal(self.cdef_bits)

        if self._read_deltas:
            self._code_delta_q(dec, 0, is_decoder=True)
            self._read_deltas = False

        is_inter = False
        inter_mode = 0
        mv = (0, 0)
        mv2 = (0, 0)
        ref2 = 0
        comp_type = wedge_idx = wedge_sign = 0
        motion_mode = 0
        ii_mode = ii_wedge = -1
        use_warp = False
        ref = mv_pred.LAST_FRAME
        y_mode = cc.DC_PRED
        uv_mode = cc.DC_PRED
        angle_y = 0
        angle_uv = 0
        cfl_au = 0
        cfl_av = 0
        if sm:
            is_inter = True
            ref, ref2 = self.skip_mode_frames
            stackc = mv_pred.find_mv_stack_comp(
                self.migrid, r4, c4,
                int(cc.block_size_wide[bsize]) >> 2,
                int(cc.block_size_high[bsize]) >> 2, (ref, ref2),
                tmvp=self.tmvp,
                cur_offs=(self._tmvp_off(ref), self._tmvp_off(ref2)))
            mv, mv2 = stackc.pairs[0]
            inter_mode = mv_pred.NEARESTMV
        elif self.frame_is_intra:
            actx, lctx = ctx.kf_y_ctx(r4, c4)
            cdf = cdfs.kf_y_mode[actx][lctx]
            y_mode = dec.read_symbol(cdf, cc.INTRA_MODES)
            if self.update:
                update_cdf(cdf, y_mode, cc.INTRA_MODES)
            angle_y = self._read_angle(y_mode)
        else:
            ictx = ctx.intra_inter_ctx(r4, c4)
            is_inter = bool(dec.read_symbol(cdfs.intra_inter[ictx], 2))
            if self.update:
                update_cdf(cdfs.intra_inter[ictx], int(is_inter), 2)
            if is_inter:
                is_comp = False
                if self.reference_select:
                    cmctx = ctx.comp_mode_ctx(r4, c4)
                    ccdf = cdfs.comp_inter[cmctx]
                    is_comp = bool(dec.read_symbol(ccdf, 2))
                    if self.update:
                        update_cdf(ccdf, int(is_comp), 2)
                if is_comp:
                    ref, ref2 = self._code_comp_refs(r4, c4, dec=dec)
                    w4b = int(cc.block_size_wide[bsize]) >> 2
                    h4b = int(cc.block_size_high[bsize]) >> 2
                    stackc = mv_pred.find_mv_stack_comp(
                        self.migrid, r4, c4, w4b, h4b, (ref, ref2),
                        tmvp=self.tmvp,
                        cur_offs=(self._tmvp_off(ref),
                                  self._tmvp_off(ref2)))
                    cmode = self._code_comp_mode_and_drl(
                        None, stackc, dec=dec)
                    if cmode == 7:
                        mv = mv_mod.decode_mv(dec, stackc.pairs[0][0],
                                              self.nmv,
                                              self.mv_precision,
                                              update=self.update)
                        mv2 = mv_mod.decode_mv(dec, stackc.pairs[0][1],
                                               self.nmv,
                                               self.mv_precision,
                                               update=self.update)
                    elif cmode == 0:
                        mv, mv2 = stackc.pairs[0]
                    else:
                        raise NotImplementedError(
                            f"compound mode {cmode}")
                    inter_mode = (mv_pred.NEWMV if cmode == 7
                                  else mv_pred.NEARESTMV)
                    comp_type, wedge_idx, wedge_sign = \
                        self._code_compound_type(r4, c4, bsize, dec=dec)
                else:
                    ref = self._read_single_ref(r4, c4)
                    gm_model = self.gm.get(ref)
                    gm_mv = mv_pred.gm_block_mv(
                        gm_model, r4, c4, bsize,
                        allow_hp=self.mv_precision >= mv_mod.MV_SUBPEL_HIGH)
                    stack = mv_pred.find_mv_stack(
                        self.migrid, r4, c4,
                        int(cc.block_size_wide[bsize]) >> 2,
                        int(cc.block_size_high[bsize]) >> 2, ref=ref,
                        gm_mv=gm_mv, tmvp=self.tmvp,
                        cur_off=self._tmvp_off(ref))
                    inter_mode, drl = self._read_inter_mode(stack)
                    if inter_mode == mv_pred.NEWMV:
                        mv = mv_mod.decode_mv(dec, stack.mvs[drl],
                                              self.nmv,
                                              self.mv_precision,
                                              update=self.update)
                    elif inter_mode == mv_pred.NEARESTMV:
                        mv = tuple(stack.mvs[0])
                    elif inter_mode == mv_pred.NEARMV:
                        mv = tuple(stack.mvs[1 + drl])
                    else:  # GLOBALMV (this ref's global mv)
                        mv = tuple(gm_mv)
                        # non-translation models warp the prediction
                        # (spec 7.11.3: >= 8x8 with a valid shear)
                        if gm_model is not None and len(gm_model) == 6:
                            use_warp = True
                    if self._interintra_allowed(bsize, 0):
                        ii_mode, ii_wedge = self._code_interintra(
                            bsize, dec=dec)
                    if ii_mode < 0:
                        motion_mode = self._code_motion_mode(
                            r4, c4, bsize, use_warp, dec=dec)
            else:
                grp = int(SIZE_GROUP[bsize])
                cdf = cdfs.y_mode[grp]
                y_mode = dec.read_symbol(cdf, cc.INTRA_MODES)
                if self.update:
                    update_cdf(cdf, y_mode, cc.INTRA_MODES)
                angle_y = self._read_angle(y_mode)

        has_chroma = True
        if not is_inter:
            cfl_allowed = int(cc.block_size_wide[bsize] <= 32
                              and cc.block_size_high[bsize] <= 32)
            ucdf = cdfs.uv_mode[cfl_allowed][y_mode]
            nsyms = cc.UV_INTRA_MODES if cfl_allowed else cc.INTRA_MODES
            uv_mode = dec.read_symbol(ucdf, nsyms)
            if self.update:
                update_cdf(ucdf, uv_mode, nsyms)
            if uv_mode == cc.UV_CFL_PRED:
                cfl_au, cfl_av = self._read_cfl_alphas()
            angle_uv = self._read_angle(uv_mode)

        pal_n = 0
        pal_colors = None
        if self._palette_block_allowed(bsize, is_inter):
            from av1ref.codec import palette as pal
            bctx = pal.bsize_ctx(bsize)
            has_pal = 0
            if y_mode == cc.DC_PRED:
                mctx = self._palette_mode_ctx(r4, c4)
                mcdf2 = cdfs.palette_y_mode[bctx][mctx]
                has_pal = dec.read_symbol(mcdf2, 2)
                if self.update:
                    update_cdf(mcdf2, has_pal, 2)
            if has_pal:
                scdf = cdfs.palette_y_size[bctx]
                pal_n = dec.read_symbol(scdf, pal.PALETTE_SIZES) \
                    + pal.PALETTE_MIN_SIZE
                if self.update:
                    update_cdf(scdf, pal_n - pal.PALETTE_MIN_SIZE,
                               pal.PALETTE_SIZES)
                cache = self._palette_cache(r4, c4)
                reused = []
                for cv in cache:
                    if len(reused) >= pal_n:
                        break
                    if dec.read_literal(1):
                        reused.append(int(cv))
                fresh = pal.delta_decode_colors(
                    dec, pal_n - len(reused), self.bit_depth)
                pal_colors = np.array(sorted(reused + fresh),
                                      np.uint16)
            if uv_mode == cc.DC_PRED:
                ucdf2 = cdfs.palette_uv_mode[int(pal_n > 0)]
                uv_pal = dec.read_symbol(ucdf2, 2)
                if self.update:
                    update_cdf(ucdf2, uv_pal, 2)
                assert uv_pal == 0, "uv palette unsupported"

        fi_mode = -1
        if self._filter_intra_allowed(bsize, is_inter, y_mode, pal_n):
            cdf = cdfs.filter_intra[bsize]
            use = dec.read_symbol(cdf, 2)
            if self.update:
                update_cdf(cdf, use, 2)
            if use:
                mcdf = cdfs.filter_intra_mode
                fi_mode = dec.read_symbol(mcdf, cc.FILTER_INTRA_MODES)
                if self.update:
                    update_cdf(mcdf, fi_mode, cc.FILTER_INTRA_MODES)

        pal_map = None
        if pal_n:
            from av1ref.codec import palette as pal
            bw_px = int(cc.block_size_wide[bsize])
            bh_px = int(cc.block_size_high[bsize])
            pal_map = np.zeros((bh_px, bw_px), np.uint8)
            pal_map[0, 0] = pal.read_uniform(dec, pal_n)
            size_idx = pal_n - pal.PALETTE_MIN_SIZE
            for (rr, cc_) in pal.diagonal_scan(bh_px, bw_px):
                cctx, _ = pal.color_index_ctx(pal_map, rr, cc_)
                ccdf = cdfs.palette_y_color[size_idx][cctx]
                coded = dec.read_symbol(ccdf, pal_n)
                if self.update:
                    update_cdf(ccdf, coded, pal_n)
                pal_map[rr, cc_] = pal.inv_color_index(pal_map, rr,
                                                       cc_, coded)
        if not is_inter:
            self._set_palette_maps(r4, c4, bsize,
                                   pal_colors if pal_n else None)

        ctx.set_block(r4, c4, bsize, y_mode, skip, is_inter, ref,
                      ref2=ref2, skip_mode=sm)
        d_for_grid = BlockDecision(
            r4=r4, c4=c4, bsize=bsize, y_mode=y_mode, uv_mode=uv_mode,
            tx_type=cc.DCT_DCT, qcoeff_y=np.zeros((1, 1), np.int32),
            qcoeff_u=None, qcoeff_v=None, is_inter=is_inter, mv=mv,
            ref=ref, ref2=ref2, mv2=mv2, comp_type=comp_type)
        self._set_migrid(r4, c4, bsize, d_for_grid, is_inter, inter_mode)

        tx_size = MAX_TX[bsize]
        _, tw, th = tb.txb_dims(tx_size)
        ctx_tx = max_chroma_tx_size(bsize)
        _, cw, ch = tb.txb_dims(ctx_tx)
        tx_type = cc.DCT_DCT
        if skip:
            qy = np.zeros((th, tw), np.int32)
            qu = np.zeros((ch, cw), np.int32)
            qv = np.zeros((ch, cw), np.int32)
            # mirror encoder context reset
            w4 = int(cc.block_size_wide[bsize]) >> 2
            h4 = int(cc.block_size_high[bsize]) >> 2
            ctx.above_coeff[0][c4:c4 + w4] = 0
            ctx.left_coeff[0][r4:r4 + h4] = 0
            for p in (1, 2):
                ctx.above_coeff[p][c4 >> 1:(c4 + w4) >> 1] = 0
                ctx.left_coeff[p][r4 >> 1:(r4 + h4) >> 1] = 0
        else:
            tctx, dctx = ctx.txb_ctx(0, r4, c4, tx_size, True)
            state = {}

            def read_tx_type():
                state["t"] = self._read_tx_type(tx_size, y_mode, is_inter)
                return state["t"]

            qy, eob, cul = coeff_mod.decode_txb(
                dec, cdfs, tx_size, 0, tctx, dctx,
                read_tx_type=read_tx_type
                if self.tx_type_signaled(tx_size, is_inter)
                else None, update=self.update)
            tx_type = state.get("t", cc.DCT_DCT)
            ctx.set_txb_ctx(0, r4, c4, tx_size, cul)
            ctx_r, ctx_c = r4 >> 1, c4 >> 1
            if is_inter:
                uv_tx_type = _chroma_tx_type_inter(
                    tx_type, ctx_tx, self.reduced_tx_set)
            else:
                uv_tx_type = _chroma_tx_type(uv_mode, ctx_tx)
            qs = []
            for plane in (1, 2):
                tctx, dctx = ctx.txb_ctx(plane, ctx_r, ctx_c, ctx_tx, True)
                q, eob, cul = coeff_mod.decode_txb(
                    dec, cdfs, ctx_tx, 1, tctx, dctx,
                    read_tx_type=lambda: uv_tx_type, update=self.update)
                ctx.set_txb_ctx(plane, ctx_r, ctx_c, ctx_tx, cul)
                qs.append(q)
            qu, qv = qs

        self.out[(r4, c4)] = BlockDecision(
            r4=r4, c4=c4, bsize=bsize, y_mode=y_mode, uv_mode=uv_mode,
            tx_type=tx_type, qcoeff_y=qy, qcoeff_u=qu, qcoeff_v=qv,
            is_inter=is_inter, mv=mv, ref=ref, use_warp=use_warp,
            ref2=ref2, mv2=mv2, comp_type=comp_type,
            wedge_idx=wedge_idx, wedge_sign=wedge_sign,
            motion_mode=motion_mode, interintra_mode=ii_mode,
            ii_wedge_idx=ii_wedge,
            angle_delta_y=angle_y, angle_delta_uv=angle_uv,
            cfl_alpha_u=cfl_au, cfl_alpha_v=cfl_av,
            qindex=(self.current_qindex
                    if self.delta_q_res is not None
                    else (self.seg.qindex_for(seg_id, self.base_q_idx)
                          if self.seg is not None else 0)),
            filter_intra_mode=fi_mode, skip_mode=bool(sm),
            palette=pal_colors, palette_map=pal_map)

    def _read_cfl_alphas(self):
        dec = self.dec
        cdf = self.cdfs.cfl_sign
        js = dec.read_symbol(cdf, 8)
        if self.update:
            update_cdf(cdf, js, 8)
        su = (js + 1) // 3
        sv = (js + 1) - 3 * su
        au = av = 0
        if su:
            cdf_u = self.cdfs.cfl_alpha[js - 2]
            m = dec.read_symbol(cdf_u, 16)
            if self.update:
                update_cdf(cdf_u, m, 16)
            au = (m + 1) if su == 2 else -(m + 1)
        if sv:
            cdf_v = self.cdfs.cfl_alpha[sv * 3 + su - 3]
            m = dec.read_symbol(cdf_v, 16)
            if self.update:
                update_cdf(cdf_v, m, 16)
            av = (m + 1) if sv == 2 else -(m + 1)
        return au, av

    def _read_angle(self, mode) -> int:
        if cc.V_PRED <= mode <= cc.D67_PRED:
            acdf = self.cdfs.angle_delta[mode - cc.V_PRED]
            delta = self.dec.read_symbol(acdf, 7)
            if self.update:
                update_cdf(acdf, delta, 7)
            return delta - 3
        return 0

    def _read_single_ref(self, r4, c4) -> int:
        p1, p2, p3, p4, p5, p6 = self.ctx.single_ref_ctxs(r4, c4)

        def rbit(ctx_id, bit_id):
            cdf = self.cdfs.single_ref[ctx_id][bit_id]
            b = self.dec.read_symbol(cdf, 2)
            if self.update:
                update_cdf(cdf, b, 2)
            return b

        if rbit(p1, 0):                       # backward group
            if rbit(p2, 1):
                return mv_pred.ALTREF_FRAME
            return (mv_pred.ALTREF2_FRAME if rbit(p6, 5)
                    else mv_pred.BWDREF_FRAME)
        if rbit(p3, 2):                       # LAST3/GOLDEN
            return (mv_pred.GOLDEN_FRAME if rbit(p5, 4)
                    else mv_pred.LAST3_FRAME)
        return (mv_pred.LAST2_FRAME if rbit(p4, 3)
                else mv_pred.LAST_FRAME)

    def _read_inter_mode(self, stack: mv_pred.MvStack):
        dec, cdfs = self.dec, self.cdfs
        mode_ctx = stack.mode_context
        newmv_ctx = mode_ctx & 7
        b = dec.read_symbol(cdfs.newmv[newmv_ctx], 2)
        if self.update:
            update_cdf(cdfs.newmv[newmv_ctx], b, 2)
        if b == 0:
            mode = mv_pred.NEWMV
        else:
            zeromv_ctx = (mode_ctx >> mv_pred.GLOBALMV_OFFSET) & 1
            b = dec.read_symbol(cdfs.zeromv[zeromv_ctx], 2)
            if self.update:
                update_cdf(cdfs.zeromv[zeromv_ctx], b, 2)
            if b == 0:
                mode = mv_pred.GLOBALMV
            else:
                refmv_ctx = (mode_ctx >> mv_pred.REFMV_OFFSET) & 0xF
                b = dec.read_symbol(cdfs.refmv[refmv_ctx], 2)
                if self.update:
                    update_cdf(cdfs.refmv[refmv_ctx], b, 2)
                mode = mv_pred.NEARMV if b else mv_pred.NEARESTMV
        # drl index
        drl = 0
        if mode == mv_pred.NEWMV:
            for idx in (0, 1):
                if stack.count > idx + 1:
                    dctx = stack.drl_ctx(idx)
                    b = dec.read_symbol(cdfs.drl[dctx], 2)
                    if self.update:
                        update_cdf(cdfs.drl[dctx], b, 2)
                    if b == 0:
                        drl = idx
                        break
                    drl = idx + 1
        elif mode == mv_pred.NEARMV:
            for idx in (1, 2):
                if stack.count > idx + 1:
                    dctx = stack.drl_ctx(idx)
                    b = dec.read_symbol(cdfs.drl[dctx], 2)
                    if self.update:
                        update_cdf(cdfs.drl[dctx], b, 2)
                    if b == 0:
                        drl = idx - 1
                        break
                    drl = idx
        return mode, drl

    def _read_tx_type(self, tx_size, intra_mode, is_inter=False):
        set_type = get_ext_tx_set_type(tx_size, is_inter,
                                       self.reduced_tx_set)
        sqr = int(cc.tx_size_sqr[tx_size])
        if is_inter:
            eset = EXT_TX_SET_INDEX_INTER[set_type]
            cdf = self.cdfs.inter_ext_tx[eset][sqr]
        else:
            eset = EXT_TX_SET_INDEX_INTRA[set_type]
            cdf = self.cdfs.intra_ext_tx[eset][sqr][intra_mode]
        nsyms = AV1_NUM_EXT_TX_SET[set_type]
        ind = self.dec.read_symbol(cdf, nsyms)
        if self.update:
            update_cdf(cdf, ind, nsyms)
        inv = np.nonzero(AV1_EXT_TX_IND[set_type] == ind)[0]
        used = [t for t in inv if AV1_EXT_TX_USED[set_type][t]]
        return int(used[0])


def _chroma_tx_type_inter(luma_tx_type: int, tx_size: int,
                          reduced: bool) -> int:
    """Chroma tx type for inter blocks: the luma tx type, reduced to the
    chroma tx size's legal set (spec compute_tx_type for plane > 0)."""
    set_type = get_ext_tx_set_type(tx_size, True, reduced)
    if not AV1_EXT_TX_USED[set_type][luma_tx_type]:
        return cc.DCT_DCT
    return luma_tx_type


def _chroma_tx_type(uv_mode: int, tx_size: int) -> int:
    """Implied chroma tx type: mode mapping, clamped to the legal set."""
    mode = cc.DC_PRED if uv_mode == cc.UV_CFL_PRED else uv_mode
    t = int(INTRA_MODE_TO_TX_TYPE[mode])
    # must be legal for this tx size (ADST <= 16pt); 32pt+ -> DCT
    if int(cc.tx_size_sqr_up[tx_size]) >= cc.TX_32X32:
        return cc.DCT_DCT
    return t


def _partition_nsyms(bsize: int) -> int:
    size = int(cc.block_size_wide[bsize])
    if size == 8:
        return 4
    if size == 128:
        return 8
    return 10


def _cdf_element_prob(icdf, elem: int) -> int:
    prev = 32768 if elem == 0 else int(icdf[elem - 1])
    return prev - int(icdf[elem])


def _gather_horz_alike(cdf, bsize: int, nsyms: int) -> int:
    """P(bit==1) Q15 for split_or_horz (spec partition gather)."""
    p0 = 32768
    p0 -= _cdf_element_prob(cdf, cc.PARTITION_HORZ)
    p0 -= _cdf_element_prob(cdf, cc.PARTITION_SPLIT)
    if nsyms > 4:
        p0 -= _cdf_element_prob(cdf, cc.PARTITION_HORZ_A)
        p0 -= _cdf_element_prob(cdf, cc.PARTITION_HORZ_B)
        p0 -= _cdf_element_prob(cdf, cc.PARTITION_VERT_A)
        if nsyms > 8:
            p0 -= _cdf_element_prob(cdf, cc.PARTITION_HORZ_4)
    return 32768 - p0


def _gather_vert_alike(cdf, bsize: int, nsyms: int) -> int:
    p0 = 32768
    p0 -= _cdf_element_prob(cdf, cc.PARTITION_VERT)
    p0 -= _cdf_element_prob(cdf, cc.PARTITION_SPLIT)
    if nsyms > 4:
        p0 -= _cdf_element_prob(cdf, cc.PARTITION_VERT_A)
        p0 -= _cdf_element_prob(cdf, cc.PARTITION_VERT_B)
        p0 -= _cdf_element_prob(cdf, cc.PARTITION_HORZ_A)
        if nsyms > 8:
            p0 -= _cdf_element_prob(cdf, cc.PARTITION_VERT_4)
    return 32768 - p0
