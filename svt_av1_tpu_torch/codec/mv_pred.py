"""Reference MV stack construction (AV1 spec §7.10.2 find_mv_stack).

Normative derivation, identically run by encoder and decoder; behavioral
reference: adaptive_mv_pred.c setup_ref_mv_list / scan_row_mbmi /
scan_col_mbmi / scan_blk_mbmi / scan_row_col_light / sort_mvp_table.

Round-1 scope: single reference frame, no temporal (ref-frame) MVs
(sequence signals enable_ref_frame_mvs = 0), global motion identity
(gm candidate = (0,0)).  MVs are (row, col) in 1/8-pel units.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

MAX_REF_MV_STACK_SIZE = 8
MAX_MV_REF_CANDIDATES = 2
REF_CAT_LEVEL = 640
MVREF_ROWS = 3
MV_BORDER = 16 * 8
NEWMV_OFFSET_BIT = 0      # low bits: newmv context
GLOBALMV_OFFSET = 3
REFMV_OFFSET = 4

INTRA_FRAME = 0
LAST_FRAME = 1
LAST2_FRAME = 2
LAST3_FRAME = 3
GOLDEN_FRAME = 4
BWDREF_FRAME = 5
ALTREF2_FRAME = 6
ALTREF_FRAME = 7

# inter prediction modes (PredictionMode tail; intra modes are 0..12)
NEARESTMV = 13
NEARMV = 14
GLOBALMV = 15
NEWMV = 16


def have_newmv(mode: int) -> bool:
    return mode == NEWMV


@dataclasses.dataclass
class MiGrid:
    """Per-4x4 mode info used by MV prediction (one frame)."""
    mi_rows: int
    mi_cols: int

    def __post_init__(self):
        shp = (self.mi_rows, self.mi_cols)
        self.ref_frame = np.full(shp, INTRA_FRAME, np.int8)
        self.mode = np.zeros(shp, np.uint8)
        self.mv = np.zeros(shp + (2,), np.int16)   # (row, col) 1/8 pel
        self.w4 = np.ones(shp, np.int8)            # block width in MI units
        self.h4 = np.ones(shp, np.int8)
        # compound: second reference (0 = NONE) and its MV
        self.ref2 = np.zeros(shp, np.int8)
        self.mv2 = np.zeros(shp + (2,), np.int16)

    def set_block(self, r4, c4, bw4, bh4, ref, mode, mv_row, mv_col,
                  ref2=0, mv2=(0, 0)):
        sl = (slice(r4, r4 + bh4), slice(c4, c4 + bw4))
        self.ref_frame[sl] = ref
        self.mode[sl] = mode
        self.mv[sl + (0,)] = mv_row
        self.mv[sl + (1,)] = mv_col
        self.w4[sl] = bw4
        self.h4[sl] = bh4
        self.ref2[sl] = ref2
        self.mv2[sl + (0,)] = mv2[0]
        self.mv2[sl + (1,)] = mv2[1]


class _Stack:
    def __init__(self):
        self.mvs: List[Tuple[int, int]] = []
        self.weights: List[int] = []

    def add(self, mv, len_, weight):
        for i, m in enumerate(self.mvs):
            if m == mv:
                self.weights[i] += weight * len_
                return
        if len(self.mvs) < MAX_REF_MV_STACK_SIZE:
            self.mvs.append(mv)
            self.weights.append(weight * len_)


def _clamp(v, lo, hi):
    return max(lo, min(hi, v))


@dataclasses.dataclass
class MvStack:
    mvs: List[Tuple[int, int]]      # clamped, padded to >= 2
    weights: List[int]
    count: int                      # true refmv_count (>= 2 after fill)
    mode_context: int

    def drl_ctx(self, idx: int) -> int:
        """av1_drl_ctx (rd_cost.h:69)."""
        w0 = self.weights[idx]
        w1 = self.weights[idx + 1]
        if w0 >= REF_CAT_LEVEL:
            return 0 if w1 >= REF_CAT_LEVEL else 1
        return 2 if w1 < REF_CAT_LEVEL else 0


def find_mv_stack(grid: MiGrid, mi_row: int, mi_col: int, bw4: int,
                  bh4: int, ref: int = LAST_FRAME, sb_mi: int = 16,
                  gm_mv=(0, 0), tmvp=None, cur_off: int = 0) -> MvStack:
    """Returns the ranked, clamped reference-MV stack + mode context.

    gm_mv: this reference's global motion vector — GLOBALMV neighbors
    contribute it and it pads an underfull stack (identity = (0,0))."""
    st = _Stack()
    mi_rows, mi_cols = grid.mi_rows, grid.mi_cols
    up = mi_row > 0
    left = mi_col > 0
    row_adj = 0  # blocks >= 8x8 only in round 1
    col_adj = 0
    max_row_offset = 0
    max_col_offset = 0
    if up:
        max_row_offset = max(-(MVREF_ROWS << 1) + row_adj, -mi_row)
    if left:
        max_col_offset = max(-(MVREF_ROWS << 1) + col_adj, -mi_col)

    counts = dict(row_match=0, col_match=0, newmv=0)
    processed = dict(rows=0, cols=0)

    def add_candidate(r, c, len_, weight, which):
        if grid.ref_frame[r, c] != ref:
            return
        mv = (int(grid.mv[r, c, 0]), int(grid.mv[r, c, 1]))
        # GLOBALMV blocks contribute this ref's global mv
        if grid.mode[r, c] == GLOBALMV:
            mv = tuple(gm_mv)
        st.add(mv, len_, weight)
        if have_newmv(int(grid.mode[r, c])):
            counts["newmv"] += 1
        counts[which] += 1

    def scan_row(row_offset):
        end_mi = min(bw4, mi_cols - mi_col, 16)
        col_off = 1 if abs(row_offset) > 1 else 0
        i = 0
        while i < end_mi:
            r = mi_row + row_offset
            c = mi_col + col_off + i
            cw4 = int(grid.w4[r, c])
            ch4 = int(grid.h4[r, c])
            len_ = min(bw4, cw4)
            if abs(row_offset) > 1:
                len_ = max(len_, 2)
            weight = 2
            if bw4 >= 2 and bw4 <= cw4:
                inc = min(-max_row_offset + row_offset + 1, ch4)
                weight = max(weight, inc)
                processed["rows"] = inc - row_offset - 1
            add_candidate(r, c, len_, weight, "row_match")
            i += len_

    def scan_col(col_offset):
        end_mi = min(bh4, mi_rows - mi_row, 16)
        row_off = 1 if abs(col_offset) > 1 else 0
        i = 0
        while i < end_mi:
            r = mi_row + row_off + i
            c = mi_col + col_offset
            cw4 = int(grid.w4[r, c])
            ch4 = int(grid.h4[r, c])
            len_ = min(bh4, ch4)
            if abs(col_offset) > 1:
                len_ = max(len_, 2)
            weight = 2
            if bh4 >= 2 and bh4 <= ch4:
                inc = min(-max_col_offset + col_offset + 1, cw4)
                weight = max(weight, inc)
                processed["cols"] = inc - col_offset - 1
            add_candidate(r, c, len_, weight, "col_match")
            i += len_

    def scan_blk(dr, dc, which):
        r, c = mi_row + dr, mi_col + dc
        if 0 <= r < mi_rows and 0 <= c < mi_cols:
            add_candidate(r, c, 2, 2, which)

    if abs(max_row_offset) >= 1:
        scan_row(-1)
    if abs(max_col_offset) >= 1:
        scan_col(-1)
    if _has_top_right(mi_row, mi_col, bw4, bh4, sb_mi, mi_cols):
        scan_blk(-1, bw4, "row_match")

    nearest_match = (counts["row_match"] > 0) + (counts["col_match"] > 0)
    newmv_count = counts["newmv"]
    st.weights = [w + REF_CAT_LEVEL for w in st.weights]

    # temporal MVs (spec 7.10.2 use_ref_frame_mvs scan)
    mode_flags = [0]
    if tmvp is not None:
        _temporal_scan(tmvp, mi_row, mi_col, bw4, bh4, (gm_mv,),
                       (cur_off, 0), st, mode_flags)

    scan_blk(-1, -1, "row_match")
    for idx in range(2, MVREF_ROWS + 1):
        row_offset = -(idx << 1) + 1 + row_adj
        col_offset = -(idx << 1) + 1 + col_adj
        if abs(row_offset) <= abs(max_row_offset) \
                and abs(row_offset) > processed["rows"]:
            scan_row(row_offset)
        if abs(col_offset) <= abs(max_col_offset) \
                and abs(col_offset) > processed["cols"]:
            scan_col(col_offset)

    ref_match_count = (counts["row_match"] > 0) + (counts["col_match"] > 0)
    mode_context = 0
    if nearest_match == 0:
        if ref_match_count >= 1:
            mode_context |= 1
        if ref_match_count == 1:
            mode_context |= (1 << REFMV_OFFSET)
        elif ref_match_count >= 2:
            mode_context |= (2 << REFMV_OFFSET)
    elif nearest_match == 1:
        mode_context |= 2 if newmv_count > 0 else 3
        if ref_match_count == 1:
            mode_context |= (3 << REFMV_OFFSET)
        elif ref_match_count >= 2:
            mode_context |= (4 << REFMV_OFFSET)
    else:
        mode_context |= 4 if newmv_count >= 1 else 5
        mode_context |= (5 << REFMV_OFFSET)
    mode_context |= mode_flags[0]

    # sort by weight (exact bubble from the reference, stable order)
    mvs, weights = st.mvs, st.weights
    n = len(mvs)
    ln = n
    while ln > 0:
        nr = 0
        for i in range(1, ln):
            if weights[i - 1] < weights[i]:
                mvs[i - 1], mvs[i] = mvs[i], mvs[i - 1]
                weights[i - 1], weights[i] = weights[i], weights[i - 1]
                nr = i
        ln = nr

    # light rescan to fill 2 candidates (single-ref path)
    count = n
    if n < MAX_MV_REF_CANDIDATES:
        mi_size = min(min(16, bw4), min(16, bh4),
                      mi_cols - mi_col, mi_rows - mi_row)
        for (scan_r, fixed, step_attr) in ((True, -1, "w4"),
                                           (False, -1, "h4")):
            if len(mvs) >= MAX_MV_REF_CANDIDATES:
                break
            valid = (abs(max_row_offset) >= 1 if scan_r
                     else abs(max_col_offset) >= 1)
            idx = 0
            while valid and idx < mi_size \
                    and len(mvs) < MAX_MV_REF_CANDIDATES:
                if scan_r:
                    r, c = mi_row - 1, mi_col + idx
                else:
                    r, c = mi_row + idx, mi_col - 1
                cb = int(getattr(grid, step_attr)[r, c])
                if grid.ref_frame[r, c] > INTRA_FRAME:
                    mv = (int(grid.mv[r, c, 0]), int(grid.mv[r, c, 1]))
                    if mv not in mvs:
                        mvs.append(mv)
                        weights.append(2)
                idx += cb
        while len(mvs) < MAX_MV_REF_CANDIDATES:
            mvs.append(tuple(gm_mv))
            weights.append(2)
        count = len(mvs)

    # clamp
    bw_px = bw4 * 4
    bh_px = bh4 * 4
    to_left = -(mi_col * 4 * 8)
    to_right = (mi_cols - bw4 - mi_col) * 4 * 8
    to_top = -(mi_row * 4 * 8)
    to_bottom = (mi_rows - bh4 - mi_row) * 4 * 8
    out = []
    for (r, c) in mvs:
        rr = _clamp(r, to_top - bh_px * 8 - MV_BORDER,
                    to_bottom + bh_px * 8 + MV_BORDER)
        cc = _clamp(c, to_left - bw_px * 8 - MV_BORDER,
                    to_right + bw_px * 8 + MV_BORDER)
        out.append((rr, cc))
    return MvStack(mvs=out, weights=weights, count=count,
                   mode_context=mode_context)


def _has_top_right(mi_row, mi_col, bw4, bh4, sb_mi, mi_cols) -> int:
    """has_top_right for square blocks (adaptive_mv_pred.c:266)."""
    bs = max(bw4, bh4)
    if bs > 16:
        return 0
    if mi_col + bw4 >= mi_cols or mi_row == 0:
        return 0
    mask_row = mi_row & (sb_mi - 1)
    mask_col = mi_col & (sb_mi - 1)
    has_tr = not ((mask_row & bs) and (mask_col & bs))
    b = bs
    while b < sb_mi:
        if mask_col & b:
            if (mask_col & (2 * b)) and (mask_row & (2 * b)):
                has_tr = 0
                break
        else:
            break
        b <<= 1
    return int(has_tr)


def gm_block_mv(model, r4: int, c4: int, bsize: int,
                allow_hp: bool = False):
    """Global-motion vector for a block (spec gm_get_motion_vector).

    model: (row, col) 1/8-pel translation, or a 6-tuple wmmat
    (ROTZOOM/affine) projected at the block center."""
    from svt_av1_tpu_torch.codec import constants as cc
    if model is None:
        return (0, 0)
    if len(model) == 2:
        return tuple(model)
    mat = model
    bw = int(cc.block_size_wide[bsize])
    bh = int(cc.block_size_high[bsize])
    x = c4 * 4 + bw // 2 - 1
    y = r4 * 4 + bh // 2 - 1
    xc = (mat[2] - (1 << 16)) * x + mat[3] * y + mat[0]
    yc = mat[4] * x + (mat[5] - (1 << 16)) * y + mat[1]
    shift = 13 if allow_hp else 14
    scale = 1 if allow_hp else 2

    def rpot_s(v, n):
        m = (abs(v) + (1 << (n - 1))) >> n
        return -m if v < 0 else m

    return (rpot_s(yc, shift) * scale, rpot_s(xc, shift) * scale)


@dataclasses.dataclass
class MvStackComp:
    """Compound reference-MV stack: entries are MV pairs."""
    pairs: List[Tuple[Tuple[int, int], Tuple[int, int]]]
    weights: List[int]
    count: int
    mode_context: int

    def drl_ctx(self, idx: int) -> int:
        w0 = self.weights[idx]
        w1 = self.weights[idx + 1]
        if w0 >= REF_CAT_LEVEL:
            return 0 if w1 >= REF_CAT_LEVEL else 1
        return 2 if w1 < REF_CAT_LEVEL else 0


def find_mv_stack_comp(grid: MiGrid, mi_row: int, mi_col: int, bw4: int,
                       bh4: int, ref_pair, sb_mi: int = 16,
                       gm_mvs=((0, 0), (0, 0)), tmvp=None,
                       cur_offs=(0, 0)) -> MvStackComp:
    """Compound-pair MV stack (spec 7.10.2 with rf[1] > NONE): the same
    neighbor traversal as the single-ref stack, matching blocks whose
    (ref, ref2) equals the pair; underfull stacks pad with the global
    pair then zeros."""
    ref0, ref1 = ref_pair
    st_pairs: List[Tuple] = []
    st_w: List[int] = []

    def stack_add(pair, len_, weight):
        for i, p in enumerate(st_pairs):
            if p == pair:
                st_w[i] += weight * len_
                return
        if len(st_pairs) < MAX_REF_MV_STACK_SIZE:
            st_pairs.append(pair)
            st_w.append(weight * len_)

    mi_rows, mi_cols = grid.mi_rows, grid.mi_cols
    up = mi_row > 0
    left = mi_col > 0
    max_row_offset = max(-(MVREF_ROWS << 1), -mi_row) if up else 0
    max_col_offset = max(-(MVREF_ROWS << 1), -mi_col) if left else 0
    counts = dict(row_match=0, col_match=0, newmv=0)

    def add_candidate(r, c, len_, weight, which):
        if (int(grid.ref_frame[r, c]) != ref0
                or int(grid.ref2[r, c]) != ref1):
            return
        p0 = (int(grid.mv[r, c, 0]), int(grid.mv[r, c, 1]))
        p1 = (int(grid.mv2[r, c, 0]), int(grid.mv2[r, c, 1]))
        if grid.mode[r, c] == GLOBALMV:
            p0, p1 = tuple(gm_mvs[0]), tuple(gm_mvs[1])
        stack_add((p0, p1), len_, weight)
        if have_newmv(int(grid.mode[r, c])):
            counts["newmv"] += 1
        counts[which] += 1

    def scan_row(row_offset):
        end_mi = min(bw4, mi_cols - mi_col, 16)
        col_off = 1 if abs(row_offset) > 1 else 0
        i = 0
        while i < end_mi:
            r = mi_row + row_offset
            c = mi_col + col_off + i
            cw4 = int(grid.w4[r, c])
            len_ = min(bw4, cw4)
            if abs(row_offset) > 1:
                len_ = max(len_, 2)
            add_candidate(r, c, len_, 2, "row_match")
            i += len_

    def scan_col(col_offset):
        end_mi = min(bh4, mi_rows - mi_row, 16)
        row_off = 1 if abs(col_offset) > 1 else 0
        i = 0
        while i < end_mi:
            r = mi_row + row_off + i
            c = mi_col + col_offset
            ch4 = int(grid.h4[r, c])
            len_ = min(bh4, ch4)
            if abs(col_offset) > 1:
                len_ = max(len_, 2)
            add_candidate(r, c, len_, 2, "col_match")
            i += len_

    if abs(max_row_offset) >= 1:
        scan_row(-1)
    if abs(max_col_offset) >= 1:
        scan_col(-1)
    if _has_top_right(mi_row, mi_col, bw4, bh4, sb_mi, mi_cols):
        r, c = mi_row - 1, mi_col + bw4
        if 0 <= c < mi_cols:
            add_candidate(r, c, 2, 2, "row_match")

    nearest_match = (counts["row_match"] > 0) + (counts["col_match"] > 0)
    newmv_count = counts["newmv"]
    st_w[:] = [w + REF_CAT_LEVEL for w in st_w]

    mode_flags = [0]
    if tmvp is not None:
        import types
        _temporal_scan(tmvp, mi_row, mi_col, bw4, bh4, gm_mvs,
                       cur_offs, types.SimpleNamespace(
                           add=lambda pair, len_, weight:
                               stack_add(pair, len_, weight)),
                       mode_flags, comp=True)

    if mi_row > 0 and mi_col > 0:
        add_candidate(mi_row - 1, mi_col - 1, 2, 2, "row_match")
    for idx in range(2, MVREF_ROWS + 1):
        off = -(idx << 1) + 1
        if abs(off) <= abs(max_row_offset):
            scan_row(off)
        if abs(off) <= abs(max_col_offset):
            scan_col(off)

    ref_match_count = (counts["row_match"] > 0) + (counts["col_match"] > 0)
    mode_context = 0
    if nearest_match == 0:
        if ref_match_count >= 1:
            mode_context |= 1
        if ref_match_count == 1:
            mode_context |= (1 << REFMV_OFFSET)
        elif ref_match_count >= 2:
            mode_context |= (2 << REFMV_OFFSET)
    elif nearest_match == 1:
        mode_context |= 2 if newmv_count > 0 else 3
        if ref_match_count == 1:
            mode_context |= (3 << REFMV_OFFSET)
        elif ref_match_count >= 2:
            mode_context |= (4 << REFMV_OFFSET)
    else:
        mode_context |= 4 if newmv_count >= 1 else 5
        mode_context |= (5 << REFMV_OFFSET)
    mode_context |= mode_flags[0]

    # weight sort (stable bubble, as single-ref)
    n = len(st_pairs)
    ln = n
    while ln > 0:
        nr = 0
        for i in range(1, ln):
            if st_w[i - 1] < st_w[i]:
                st_pairs[i - 1], st_pairs[i] = st_pairs[i], st_pairs[i - 1]
                st_w[i - 1], st_w[i] = st_w[i], st_w[i - 1]
                nr = i
        ln = nr

    while len(st_pairs) < MAX_MV_REF_CANDIDATES:
        pad = (tuple(gm_mvs[0]), tuple(gm_mvs[1]))
        if pad in st_pairs:
            pad = ((0, 0), (0, 0))
        if pad in st_pairs:
            pad = ((0, 0), (0, 2 * (len(st_pairs) + 1)))
        st_pairs.append(pad)
        st_w.append(2)

    # clamp both MVs of every pair (same rule as the single-ref stack)
    bw_px, bh_px = bw4 * 4, bh4 * 4
    to_left = -(mi_col * 4 * 8)
    to_right = (mi_cols - bw4 - mi_col) * 4 * 8
    to_top = -(mi_row * 4 * 8)
    to_bottom = (mi_rows - bh4 - mi_row) * 4 * 8

    def cl(mv):
        r = _clamp(mv[0], to_top - bh_px * 8 - MV_BORDER,
                   to_bottom + bh_px * 8 + MV_BORDER)
        c = _clamp(mv[1], to_left - bw_px * 8 - MV_BORDER,
                   to_right + bw_px * 8 + MV_BORDER)
        return (r, c)

    st_pairs = [(cl(p0), cl(p1)) for (p0, p1) in st_pairs]
    return MvStackComp(pairs=st_pairs, weights=st_w,
                       count=max(len(st_pairs), 2),
                       mode_context=mode_context)


# --------------------------------------------------------------------------
# Temporal MV prediction (spec 7.9 motion field estimation + the 7.10.2
# temporal scan).  Behavioral reference: md_config_process.c
# av1_setup_motion_field/motion_field_projection (:390-530),
# adaptive_mv_pred.c add_tpl_ref_mv (:340-436) and the temporal loop
# (:736-840), coding_loop.c av1_copy_frame_mvs (:1208-1239).
# --------------------------------------------------------------------------

REFMVS_LIMIT = (1 << 12) - 1
MAX_FRAME_DISTANCE = 31           # (1 << FRAME_OFFSET_BITS) - 1
MAX_OFFSET_WIDTH = 64
MAX_OFFSET_HEIGHT = 0
_MV_CLAMP = (1 << 14) - 1         # MV_UPP - 1
_DIV_MULT = [0] + [16384 // d for d in range(1, 32)]


def get_relative_dist(order_hint_bits: int, a: int, b: int) -> int:
    """Signed wrap-around order-hint distance (spec get_relative_dist)."""
    if order_hint_bits <= 0:
        return 0
    diff = a - b
    m = 1 << (order_hint_bits - 1)
    return (diff & (m - 1)) - (diff & m)


def _round_p2_signed(x: int, n: int) -> int:
    add = 1 << (n - 1)
    return (x + add) >> n if x >= 0 else -((-x + add) >> n)


def get_mv_projection(mv, num: int, den: int):
    den = min(den, MAX_FRAME_DISTANCE)
    num = min(num, MAX_FRAME_DISTANCE) if num > 0 \
        else max(num, -MAX_FRAME_DISTANCE)
    r = _clamp(_round_p2_signed(int(mv[0]) * num * _DIV_MULT[den], 14),
               -_MV_CLAMP, _MV_CLAMP)
    c = _clamp(_round_p2_signed(int(mv[1]) * num * _DIV_MULT[den], 14),
               -_MV_CLAMP, _MV_CLAMP)
    return (r, c)


def lower_mv_precision(mv, allow_hp: bool):
    r, c = int(mv[0]), int(mv[1])
    if not allow_hp:
        if r & 1:
            r += -1 if r > 0 else 1
        if c & 1:
            c += -1 if c > 0 else 1
    return (r, c)


@dataclasses.dataclass
class FrameMotionField:
    """Per-8x8 saved MVs of ONE coded frame (DPB side-band state)."""
    mvs: np.ndarray            # (rows8, cols8, 2) int16
    refs: np.ndarray           # (rows8, cols8) int8, 0 = NONE
    ref_order_hints: tuple     # the 7 ref hints THIS frame saw
    order_hint: int
    is_intra: bool


def ref_frame_side(ref_hints, cur_hint: int, order_hint_bits: int):
    """side[ref] per av1_setup_motion_field: 1 = future, -1 = same
    hint, 0 = past.  ref_hints: {enum: hint} or 7-seq (LAST..ALTREF)."""
    side = [0] * 8
    for ref in range(LAST_FRAME, ALTREF_FRAME + 1):
        h = (ref_hints.get(ref, 0) if isinstance(ref_hints, dict)
             else ref_hints[ref - 1])
        if get_relative_dist(order_hint_bits, h, cur_hint) > 0:
            side[ref] = 1
        elif h == cur_hint:
            side[ref] = -1
    return side


def save_motion_field(decisions, mi_rows: int, mi_cols: int,
                      side, ref_hints, order_hint: int,
                      is_intra: bool) -> FrameMotionField:
    """av1_copy_frame_mvs over a frame's leaf decisions: each 8x8 cell
    stores the block's LAST listed reference whose frame is strictly in
    the past (side == 0) with |mv| <= REFMVS_LIMIT."""
    r8 = (mi_rows + 1) >> 1
    c8 = (mi_cols + 1) >> 1
    mvs = np.zeros((r8, c8, 2), np.int16)
    refs = np.zeros((r8, c8), np.int8)
    if not is_intra:
        from svt_av1_tpu_torch.codec import constants as cc
        for d in decisions.values():
            if not d.is_inter:
                continue
            best = None
            for ref, mv in ((d.ref, d.mv), (d.ref2, d.mv2)):
                if ref <= INTRA_FRAME:
                    continue
                if side[ref]:
                    continue
                if abs(mv[0]) > REFMVS_LIMIT or abs(mv[1]) > REFMVS_LIMIT:
                    continue
                best = (ref, mv)
            if best is None:
                continue
            n4 = int(cc.block_size_wide[d.bsize]) >> 2
            m4 = int(cc.block_size_high[d.bsize]) >> 2
            y0, x0 = d.r4 >> 1, d.c4 >> 1
            y1 = min(y0 + ((m4 + 1) >> 1), r8)
            x1 = min(x0 + ((n4 + 1) >> 1), c8)
            refs[y0:y1, x0:x1] = best[0]
            mvs[y0:y1, x0:x1, 0] = best[1][0]
            mvs[y0:y1, x0:x1, 1] = best[1][1]
    return FrameMotionField(mvs=mvs, refs=refs,
                            ref_order_hints=tuple(ref_hints),
                            order_hint=order_hint, is_intra=is_intra)


@dataclasses.dataclass
class Tmvp:
    """Current-frame projected motion field + per-stack-call offsets."""
    mfmv: np.ndarray           # (rows8, cols8, 2) int16 saved fwd MVs
    ref_offset: np.ndarray     # (rows8, cols8) int16, 0 = invalid
    mi_rows: int
    mi_cols: int
    allow_hp: bool
    cur_offsets: dict          # {ref_enum: get_relative_dist(cur, ref)}


def _project_one(mfmv, ref_off, field: FrameMotionField, start_hint,
                 cur_hint, ohb, mi_rows, mi_cols, dir_):
    """motion_field_projection for one start frame; returns 1 if run."""
    if field is None or field.is_intra:
        return 0
    r8 = (mi_rows + 1) >> 1
    c8 = (mi_cols + 1) >> 1
    if field.mvs.shape[0] != r8 or field.mvs.shape[1] != c8:
        return 0
    start_to_cur = get_relative_dist(ohb, field.order_hint, cur_hint)
    ref_offset = [0] * 8
    for i in range(LAST_FRAME, ALTREF_FRAME + 1):
        ref_offset[i] = get_relative_dist(
            ohb, field.order_hint, field.ref_order_hints[i - 1])
    if dir_ == 2:
        start_to_cur = -start_to_cur
    if abs(start_to_cur) > MAX_FRAME_DISTANCE:
        return 1
    sign_bias = dir_ >> 1
    for br in range(r8):
        for bc in range(c8):
            rf = int(field.refs[br, bc])
            if rf <= INTRA_FRAME:
                continue
            rfo = ref_offset[rf]
            if not (0 < rfo <= MAX_FRAME_DISTANCE):
                continue
            fwd = (int(field.mvs[br, bc, 0]), int(field.mvs[br, bc, 1]))
            pr, pc = get_mv_projection(fwd, start_to_cur, rfo)
            # 1/8-pel -> 8x8-block units: >> (4 + MI_SIZE_LOG2) == 6
            # (md_config_process.c:361 get_block_position)
            ro = (pr >> 6) if pr >= 0 else -((-pr) >> 6)
            co = (pc >> 6) if pc >= 0 else -((-pc) >> 6)
            row = br - ro if sign_bias == 1 else br + ro
            col = bc - co if sign_bias == 1 else bc + co
            if row < 0 or row >= r8 or col < 0 or col >= c8:
                continue
            base_r = (br >> 3) << 3
            base_c = (bc >> 3) << 3
            if row < base_r - (MAX_OFFSET_HEIGHT >> 3) \
                    or row >= base_r + 8 + (MAX_OFFSET_HEIGHT >> 3) \
                    or col < base_c - (MAX_OFFSET_WIDTH >> 3) \
                    or col >= base_c + 8 + (MAX_OFFSET_WIDTH >> 3):
                continue
            mfmv[row, col, 0] = fwd[0]
            mfmv[row, col, 1] = fwd[1]
            ref_off[row, col] = rfo
    return 1


def setup_motion_field(slot_fields: dict, ref_hints: dict,
                       cur_hint: int, order_hint_bits: int,
                       mi_rows: int, mi_cols: int,
                       allow_hp: bool) -> Tmvp:
    """av1_setup_motion_field: project saved fields of (LAST back, BWD
    fwd, ALTREF2 fwd, ALTREF fwd, LAST2 back) with a 3-projection
    budget.  slot_fields: {ref_enum: FrameMotionField or None};
    ref_hints: {ref_enum: order hint}."""
    r8 = (mi_rows + 1) >> 1
    c8 = (mi_cols + 1) >> 1
    mfmv = np.zeros((r8, c8, 2), np.int16)
    ref_off = np.zeros((r8, c8), np.int16)
    ohb = order_hint_bits
    stamp = 2                      # MFMV_STACK_SIZE - 1
    lf = slot_fields.get(LAST_FRAME)
    if lf is not None:
        alt_of_lst = lf.ref_order_hints[ALTREF_FRAME - 1]
        is_lst_overlay = (alt_of_lst == ref_hints.get(GOLDEN_FRAME, 0))
        if not is_lst_overlay:
            _project_one(mfmv, ref_off, lf, ref_hints.get(LAST_FRAME),
                         cur_hint, ohb, mi_rows, mi_cols, 2)
        stamp -= 1
    for ref, dir_ in ((BWDREF_FRAME, 0), (ALTREF2_FRAME, 0)):
        if get_relative_dist(ohb, ref_hints.get(ref, 0), cur_hint) > 0:
            if _project_one(mfmv, ref_off, slot_fields.get(ref),
                            ref_hints.get(ref), cur_hint, ohb,
                            mi_rows, mi_cols, dir_):
                stamp -= 1
    if get_relative_dist(ohb, ref_hints.get(ALTREF_FRAME, 0),
                         cur_hint) > 0 and stamp >= 0:
        if _project_one(mfmv, ref_off, slot_fields.get(ALTREF_FRAME),
                        ref_hints.get(ALTREF_FRAME), cur_hint, ohb,
                        mi_rows, mi_cols, 0):
            stamp -= 1
    if stamp >= 0:
        _project_one(mfmv, ref_off, slot_fields.get(LAST2_FRAME),
                     ref_hints.get(LAST2_FRAME), cur_hint, ohb,
                     mi_rows, mi_cols, 2)
    return Tmvp(mfmv=mfmv, ref_offset=ref_off, mi_rows=mi_rows,
                mi_cols=mi_cols, allow_hp=allow_hp, cur_offsets={})


def _check_sb_border(mi_row, mi_col, row_offset, col_offset,
                     sb_mi=16) -> bool:
    row = mi_row & (sb_mi - 1)
    col = mi_col & (sb_mi - 1)
    return (0 <= row + row_offset < sb_mi
            and 0 <= col + col_offset < sb_mi)


def _temporal_scan(tmvp: Tmvp, mi_row, mi_col, bw4, bh4, gm_mvs,
                   cur_off, st: "_Stack", mode_flags, comp=False):
    """The use_ref_frame_mvs block of setup_ref_mv_list: sample the
    projected field over the block (+3 extension points), project each
    hit to the current offsets, dedupe into the stack with weight 2.
    mode_flags: 1-element list accumulating mode_context bits."""
    blk_row_end = min(bh4, 16)
    blk_col_end = min(bw4, 16)
    step_h = 4 if bh4 >= 16 else 2
    step_w = 4 if bw4 >= 16 else 2
    allow_ext = 2 <= bh4 < 16 and 2 <= bw4 < 16

    def add_tpl(blk_row, blk_col):
        pos_r = blk_row if (mi_row & 1) else blk_row + 1
        pos_c = blk_col if (mi_col & 1) else blk_col + 1
        r = mi_row + pos_r
        c = mi_col + pos_c
        if not (0 <= r < tmvp.mi_rows and 0 <= c < tmvp.mi_cols):
            return 0
        r8, c8 = r >> 1, c >> 1
        rfo = int(tmvp.ref_offset[r8, c8])
        if rfo == 0:
            return 0
        fwd = (int(tmvp.mfmv[r8, c8, 0]), int(tmvp.mfmv[r8, c8, 1]))
        this = lower_mv_precision(
            get_mv_projection(fwd, cur_off[0], rfo), tmvp.allow_hp)
        if not comp:
            if blk_row == 0 and blk_col == 0:
                if abs(this[0] - gm_mvs[0][0]) >= 16 \
                        or abs(this[1] - gm_mvs[0][1]) >= 16:
                    mode_flags[0] |= (1 << GLOBALMV_OFFSET)
            st.add(this, 1, 2)
        else:
            cmv = lower_mv_precision(
                get_mv_projection(fwd, cur_off[1], rfo), tmvp.allow_hp)
            if blk_row == 0 and blk_col == 0:
                if abs(this[0] - gm_mvs[0][0]) >= 16 \
                        or abs(this[1] - gm_mvs[0][1]) >= 16 \
                        or abs(cmv[0] - gm_mvs[1][0]) >= 16 \
                        or abs(cmv[1] - gm_mvs[1][1]) >= 16:
                    mode_flags[0] |= (1 << GLOBALMV_OFFSET)
            st.add((this, cmv), 1, 2)
        return 1

    is_available = 0
    for blk_row in range(0, blk_row_end, step_h):
        for blk_col in range(0, blk_col_end, step_w):
            ret = add_tpl(blk_row, blk_col)
            if blk_row == 0 and blk_col == 0:
                is_available = ret
    if not is_available:
        mode_flags[0] |= (1 << GLOBALMV_OFFSET)
    if allow_ext:
        voffset = max(2, bh4)
        hoffset = max(2, bw4)
        for br, bc in ((voffset, -2), (voffset, hoffset),
                       (voffset - 2, hoffset)):
            if _check_sb_border(mi_row, mi_col, br, bc):
                add_tpl(br, bc)
