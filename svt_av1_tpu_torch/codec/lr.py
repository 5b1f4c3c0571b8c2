"""Loop-restoration parameter model + per-SB syntax.

AV1 spec §5.9.20 lr_params / §5.11.57 read_lr; behavioral reference:
entropy_coding.c encode_restoration_mode /
loop_restoration_write_sb_coeffs, restoration.h constants.

Round-1 scope: single tile, RESTORE_NONE / RESTORE_SWITCHABLE per plane
with per-RU {NONE, WIENER, SGRPROJ} decisions.
"""
from __future__ import annotations

import dataclasses
import functools
import os
from typing import List, Optional, Tuple

import numpy as np

from svt_av1_tpu_torch.codec import subexp
from svt_av1_tpu_torch.codec.entropy import update_cdf

RESTORE_NONE = 0
RESTORE_WIENER = 1
RESTORE_SGRPROJ = 2
RESTORE_SWITCHABLE = 3

# wiener tap ranges (restoration.h:131-153); taps stored relative to MIDV
WIENER_TAPS = (  # (minv, maxv, subexp_k, midv)
    (-5, 10, 1, 3),
    (-23, 8, 2, -7),
    (-17, 46, 3, 15),
)
SGRPROJ_PARAMS_BITS = 4
SGRPROJ_PRJ_MIN0, SGRPROJ_PRJ_MAX0 = -96, 31
SGRPROJ_PRJ_MIN1, SGRPROJ_PRJ_MAX1 = -32, 95
SGRPROJ_PRJ_SUBEXP_K = 4

MAX_UNIT_SIZE = 256
UNIT_OFFSET = 8  # RESTORATION_UNIT_OFFSET (luma rows)


@dataclasses.dataclass
class WienerInfo:
    # vertical/horizontal half-filters: taps [0..2] (tap 3 derived)
    vfilter: Tuple[int, int, int] = (3, -7, 15)
    hfilter: Tuple[int, int, int] = (3, -7, 15)

    def taps8(self, horiz: bool) -> np.ndarray:
        """Kernel-domain taps for the add-src convolve: the identity 128
        is added by the kernel itself, so center = -2 * sum(outer)."""
        t = self.hfilter if horiz else self.vfilter
        center = -2 * (t[0] + t[1] + t[2])
        return np.array([t[0], t[1], t[2], center, t[2], t[1], t[0], 0],
                        np.int32)


@dataclasses.dataclass
class SgrprojInfo:
    ep: int = 0
    xqd: Tuple[int, int] = (-32, 31)


@dataclasses.dataclass
class RestUnitInfo:
    rtype: int = RESTORE_NONE
    wiener: Optional[WienerInfo] = None
    sgrproj: Optional[SgrprojInfo] = None


class PlaneLrInfo:
    """Per-plane frame restoration info + RU grid."""

    def __init__(self, frame_type: int, unit_size: int, plane_w: int,
                 plane_h: int):
        self.frame_type = frame_type
        self.unit_size = unit_size
        self.cols = max((plane_w + (unit_size >> 1)) // unit_size, 1)
        self.rows = max((plane_h + (unit_size >> 1)) // unit_size, 1)
        self.units: List[List[RestUnitInfo]] = [
            [RestUnitInfo() for _ in range(self.cols)]
            for _ in range(self.rows)]


def make_lr_info(width: int, height: int,
                 luma_type: int = RESTORE_SWITCHABLE,
                 chroma_type: int = RESTORE_SWITCHABLE,
                 unit_size: int = MAX_UNIT_SIZE) -> List[PlaneLrInfo]:
    """3-plane LR info for a 4:2:0 frame (chroma units half-size)."""
    cw, ch = (width + 1) >> 1, (height + 1) >> 1
    return [
        PlaneLrInfo(luma_type, unit_size, width, height),
        PlaneLrInfo(chroma_type, unit_size >> 1, cw, ch),
        PlaneLrInfo(chroma_type, unit_size >> 1, cw, ch),
    ]


class _RefState:
    """Per-tile running references for filter coefficient coding."""

    def __init__(self):
        self.wiener = [WienerInfo() for _ in range(3)]
        self.sgrproj = [SgrprojInfo() for _ in range(3)]


def units_for_sb(info: PlaneLrInfo, mi_row: int, mi_col: int,
                 ss: int, mi_rows: int, mi_cols: int):
    """RU (row, col) list coded at this superblock (spec read_lr)."""
    if info.frame_type == RESTORE_NONE:
        return []
    size = info.unit_size
    h4 = min(16, mi_rows - mi_row)
    w4 = min(16, mi_cols - mi_col)
    def cnt(mi0, n4):
        start = (mi0 * (4 >> ss) + size - 1) // size
        end = ((mi0 + n4) * (4 >> ss) + size - 1) // size
        return start, end
    r0, r1 = cnt(mi_row, h4)
    c0, c1 = cnt(mi_col, w4)
    r1 = min(r1, info.rows)
    c1 = min(c1, info.cols)
    out = []
    for ur in range(r0, r1):
        for uc in range(c0, c1):
            out.append((ur, uc))
    return out


def _write_wiener(enc, plane: int, wi: WienerInfo, ref: _RefState,
                  update: bool) -> None:
    """Chroma uses the 5-tap window: tap 0 is 0 and not coded."""
    rw = ref.wiener[plane]
    t0 = 0 if plane else None
    for half, rhalf in ((wi.vfilter, rw.vfilter),
                        (wi.hfilter, rw.hfilter)):
        for t in range(3):
            if t == 0 and plane > 0:
                assert half[0] == 0, "chroma wiener tap0 must be 0"
                continue
            minv, maxv, k, _ = WIENER_TAPS[t]
            subexp.write_refsubexpfin(enc, maxv - minv + 1, k,
                                      rhalf[t] - minv, half[t] - minv)
    del t0
    ref.wiener[plane] = WienerInfo(tuple(wi.vfilter), tuple(wi.hfilter))


def _read_wiener(dec, plane: int, ref: _RefState) -> WienerInfo:
    rw = ref.wiener[plane]
    halves = []
    for rhalf in (rw.vfilter, rw.hfilter):
        taps = []
        for t in range(3):
            if t == 0 and plane > 0:
                taps.append(0)
                continue
            minv, maxv, k, _ = WIENER_TAPS[t]
            v = subexp.read_refsubexpfin(dec, maxv - minv + 1, k,
                                         rhalf[t] - minv) + minv
            taps.append(v)
        halves.append(tuple(taps))
    wi = WienerInfo(halves[0], halves[1])
    ref.wiener[plane] = wi
    return wi


@functools.lru_cache(maxsize=1)
def _sgr_params():
    path = os.path.join(os.path.dirname(__file__), "data",
                        "av1_sgr_tables.npz")
    tab = np.load(path)["sgr_params"]
    return [(int(r[0]), int(r[1])) for r in tab]


def _sgr_r(ep: int) -> Tuple[int, int]:
    return _sgr_params()[ep]


def _write_sgrproj(enc, plane: int, si: SgrprojInfo, ref: _RefState,
                   update: bool) -> None:
    rs = ref.sgrproj[plane]
    enc.encode_literal(si.ep, SGRPROJ_PARAMS_BITS)
    r0, r1 = _sgr_r(si.ep)
    if r0 == 0:
        subexp.write_refsubexpfin(
            enc, SGRPROJ_PRJ_MAX1 - SGRPROJ_PRJ_MIN1 + 1,
            SGRPROJ_PRJ_SUBEXP_K, rs.xqd[1] - SGRPROJ_PRJ_MIN1,
            si.xqd[1] - SGRPROJ_PRJ_MIN1)
    elif r1 == 0:
        subexp.write_refsubexpfin(
            enc, SGRPROJ_PRJ_MAX0 - SGRPROJ_PRJ_MIN0 + 1,
            SGRPROJ_PRJ_SUBEXP_K, rs.xqd[0] - SGRPROJ_PRJ_MIN0,
            si.xqd[0] - SGRPROJ_PRJ_MIN0)
    else:
        subexp.write_refsubexpfin(
            enc, SGRPROJ_PRJ_MAX0 - SGRPROJ_PRJ_MIN0 + 1,
            SGRPROJ_PRJ_SUBEXP_K, rs.xqd[0] - SGRPROJ_PRJ_MIN0,
            si.xqd[0] - SGRPROJ_PRJ_MIN0)
        subexp.write_refsubexpfin(
            enc, SGRPROJ_PRJ_MAX1 - SGRPROJ_PRJ_MIN1 + 1,
            SGRPROJ_PRJ_SUBEXP_K, rs.xqd[1] - SGRPROJ_PRJ_MIN1,
            si.xqd[1] - SGRPROJ_PRJ_MIN1)
    ref.sgrproj[plane] = SgrprojInfo(si.ep, tuple(si.xqd))


def _read_sgrproj(dec, plane: int, ref: _RefState) -> SgrprojInfo:
    """Spec 5.11.58: the running reference takes the DERIVED xqd values
    (xqd0 = 0 when r0 == 0; xqd1 = clip(128 - xqd0) when r1 == 0)."""
    rs = ref.sgrproj[plane]
    ep = dec.read_literal(SGRPROJ_PARAMS_BITS)
    r0, r1 = _sgr_r(ep)
    if r0 == 0:
        xqd0 = 0
        xqd1 = subexp.read_refsubexpfin(
            dec, SGRPROJ_PRJ_MAX1 - SGRPROJ_PRJ_MIN1 + 1,
            SGRPROJ_PRJ_SUBEXP_K,
            rs.xqd[1] - SGRPROJ_PRJ_MIN1) + SGRPROJ_PRJ_MIN1
    elif r1 == 0:
        xqd0 = subexp.read_refsubexpfin(
            dec, SGRPROJ_PRJ_MAX0 - SGRPROJ_PRJ_MIN0 + 1,
            SGRPROJ_PRJ_SUBEXP_K,
            rs.xqd[0] - SGRPROJ_PRJ_MIN0) + SGRPROJ_PRJ_MIN0
        xqd1 = int(np.clip((1 << 7) - xqd0, SGRPROJ_PRJ_MIN1,
                           SGRPROJ_PRJ_MAX1))
    else:
        xqd0 = subexp.read_refsubexpfin(
            dec, SGRPROJ_PRJ_MAX0 - SGRPROJ_PRJ_MIN0 + 1,
            SGRPROJ_PRJ_SUBEXP_K,
            rs.xqd[0] - SGRPROJ_PRJ_MIN0) + SGRPROJ_PRJ_MIN0
        xqd1 = subexp.read_refsubexpfin(
            dec, SGRPROJ_PRJ_MAX1 - SGRPROJ_PRJ_MIN1 + 1,
            SGRPROJ_PRJ_SUBEXP_K,
            rs.xqd[1] - SGRPROJ_PRJ_MIN1) + SGRPROJ_PRJ_MIN1
    si = SgrprojInfo(ep, (xqd0, xqd1))
    ref.sgrproj[plane] = si
    return si


def write_lr_for_sb(enc, cdfs, lr: List[PlaneLrInfo], ref: _RefState,
                    mi_row: int, mi_col: int, mi_rows: int, mi_cols: int,
                    update: bool) -> None:
    """Emit restoration unit syntax owned by this SB (spec read_lr)."""
    for plane, info in enumerate(lr):
        ss = 1 if plane else 0
        for (ur, uc) in units_for_sb(info, mi_row, mi_col, ss, mi_rows,
                                     mi_cols):
            u = info.units[ur][uc]
            if info.frame_type == RESTORE_SWITCHABLE:
                enc.encode_symbol(u.rtype, cdfs.switchable_restore, 3)
                if update:
                    update_cdf(cdfs.switchable_restore, u.rtype, 3)
                if u.rtype == RESTORE_WIENER:
                    _write_wiener(enc, plane, u.wiener, ref, update)
                elif u.rtype == RESTORE_SGRPROJ:
                    _write_sgrproj(enc, plane, u.sgrproj, ref, update)
            elif info.frame_type == RESTORE_WIENER:
                bit = int(u.rtype != RESTORE_NONE)
                enc.encode_symbol(bit, cdfs.wiener_restore, 2)
                if update:
                    update_cdf(cdfs.wiener_restore, bit, 2)
                if bit:
                    _write_wiener(enc, plane, u.wiener, ref, update)
            elif info.frame_type == RESTORE_SGRPROJ:
                bit = int(u.rtype != RESTORE_NONE)
                enc.encode_symbol(bit, cdfs.sgrproj_restore, 2)
                if update:
                    update_cdf(cdfs.sgrproj_restore, bit, 2)
                if bit:
                    _write_sgrproj(enc, plane, u.sgrproj, ref, update)


def read_lr_for_sb(dec, cdfs, lr: List[PlaneLrInfo], ref: _RefState,
                   mi_row: int, mi_col: int, mi_rows: int, mi_cols: int,
                   update: bool) -> None:
    for plane, info in enumerate(lr):
        ss = 1 if plane else 0
        for (ur, uc) in units_for_sb(info, mi_row, mi_col, ss, mi_rows,
                                     mi_cols):
            u = info.units[ur][uc]
            if info.frame_type == RESTORE_SWITCHABLE:
                u.rtype = dec.read_symbol(cdfs.switchable_restore, 3)
                if update:
                    update_cdf(cdfs.switchable_restore, u.rtype, 3)
                if u.rtype == RESTORE_WIENER:
                    u.wiener = _read_wiener(dec, plane, ref)
                elif u.rtype == RESTORE_SGRPROJ:
                    u.sgrproj = _read_sgrproj(dec, plane, ref)
            elif info.frame_type == RESTORE_WIENER:
                bit = dec.read_symbol(cdfs.wiener_restore, 2)
                if update:
                    update_cdf(cdfs.wiener_restore, bit, 2)
                if bit:
                    u.rtype = RESTORE_WIENER
                    u.wiener = _read_wiener(dec, plane, ref)
            elif info.frame_type == RESTORE_SGRPROJ:
                bit = dec.read_symbol(cdfs.sgrproj_restore, 2)
                if update:
                    update_cdf(cdfs.sgrproj_restore, bit, 2)
                if bit:
                    u.rtype = RESTORE_SGRPROJ
                    u.sgrproj = _read_sgrproj(dec, plane, ref)
