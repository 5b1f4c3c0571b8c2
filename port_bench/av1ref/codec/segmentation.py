"""AV1 segmentation (spec 5.9.14 segmentation_params, 5.11.14
read_segment_id; behavioral reference: segmentation.c /
segmentation_params.c).

Scope: SEG_LVL_ALT_Q on intra frames — the segment map carries per-SB
quantizer offsets (segment-based AQ), coded spatially with the
spatial_pred_seg_tree CDFs.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

MAX_SEGMENTS = 8
SEG_LVL_ALT_Q = 0
SEG_LVL_MAX = 8
# feature (bits, signed) per SEG_LVL_* (spec Segmentation_Feature_Bits)
FEATURE_BITS = (8, 6, 6, 6, 6, 3, 0, 0)
FEATURE_SIGNED = (1, 1, 1, 1, 1, 0, 0, 0)


@dataclasses.dataclass
class SegmentationParams:
    enabled: bool = False
    update_map: bool = True
    temporal_update: bool = False
    update_data: bool = True
    # feature_enabled[seg][lvl], feature_data[seg][lvl]
    feature_enabled: List[List[bool]] = dataclasses.field(
        default_factory=lambda: [[False] * SEG_LVL_MAX
                                 for _ in range(MAX_SEGMENTS)])
    feature_data: List[List[int]] = dataclasses.field(
        default_factory=lambda: [[0] * SEG_LVL_MAX
                                 for _ in range(MAX_SEGMENTS)])

    @property
    def last_active_seg_id(self) -> int:
        last = 0
        for s in range(MAX_SEGMENTS):
            if any(self.feature_enabled[s]):
                last = s
        return last

    @property
    def seg_id_pre_skip(self) -> bool:
        # true when a skip-dependent feature is active (SEG_LVL_SKIP=6)
        return any(self.feature_enabled[s][6] for s in range(MAX_SEGMENTS))

    def qindex_for(self, seg_id: int, base_q: int) -> int:
        if self.enabled and self.feature_enabled[seg_id][SEG_LVL_ALT_Q]:
            return int(np.clip(
                base_q + self.feature_data[seg_id][SEG_LVL_ALT_Q],
                1, 255))
        return base_q


def read_params(r, primary_ref_none: bool = True
                ) -> Optional[SegmentationParams]:
    if not r.f(1):
        return None
    assert primary_ref_none, "segmentation with a primary ref"
    seg = SegmentationParams(enabled=True)
    for s in range(MAX_SEGMENTS):
        for lvl in range(SEG_LVL_MAX):
            if r.f(1):
                seg.feature_enabled[s][lvl] = True
                bits = FEATURE_BITS[lvl]
                if FEATURE_SIGNED[lvl]:
                    n = 1 + bits
                    v = r.f(n)
                    if v & (1 << (n - 1)):
                        v -= 1 << n
                else:
                    v = r.f(bits)
                seg.feature_data[s][lvl] = v
    return seg


# ---------------------------------------------------------------------------
# spatial segment-id coding helpers (spec 5.11.14)
# ---------------------------------------------------------------------------

def seg_pred_and_ctx(seg_ids: np.ndarray, r4: int, c4: int):
    """(predicted seg id, cdf context) from up/left/up-left neighbors."""
    prev_u = int(seg_ids[r4 - 1, c4]) if r4 > 0 else -1
    prev_l = int(seg_ids[r4, c4 - 1]) if c4 > 0 else -1
    prev_ul = int(seg_ids[r4 - 1, c4 - 1]) if (r4 > 0 and c4 > 0) else -1
    if prev_u == -1:
        pred = 0 if prev_l == -1 else prev_l
    elif prev_l == -1:
        pred = prev_u
    else:
        pred = prev_u if prev_ul == prev_u else prev_l
    if prev_ul < 0:
        ctx = 0
    elif prev_ul == prev_u and prev_ul == prev_l:
        ctx = 2
    elif prev_ul == prev_u or prev_ul == prev_l or prev_u == prev_l:
        ctx = 1
    else:
        ctx = 0
    return pred, ctx


def neg_deinterleave(diff: int, ref: int, mx: int) -> int:
    if not ref:
        return diff
    if ref >= mx - 1:
        return mx - diff - 1
    if 2 * ref < mx:
        if diff <= 2 * ref:
            if diff & 1:
                return ref + ((diff + 1) >> 1)
            return ref - (diff >> 1)
        return diff
    if diff <= 2 * (mx - ref - 1):
        if diff & 1:
            return ref + ((diff + 1) >> 1)
        return ref - (diff >> 1)
    return mx - (diff + 1)


def neg_interleave(x: int, ref: int, mx: int) -> int:
    """Inverse of neg_deinterleave (aom av1_neg_interleave)."""
    diff = x - ref
    if not ref:
        return x
    if ref >= mx - 1:
        return -x + mx - 1
    if 2 * ref < mx:
        if abs(diff) <= ref:
            if diff > 0:
                return (diff << 1) - 1
            return (-diff) << 1
        return x
    if abs(diff) <= mx - ref - 1:
        if diff > 0:
            return (diff << 1) - 1
        return (-diff) << 1
    return (mx - x) - 1
