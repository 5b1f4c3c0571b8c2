"""Overlapped block motion compensation (OBMC_CAUSAL).

Behavioral reference: inter_prediction.c:2406-2430 (normative
obmc_mask_N tables), enc_inter_prediction.c:1428-1523
(build_obmc_inter_pred_above/left: the ABOVE neighbor's prediction is
blended over the top half first, then the LEFT neighbor's over the
left half, with svt_aom_blend_a64_vmask/hmask — the 1D mask weights
the CURRENT prediction, the complement the neighbor's), spec 7.11.3.9.

For the 16x16 grid the overlap is 8 luma / 4 chroma lines.  The masks
here are length-16/8 with the tail filled with 64 (pure current
prediction), so a whole-block blend equals the normative
overlap-region blend.
"""
from __future__ import annotations

import numpy as np

# normative obmc_mask_N (inter_prediction.c:2406)
MASK_2 = (45, 64)
MASK_4 = (39, 50, 59, 64)
MASK_8 = (36, 42, 48, 53, 57, 61, 64, 64)
MASK_16 = (34, 37, 40, 43, 46, 49, 52, 54, 56, 58, 60, 61, 64, 64,
           64, 64)

# length-16 luma / length-8 chroma vertical profiles for a 16x16 block
# (overlap 8 / 4, remainder weights 64 = unblended)
MASK_Y16 = np.array(MASK_8 + (64,) * 8, np.int32)
MASK_C8 = np.array(MASK_4 + (64,) * 4, np.int32)


def blend_above(cur, above, mask_1d):
    """dst[r, c] = (m[r]*cur + (64-m[r])*above + 32) >> 6
    (AOM_BLEND_A64 with a vertical mask; works on (..., h, w))."""
    m = mask_1d.reshape((1,) * (cur.ndim - 2) + (-1, 1))
    return (m * cur + (64 - m) * above + 32) >> 6


def blend_left(cur, left, mask_1d):
    """Horizontal-mask variant: m indexed by column."""
    m = mask_1d.reshape((1,) * (cur.ndim - 2) + (1, -1))
    return (m * cur + (64 - m) * left + 32) >> 6
