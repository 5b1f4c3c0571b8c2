"""Inter-intra compound prediction masks + blend.

Behavioral reference: inter_prediction.c:2110-2141 (normative
ii_weights1d spec table + ii_size_scales), :2144-2180
build_smooth_interintra_mask, :2183-2214 combine_interintra (pixel
domain AOM_BLEND_A64 — the mask weights the INTRA component).
"""
from __future__ import annotations

import numpy as np

# spec Ii_Weights_1d (MAX_SB_SIZE = 128 entries)
II_WEIGHTS_1D = np.array([
    60, 58, 56, 54, 52, 50, 48, 47, 45, 44, 42, 41, 39, 38, 37, 35,
    34, 33, 32, 31, 30, 29, 28, 27, 26, 25, 24, 23, 22, 22, 21, 20,
    19, 19, 18, 18, 17, 16, 16, 15, 15, 14, 14, 13, 13, 12, 12, 12,
    11, 11, 10, 10, 10, 9, 9, 9, 8, 8, 8, 8, 7, 7, 7, 7,
    6, 6, 6, 6, 6, 5, 5, 5, 5, 5, 4, 4, 4, 4, 4, 4,
    4, 4, 3, 3, 3, 3, 3, 3, 3, 3, 3, 2, 2, 2, 2, 2,
    2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1], np.int32)

II_DC, II_V, II_H, II_SMOOTH = range(4)


def smooth_mask(mode: int, n: int) -> np.ndarray:
    """(n, n) int32 mask for an n x n plane block
    (build_smooth_interintra_mask; scale = 128 / n per
    ii_size_scales)."""
    scale = 128 // n
    idx = np.arange(n) * scale
    wrow = II_WEIGHTS_1D[idx]
    if mode == II_V:
        return np.repeat(wrow[:, None], n, axis=1)
    if mode == II_H:
        return np.repeat(wrow[None, :], n, axis=0)
    if mode == II_SMOOTH:
        i = np.arange(n)
        m = np.minimum(i[:, None], i[None, :]) * scale
        return II_WEIGHTS_1D[m]
    return np.full((n, n), 32, np.int32)   # II_DC


# per-mode masks for the 16x16 luma / 8x8 chroma grid
MASKS_Y16 = np.stack([smooth_mask(m, 16) for m in range(4)])
MASKS_UV8 = np.stack([smooth_mask(m, 8) for m in range(4)])


def blend(intra_pred, inter_pred, mask):
    """comppred = (m*intra + (64-m)*inter + 32) >> 6 (AOM_BLEND_A64,
    pixel domain)."""
    return (mask * intra_pred + (64 - mask) * inter_pred + 32) >> 6
