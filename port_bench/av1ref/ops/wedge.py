"""Wedge compound masks (normative) + blend.

Behavioral reference: inter_prediction.c:1436-1520 (spec master mask
tables Wedge_Master_Oblique_Odd/Even/Vertical), :1982-2035
init_wedge_primary_masks (shift_copy construction + direction
reflections), :2078-2092 get_wedge_mask_inplace (codebook offsets),
:2046-2070 init_wedge_signs (average-threshold default sign).  The
tables and the construction are AV1-spec-normative (spec 7.11.3.11
wedge mask process); any conformant codec reproduces them bit-exactly.

Masks are built once at import for the block sizes our MD uses and
exposed as dense arrays ready for vectorized blending on device:

    masks_16    (2, 16, 16, 16) uint8 — [sign][wedge_idx] luma 16x16
    masks_16_uv (2, 16, 8, 8)   uint8 — 2x2-subsampled chroma (4:2:0,
                blend_a64_mask subw=subh=1 rounding)

Blend (normative, WEDGE_WEIGHT_BITS=6):
    pred = (m * p0 + (64 - m) * p1 + 32) >> 6
"""
from __future__ import annotations

import numpy as np

WEDGE_WEIGHT_BITS = 6
MASK_PRIMARY_SIZE = 64

# wedge directions
OBLIQUE27, OBLIQUE63, OBLIQUE117, OBLIQUE153, HORIZONTAL, VERTICAL = \
    range(6)

# spec master ramps (Wedge_Master_Oblique_Odd/Even, Wedge_Master_Vertical)
_OBL_ODD = np.array(
    [0] * 28 + [1, 2, 6, 18, 37, 53, 60, 63] + [64] * 28, np.int32)
_OBL_EVEN = np.array(
    [0] * 28 + [1, 4, 11, 27, 46, 58, 62, 63] + [64] * 28, np.int32)
_VERT = np.array(
    [0] * 29 + [2, 7, 21, 43, 57, 62] + [64] * 29, np.int32)

# wedge_codebook_16_heqw (square blocks): (direction, x_offset, y_offset)
_CODEBOOK_HEQW = (
    (OBLIQUE27, 4, 4), (OBLIQUE63, 4, 4), (OBLIQUE117, 4, 4),
    (OBLIQUE153, 4, 4), (HORIZONTAL, 4, 2), (HORIZONTAL, 4, 6),
    (VERTICAL, 2, 4), (VERTICAL, 6, 4), (OBLIQUE27, 4, 2),
    (OBLIQUE27, 4, 6), (OBLIQUE153, 4, 2), (OBLIQUE153, 4, 6),
    (OBLIQUE63, 2, 4), (OBLIQUE63, 6, 4), (OBLIQUE117, 2, 4),
    (OBLIQUE117, 6, 4),
)


def _shift_copy(src: np.ndarray, shift: int) -> np.ndarray:
    out = np.empty_like(src)
    if shift >= 0:
        out[shift:] = src[:len(src) - shift]
        out[:shift] = src[0]
    else:
        shift = -shift
        out[:len(src) - shift] = src[shift:]
        out[len(src) - shift:] = src[-1]
    return out


def _master_masks() -> np.ndarray:
    """(2, 6, 64, 64) int32: [neg][direction] primary masks."""
    s = MASK_PRIMARY_SIZE
    m = np.zeros((2, 6, s, s), np.int32)
    shift = s // 4
    for i in range(0, s, 2):
        m[0, OBLIQUE63, i] = _shift_copy(_OBL_EVEN, shift)
        shift -= 1
        m[0, OBLIQUE63, i + 1] = _shift_copy(_OBL_ODD, shift)
        m[0, VERTICAL, i] = _VERT
        m[0, VERTICAL, i + 1] = _VERT
    top = 1 << WEDGE_WEIGHT_BITS
    ob63 = m[0, OBLIQUE63]
    m[0, OBLIQUE27] = ob63.T
    m[0, OBLIQUE117] = top - ob63[:, ::-1]
    m[0, OBLIQUE153] = (top - ob63[:, ::-1]).T
    m[1, OBLIQUE63] = top - ob63
    m[1, OBLIQUE27] = (top - ob63).T
    m[1, OBLIQUE117] = ob63[:, ::-1]
    m[1, OBLIQUE153] = ob63[:, ::-1].T
    vert = m[0, VERTICAL]
    m[0, HORIZONTAL] = vert.T
    m[1, VERTICAL] = top - vert
    m[1, HORIZONTAL] = (top - vert).T
    return m


def _build_masks(bw: int, bh: int, codebook) -> np.ndarray:
    """(2, 16, bh, bw) uint8 per get_wedge_mask_inplace + signflip."""
    master = _master_masks()
    half = MASK_PRIMARY_SIZE // 2
    out = np.zeros((2, len(codebook), bh, bw), np.uint8)
    for w, (direction, xo, yo) in enumerate(codebook):
        woff = (xo * bw) >> 3
        hoff = (yo * bh) >> 3
        r0, c0 = half - hoff, half - woff
        primary = master[0, direction, r0:r0 + bh, c0:c0 + bw]
        # default sign from the primary's first row + first column avg
        avg = int(primary[0, :].sum() + primary[1:, 0].sum())
        avg = (avg + (bw + bh - 1) // 2) // (bw + bh - 1)
        signflip = int(avg < 32)
        for neg in (0, 1):
            sel = master[neg ^ signflip, direction,
                         r0:r0 + bh, c0:c0 + bw]
            out[neg, w] = sel.astype(np.uint8)
    return out


masks_16 = _build_masks(16, 16, _CODEBOOK_HEQW)


def _subsample_420(m: np.ndarray) -> np.ndarray:
    """blend_a64_mask subw=subh=1 rounding: (4 taps + 2) >> 2."""
    m = m.astype(np.int32)
    s = (m[..., ::2, ::2] + m[..., 1::2, ::2] + m[..., ::2, 1::2]
         + m[..., 1::2, 1::2] + 2) >> 2
    return s.astype(np.uint8)


masks_16_uv = _subsample_420(masks_16)


