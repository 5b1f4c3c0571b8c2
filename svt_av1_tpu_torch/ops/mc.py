"""Motion compensation: batched block prediction from a padded reference,
the PyTorch port of svt_av1_tpu/ops/mc.py.

Built on the bit-exact subpel convolve (ops/convolve.py).  Reference
planes are edge-replicated by ``pad`` pixels, which equals the spec's
per-sample coordinate clamping (spec 7.11.3.4) as long as every MV keeps
the filter window inside the padded plane; the clamps below enforce that
bound and match what the encoder signals.

MVs are (row, col) in 1/8 luma pel.  Luma phase = (mv & 7) * 2, chroma
(4:2:0) phase = mv & 15 at half-resolution coordinates.
"""
from __future__ import annotations

import numpy as np
import torch

from svt_av1_tpu_torch.ops.convolve import (
    convolve_2d_compound_avg, convolve_2d_compound_diffwtd,
    convolve_2d_compound_masked, convolve_2d_sr)

PAD = 80  # reference padding in luma pixels


def pad_plane(plane: torch.Tensor, pad: int) -> torch.Tensor:
    """Edge-replicated padding of an (H, W) plane (== spec sample
    clamping), as int32: a gather at clamped coordinates."""
    h, w = plane.shape
    dev = plane.device
    rows = torch.arange(-pad, h + pad, device=dev).clamp(0, h - 1)
    cols = torch.arange(-pad, w + pad, device=dev).clamp(0, w - 1)
    return plane.to(torch.int32)[rows[:, None], cols[None, :]]


def clamp_mv_for_pad(mv, y: int, x: int, blk: int, h: int, w: int,
                     pad: int = PAD):
    """Clamp one MV so that the 8-tap window of a block at (y, x) stays
    inside a pad-extended plane; 1/8 pel, low bit cleared."""
    lo_r = (-(y + pad - 4)) * 8
    hi_r = (h + pad - 4 - (y + blk)) * 8
    lo_c = (-(x + pad - 4)) * 8
    hi_c = (w + pad - 4 - (x + blk)) * 8
    r = max(lo_r, min(hi_r, int(mv[0])))
    c = max(lo_c, min(hi_c, int(mv[1])))
    return (r & ~1, c & ~1)


def clamp_mvs_for_pad(mvs: np.ndarray, ys: np.ndarray, xs: np.ndarray,
                      blk: int, h: int, w: int,
                      pad: int = PAD) -> np.ndarray:
    """Vectorized clamp of (..., 2) MVs against blocks at ys/xs, with the
    margin of 8 the chroma window needs."""
    mvs = np.asarray(mvs, np.int64)
    r = np.clip(mvs[..., 0], (-(ys + pad - 8)) * 8,
                (h + pad - 8 - (ys + blk)) * 8)
    c = np.clip(mvs[..., 1], (-(xs + pad - 8)) * 8,
                (w + pad - 8 - (xs + blk)) * 8)
    return np.stack([r & ~1, c & ~1], axis=-1).astype(np.int32)


def _index_like_jax(idx: torch.Tensor, n: int) -> torch.Tensor:
    """The reference's gather index rule: a negative index counts from
    the end, then the index is clamped into [0, n).  It matters for the
    chroma window of an MV at its lower clamp bound, whose first row or
    column lies one sample before the padded plane."""
    return torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)


def _windows(refp, ys, xs, mvs, blk, pad_p, subsampling):
    """(B, blk+7, blk+7) source windows and the (x, y) q4 phases."""
    mvs = mvs.to(torch.int32)
    mvq_r = mvs[:, 0] * (2 >> subsampling)
    mvq_c = mvs[:, 1] * (2 >> subsampling)
    start_r = ys + (mvq_r >> 4) - 3 + pad_p
    start_c = xs + (mvq_c >> 4) - 3 + pad_p
    offs = torch.arange(blk + 7, device=refp.device)
    rows = start_r[:, None, None] + offs[None, :, None]
    cols = start_c[:, None, None] + offs[None, None, :]
    rows = _index_like_jax(rows.long(), refp.shape[0])
    cols = _index_like_jax(cols.long(), refp.shape[1])
    return refp[rows, cols], mvq_c & 15, mvq_r & 15


def mc_blocks(ref_padded: torch.Tensor, ys, xs, mvs, blk: int, pad: int,
              subsampling: int = 0, bd: int = 8, kind=0) -> torch.Tensor:
    """Batched single-reference MC: (B, blk, blk) int32 predictions.

    ref_padded: plane padded by pad >> subsampling; ys/xs: (B,) block
    positions in plane pixels; mvs: (B, 2) in 1/8 luma pel."""
    win, px, py = _windows(ref_padded, ys, xs, mvs, blk, pad >> subsampling,
                           subsampling)
    return convolve_2d_sr(win, px, py, blk, blk, kind_x=kind, kind_y=kind,
                          bd=bd)


def mc_blocks_compound(refp0: torch.Tensor, refp1: torch.Tensor, ys, xs,
                       mvs0, mvs1, blk: int, pad: int, subsampling: int = 0,
                       bd: int = 8, kind=0, mask=None) -> torch.Tensor:
    """Batched compound MC: COMPOUND_AVERAGE, or the masked blend when
    ``mask`` ((B, blk, blk) 0..64 weights for ref0, plane-subsampled) is
    given."""
    pad_p = pad >> subsampling
    w0, px0, py0 = _windows(refp0, ys, xs, mvs0, blk, pad_p, subsampling)
    w1, px1, py1 = _windows(refp1, ys, xs, mvs1, blk, pad_p, subsampling)
    if mask is not None:
        return convolve_2d_compound_masked(w0, w1, px0, py0, px1, py1, blk,
                                           blk, mask, kind=kind, bd=bd)
    return convolve_2d_compound_avg(w0, w1, px0, py0, px1, py1, blk, blk,
                                    kind=kind, bd=bd)


def mc_blocks_compound_diffwtd(refp0, refp1, ys, xs, mvs0, mvs1, blk: int,
                               pad: int, inverse, bd: int = 8, kind=0):
    """COMPOUND_DIFFWTD luma MC: (pred, mask); the mask, 2x2-subsampled,
    is the chroma planes' ``mask`` for mc_blocks_compound."""
    w0, px0, py0 = _windows(refp0, ys, xs, mvs0, blk, pad, 0)
    w1, px1, py1 = _windows(refp1, ys, xs, mvs1, blk, pad, 0)
    return convolve_2d_compound_diffwtd(w0, w1, px0, py0, px1, py1, blk,
                                        blk, inverse, kind=kind, bd=bd)
