"""Motion compensation: batched block prediction from a padded reference,
the PyTorch port of svt_av1_tpu/ops/mc.py.

Built on the bit-exact subpel convolve (ops/convolve.py).  Reference
planes are edge-replicated by ``pad`` pixels, which equals the spec's
per-sample coordinate clamping (spec 7.11.3.4) as long as every MV keeps
the filter window inside the padded plane; the clamps below enforce that
bound and match what the encoder signals.

MVs are (row, col) in 1/8 luma pel.  Luma phase = (mv & 7) * 2, chroma
(4:2:0) phase = mv & 15 at half-resolution coordinates.

A stream batch (parallel/multistream.py) passes (S, H, W) padded planes
and ``sid``, the stream of every block: a block reads its own stream's
plane, with the index rule of one plane.
"""
from __future__ import annotations

import torch

from av1ref.ops.convolve import (
    convolve_2d_compound_avg, convolve_2d_compound_diffwtd,
    convolve_2d_compound_masked, convolve_2d_sr)

PAD = 80  # reference padding in luma pixels


def pad_plane(plane: torch.Tensor, pad: int) -> torch.Tensor:
    """Edge-replicated padding of an (..., H, W) plane (== spec sample
    clamping), as int32: a gather at clamped coordinates."""
    h, w = plane.shape[-2:]
    dev = plane.device
    rows = torch.arange(-pad, h + pad, device=dev).clamp(0, h - 1)
    cols = torch.arange(-pad, w + pad, device=dev).clamp(0, w - 1)
    return plane.to(torch.int32)[..., rows[:, None], cols[None, :]]


def _index_like_jax(idx: torch.Tensor, n: int) -> torch.Tensor:
    """The reference's gather index rule: a negative index counts from
    the end, then the index is clamped into [0, n).  It matters for the
    chroma window of an MV at its lower clamp bound, whose first row or
    column lies one sample before the padded plane."""
    return torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)


def _windows(refp, ys, xs, mvs, blk, pad_p, subsampling, sid=None):
    """(B, blk+7, blk+7) source windows and the (x, y) q4 phases; with
    ``sid``, refp is (S, H, W) and block b reads plane sid[b]."""
    mvs = mvs.to(torch.int32)
    mvq_r = mvs[:, 0] * (2 >> subsampling)
    mvq_c = mvs[:, 1] * (2 >> subsampling)
    start_r = ys + (mvq_r >> 4) - 3 + pad_p
    start_c = xs + (mvq_c >> 4) - 3 + pad_p
    offs = torch.arange(blk + 7, device=refp.device)
    rows = start_r[:, None, None] + offs[None, :, None]
    cols = start_c[:, None, None] + offs[None, None, :]
    rows = _index_like_jax(rows.long(), refp.shape[-2])
    cols = _index_like_jax(cols.long(), refp.shape[-1])
    if sid is not None:
        return refp[sid[:, None, None], rows, cols], mvq_c & 15, mvq_r & 15
    return refp[rows, cols], mvq_c & 15, mvq_r & 15


def mc_blocks(ref_padded: torch.Tensor, ys, xs, mvs, blk: int, pad: int,
              subsampling: int = 0, bd: int = 8, kind=0,
              sid=None) -> torch.Tensor:
    """Batched single-reference MC: (B, blk, blk) int32 predictions.

    ref_padded: plane padded by pad >> subsampling ((S, ...) planes with
    ``sid``); ys/xs: (B,) block positions in plane pixels; mvs: (B, 2) in
    1/8 luma pel; kind: the filter kind, an int, a 0-d tensor or (B,)."""
    win, px, py = _windows(ref_padded, ys, xs, mvs, blk, pad >> subsampling,
                           subsampling, sid)
    return convolve_2d_sr(win, px, py, blk, blk, kind_x=kind, kind_y=kind,
                          bd=bd)


def mc_blocks_compound(refp0: torch.Tensor, refp1: torch.Tensor, ys, xs,
                       mvs0, mvs1, blk: int, pad: int, subsampling: int = 0,
                       bd: int = 8, kind=0, mask=None,
                       sid=None) -> torch.Tensor:
    """Batched compound MC: COMPOUND_AVERAGE, or the masked blend when
    ``mask`` ((B, blk, blk) 0..64 weights for ref0, plane-subsampled) is
    given."""
    pad_p = pad >> subsampling
    w0, px0, py0 = _windows(refp0, ys, xs, mvs0, blk, pad_p, subsampling,
                            sid)
    w1, px1, py1 = _windows(refp1, ys, xs, mvs1, blk, pad_p, subsampling,
                            sid)
    if mask is not None:
        return convolve_2d_compound_masked(w0, w1, px0, py0, px1, py1, blk,
                                           blk, mask, kind=kind, bd=bd)
    return convolve_2d_compound_avg(w0, w1, px0, py0, px1, py1, blk, blk,
                                    kind=kind, bd=bd)


def mc_blocks_compound_diffwtd(refp0, refp1, ys, xs, mvs0, mvs1, blk: int,
                               pad: int, inverse, bd: int = 8, kind=0,
                               sid=None):
    """COMPOUND_DIFFWTD luma MC: (pred, mask); the mask, 2x2-subsampled,
    is the chroma planes' ``mask`` for mc_blocks_compound."""
    w0, px0, py0 = _windows(refp0, ys, xs, mvs0, blk, pad, 0, sid)
    w1, px1, py1 = _windows(refp1, ys, xs, mvs1, blk, pad, 0, sid)
    return convolve_2d_compound_diffwtd(w0, w1, px0, py0, px1, py1, blk,
                                        blk, inverse, kind=kind, bd=bd)
