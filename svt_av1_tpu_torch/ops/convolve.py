"""AV1 sub-pixel convolution (inter motion compensation), the PyTorch
port of svt_av1_tpu/ops/convolve.py.

Normative prediction path (inter_prediction.c svt_av1_convolve_2d_sr and
the jnt/compound variants); the 8-tap kernels are data in
codec/data/av1_interp_filters.npz.  The separable filter runs as 8
shifted multiply-accumulates per axis over the whole block batch, in
int32 with the reference's rounding.

Layout: callers pass padded reference windows of shape (B, h + 7, w + 7)
whose (3, 3) offset is the integer-aligned position.  The filter kind is
a Python int or a 0-d integer tensor (the frame's interp pick stays on
the device).
"""
from __future__ import annotations

import functools
import os

import numpy as np
import torch

_DATA = os.path.join(os.path.dirname(__file__), "..", "codec", "data",
                     "av1_interp_filters.npz")

FILTER_BITS = 7
ROUND0 = 3       # conv_params->round_0 (8-bit single-ref)
ROUND1 = 11      # 2 * FILTER_BITS - ROUND0
ROUND1_COMP = 7   # COMPOUND_ROUND1_BITS
DIFF_FACTOR = 16

EIGHTTAP_REGULAR = 0
EIGHTTAP_SMOOTH = 1
MULTITAP_SHARP = 2
BILINEAR = 3


@functools.lru_cache(maxsize=1)
def _filters():
    return dict(np.load(_DATA))


@functools.lru_cache(maxsize=None)
def filter_table(kind: int, small: bool = False) -> np.ndarray:
    """(16, 8) int32 kernel table for a filter kind; ``small`` selects the
    4-tap variants of w/h <= 4 blocks."""
    d = _filters()
    name = {EIGHTTAP_REGULAR: "sub_pel_filters_4" if small
            else "sub_pel_filters_8",
            EIGHTTAP_SMOOTH: "sub_pel_filters_4smooth" if small
            else "sub_pel_filters_8smooth",
            MULTITAP_SHARP: "sub_pel_filters_8sharp",
            BILINEAR: "bilinear_filters"}[kind]
    return d[name].astype(np.int32)


@functools.lru_cache(maxsize=1)
def filter_table_all() -> np.ndarray:
    """(3, 16, 8) stacked REGULAR/SMOOTH/SHARP tables, indexed by a
    filter kind held in a tensor."""
    return np.stack([filter_table(k) for k in (EIGHTTAP_REGULAR,
                                               EIGHTTAP_SMOOTH,
                                               MULTITAP_SHARP)])


@functools.lru_cache(maxsize=None)
def _table_on(kind, device) -> torch.Tensor:
    a = filter_table_all() if kind is None else filter_table(kind)
    return torch.as_tensor(a, device=device)


def _tab_of(kind, device) -> torch.Tensor:
    """(16, 8) filter table for an int ``kind`` or a 0-d tensor."""
    if isinstance(kind, torch.Tensor):
        return _table_on(None, device)[kind.to(device).long()]
    return _table_on(int(kind), device)


def _round_pow2(x, n):
    return (x + (1 << (n - 1))) >> n if n > 0 else x


def _filter2d(windows, spx, spy, w, h, tab_x, tab_y, bd, round1):
    """The two separable 8-tap passes: horizontal rounded by ROUND0, then
    vertical rounded by ``round1`` (0: not rounded), offsets kept in."""
    fx = tab_x[spx.long()]
    fy = tab_y[spy.long()]
    x = windows.to(torch.int32)
    b = x.shape[0]
    acc = torch.full((b, h + 7, w), 1 << (bd + FILTER_BITS - 1),
                     dtype=torch.int32, device=x.device)
    for k in range(8):
        acc = acc + fx[:, k][:, None, None] * x[:, :, k:k + w]
    im = _round_pow2(acc, ROUND0)
    offset_bits = bd + 2 * FILTER_BITS - ROUND0
    acc2 = torch.full((b, h, w), 1 << offset_bits, dtype=torch.int32,
                      device=x.device)
    for k in range(8):
        acc2 = acc2 + fy[:, k][:, None, None] * im[:, k:k + h, :]
    return _round_pow2(acc2, round1)


def convolve_2d_sr(windows: torch.Tensor, subpel_x: torch.Tensor,
                   subpel_y: torch.Tensor, w: int, h: int,
                   kind_x=EIGHTTAP_REGULAR, kind_y=EIGHTTAP_REGULAR,
                   bd: int = 8) -> torch.Tensor:
    """Bit-exact svt_av1_convolve_2d_sr over a block batch.

    windows: (B, h+7, w+7) int32; subpel_x/subpel_y: (B,) q4 phases in
    [0, 16).  Returns (B, h, w) int32 samples in [0, 2^bd)."""
    dev = windows.device
    acc2 = _filter2d(windows, subpel_x, subpel_y, w, h, _tab_of(kind_x, dev),
                     _tab_of(kind_y, dev), bd, 0)
    offset_bits = bd + 2 * FILTER_BITS - ROUND0
    res = _round_pow2(acc2, ROUND1) - (
        (1 << (offset_bits - ROUND1)) + (1 << (offset_bits - ROUND1 - 1)))
    bits = 2 * FILTER_BITS - ROUND0 - ROUND1
    out = _round_pow2(res, bits) if bits > 0 else res
    return out.clamp(0, (1 << bd) - 1)


def _conv_buf(windows, spx, spy, w, h, tab, bd):
    """Dual-prediction intermediate (CONV_BUF domain)."""
    return _filter2d(windows, spx, spy, w, h, tab, tab, bd, ROUND1_COMP)


def _compound_out(res, bd):
    """Offset removal and the final rounding of a compound blend."""
    offset_bits = bd + 2 * FILTER_BITS - ROUND0
    res = res - ((1 << (offset_bits - ROUND1_COMP))
                 + (1 << (offset_bits - ROUND1_COMP - 1)))
    round_bits = 2 * FILTER_BITS - ROUND0 - ROUND1_COMP
    return res, round_bits


def convolve_2d_compound_avg(win0: torch.Tensor, win1: torch.Tensor,
                             spx0, spy0, spx1, spy1, w: int, h: int,
                             kind=EIGHTTAP_REGULAR,
                             bd: int = 8) -> torch.Tensor:
    """COMPOUND_AVERAGE dual prediction (jnt_convolve_2d with
    use_jnt_comp_avg = 0)."""
    tab = _tab_of(kind, win0.device)
    t0 = _conv_buf(win0, spx0, spy0, w, h, tab, bd)
    t1 = _conv_buf(win1, spx1, spy1, w, h, tab, bd)
    res, round_bits = _compound_out((t0 + t1) >> 1, bd)
    mag = (res.abs() + (1 << (round_bits - 1))) >> round_bits
    out = torch.where(res < 0, -mag, mag)
    return out.clamp(0, (1 << bd) - 1)


def convolve_2d_compound_diffwtd(win0: torch.Tensor, win1: torch.Tensor,
                                 spx0, spy0, spx1, spy1, w: int, h: int,
                                 inverse, kind=EIGHTTAP_REGULAR,
                                 bd: int = 8):
    """COMPOUND_DIFFWTD dual prediction: the 0..64 mask from the CONV_BUF
    difference (svt_av1_build_compound_diffwtd_mask_d16_c), then the d16
    masked blend.  inverse: (B,) — DIFFWTD_38_INV flips the mask.
    Returns (pred, mask); the mask, 2x2-subsampled, serves chroma."""
    tab = _tab_of(kind, win0.device)
    t0 = _conv_buf(win0, spx0, spy0, w, h, tab, bd)
    t1 = _conv_buf(win1, spx1, spy1, w, h, tab, bd)
    rnd = 2 * FILTER_BITS - ROUND0 - ROUND1_COMP + (bd - 8)
    diff = ((t0 - t1).abs() + (1 << (rnd - 1))) >> rnd
    m = (38 + diff // DIFF_FACTOR).clamp(0, 64)
    inv = torch.as_tensor(inverse, device=win0.device).to(
        torch.int32)[:, None, None]
    m = torch.where(inv > 0, 64 - m, m)
    res, round_bits = _compound_out((m * t0 + (64 - m) * t1) >> 6, bd)
    out = (res + (1 << (round_bits - 1))) >> round_bits
    return out.clamp(0, (1 << bd) - 1), m


def convolve_2d_compound_masked(win0: torch.Tensor, win1: torch.Tensor,
                                spx0, spy0, spx1, spy1, w: int, h: int,
                                mask: torch.Tensor,
                                kind=EIGHTTAP_REGULAR,
                                bd: int = 8) -> torch.Tensor:
    """Masked (wedge) dual prediction, bit-exact vs
    svt_aom_lowbd_blend_a64_d16_mask_c.  mask: (B, h, w) weights 0..64
    for src0 (already plane-subsampled for chroma)."""
    tab = _tab_of(kind, win0.device)
    t0 = _conv_buf(win0, spx0, spy0, w, h, tab, bd)
    t1 = _conv_buf(win1, spx1, spy1, w, h, tab, bd)
    m = mask.to(torch.int32)
    res, round_bits = _compound_out((m * t0 + (64 - m) * t1) >> 6, bd)
    out = (res + (1 << (round_bits - 1))) >> round_bits
    return out.clamp(0, (1 << bd) - 1)
