"""AV1 intra predictors (PyTorch, batched over blocks).

Port of svt_av1_tpu/ops/intra.py for the modes the all-intra M5-M13
slice codes — DC (with its top / left / 128 variants), V, H, SMOOTH,
PAETH, the three directional zones (zone 2 for D135/D113/D157, zones 1
and 3 for the angle-delta refinements of V and H) and chroma-from-luma
— and SMOOTH_V/SMOOTH_H.  Normative per AV1 spec §7.11.2; every
predictor works on prepared neighbor arrays:

  above:      (B, W) int32 — reconstructed row above the block
  left:       (B, H) int32 — reconstructed column left of the block
  above_left: (B,)   int32 — corner sample
  returns     (B, H, W) int32 prediction

Smooth weights and directional derivatives are the normative tables in
svt_av1_tpu/codec/data/av1_intra_tables.npz.
"""
from __future__ import annotations

import functools
import os

import numpy as np
import torch

from svt_av1_tpu_torch.codec import constants as cc

_DATA = os.path.join(os.path.dirname(cc.__file__), "data",
                     "av1_intra_tables.npz")

SM_WEIGHT_LOG2 = 8


@functools.lru_cache(maxsize=1)
def _tables():
    return dict(np.load(_DATA))


@functools.lru_cache(maxsize=None)
def sm_weights(n: int) -> np.ndarray:
    """Smooth weights for block dimension n (spec Sm_Weights_Tx_*)."""
    arr = _tables()["sm_weight_arrays"]
    return arr[n:2 * n].astype(np.int32)


@functools.lru_cache(maxsize=None)
def _sm_weights_on(n: int, device) -> torch.Tensor:
    return torch.as_tensor(sm_weights(n), device=device)


def dc_pred(above, left, bd: int = 8):
    b, w = above.shape
    h = left.shape[1]
    total = above.sum(dim=1, dtype=torch.int32) + left.sum(dim=1,
                                                           dtype=torch.int32)
    avg = (total + ((w + h) >> 1)) // (w + h)
    return avg[:, None, None].expand(b, h, w)


def dc_top_pred(above, h: int):
    b, w = above.shape
    avg = (above.sum(dim=1, dtype=torch.int32) + (w >> 1)) >> int(np.log2(w))
    return avg[:, None, None].expand(b, h, w)


def dc_left_pred(left, w: int):
    b, h = left.shape
    avg = (left.sum(dim=1, dtype=torch.int32) + (h >> 1)) >> int(np.log2(h))
    return avg[:, None, None].expand(b, h, w)


def dc_128_pred(b: int, h: int, w: int, bd: int = 8, device=None):
    return torch.full((b, h, w), 1 << (bd - 1), dtype=torch.int32,
                      device=device)


def v_pred(above, h: int):
    b, w = above.shape
    return above[:, None, :].expand(b, h, w)


def h_pred(left, w: int):
    b, h = left.shape
    return left[:, :, None].expand(b, h, w)


def paeth_pred(above, left, above_left):
    t = above[:, None, :]           # (B,1,W)
    l = left[:, :, None]            # (B,H,1)
    tl = above_left[:, None, None]  # (B,1,1)
    base = t + l - tl
    p_t = (base - t).abs()
    p_l = (base - l).abs()
    p_tl = (base - tl).abs()
    return torch.where((p_l <= p_t) & (p_l <= p_tl), l,
                       torch.where(p_t <= p_tl, t, tl))


def smooth_pred(above, left, h: int, w: int):
    wh = _sm_weights_on(h, above.device)[None, :, None]   # (1,H,1)
    ww = _sm_weights_on(w, above.device)[None, None, :]   # (1,1,W)
    below = left[:, h - 1][:, None, None]   # bottom-left sample
    right = above[:, w - 1][:, None, None]  # top-right sample
    t = above[:, None, :]
    l = left[:, :, None]
    scale = 1 << SM_WEIGHT_LOG2
    total = (wh * t + (scale - wh) * below + ww * l + (scale - ww) * right)
    log2 = SM_WEIGHT_LOG2 + 1
    return (total + (1 << (log2 - 1))) >> log2


def smooth_v_pred(above, left, h: int, w: int):
    wh = _sm_weights_on(h, above.device)[None, :, None]
    below = left[:, h - 1][:, None, None]
    scale = 1 << SM_WEIGHT_LOG2
    total = wh * above[:, None, :] + (scale - wh) * below
    return ((total + (scale >> 1)) >> SM_WEIGHT_LOG2).expand(-1, h, w)


def smooth_h_pred(above, left, h: int, w: int):
    ww = _sm_weights_on(w, above.device)[None, None, :]
    right = above[:, w - 1][:, None, None]
    scale = 1 << SM_WEIGHT_LOG2
    total = ww * left[:, :, None] + (scale - ww) * right
    return ((total + (scale >> 1)) >> SM_WEIGHT_LOG2).expand(-1, h, w)


MODE_TO_ANGLE = {cc.V_PRED: 90, cc.H_PRED: 180, cc.D45_PRED: 45,
                 cc.D135_PRED: 135, cc.D113_PRED: 113, cc.D157_PRED: 157,
                 cc.D203_PRED: 203, cc.D67_PRED: 67}


@functools.lru_cache(maxsize=1)
def dr_derivative() -> np.ndarray:
    return _tables()["dr_intra_derivative"].astype(np.int32)


def get_dx(angle: int) -> int:
    d = dr_derivative()
    if 0 < angle < 90:
        return int(d[angle])
    if 90 < angle < 180:
        return int(d[180 - angle])
    return 1


def get_dy(angle: int) -> int:
    d = dr_derivative()
    if 90 < angle < 180:
        return int(d[angle - 90])
    if 180 < angle < 270:
        return int(d[270 - angle])
    return 1


@functools.lru_cache(maxsize=None)
def _z2_maps(h: int, w: int, angle: int, device):
    """Static gather indices, shifts and the above/left select of the
    zone-2 predictor, as device tensors."""
    dx = get_dx(angle)
    dy = get_dy(angle)
    r = np.arange(h)[:, None]
    c = np.arange(w)[None, :]
    x = -(r + 1) * dx                        # (h, 1)
    base1 = (x >> 6) + c                     # (h, w)
    shift1 = ((x & 63) >> 1) * np.ones_like(c)
    y = (r << 6) - (c + 1) * dy
    base2 = y >> 6
    shift2 = (y & 63) >> 1
    use_above = base1 >= -1
    # clamp gather indices into range; the select masks out the rest
    ia = np.clip(base1 + 1, 0, w - 1)
    il = np.clip(base2 + 1, 0, h - 1)
    as_t = lambda v, dt: torch.as_tensor(np.asarray(v), dtype=dt,
                                         device=device)
    return (as_t(ia, torch.int64), as_t(shift1, torch.int32),
            as_t(il, torch.int64), as_t(shift2, torch.int32),
            as_t(use_above, torch.bool))


def z2_pred(above, left, above_left, h: int, w: int, angle: int):
    """Directional prediction, zone 2 (90 < angle < 180), upsample off
    (normative dr_prediction_z2 with enable_intra_edge_filter = 0).  Uses
    only above[0..w-1], left[0..h-1] and the corner."""
    if not 90 < angle < 180:
        raise ValueError(f"zone-2 angle expected, got {angle}")
    ia, shift1, il, shift2, use_above = _z2_maps(h, w, angle, above.device)
    # arrays with the corner at index 0
    atab = torch.cat([above_left[:, None], above], dim=1)  # (B, w+1)
    ltab = torch.cat([above_left[:, None], left], dim=1)   # (B, h+1)
    av = (atab[:, ia] * (32 - shift1) + atab[:, ia + 1] * shift1 + 16) >> 5
    lv = (ltab[:, il] * (32 - shift2) + ltab[:, il + 1] * shift2 + 16) >> 5
    return torch.where(use_above, av, lv)


@functools.lru_cache(maxsize=None)
def _z13_maps(h: int, w: int, d: int, zone3: bool, device):
    """Static gather index, shift and past-the-end mask of the zone-1
    predictor (derivative ``d`` = dx) or, transposed, the zone-3 one
    (``d`` = dy), as device tensors."""
    max_base = w + h - 1
    r = np.arange(h)[:, None]
    c = np.arange(w)[None, :]
    if zone3:
        step = (c + 1) * d
        base = (step >> 6) + r
        shift = ((step & 63) >> 1) * np.ones_like(r)
    else:
        step = (r + 1) * d
        base = (step >> 6) + c
        shift = ((step & 63) >> 1) * np.ones_like(c)
    as_t = lambda v, dt: torch.as_tensor(np.asarray(v), dtype=dt,
                                         device=device)
    return (as_t(np.minimum(base, max_base), torch.int64),
            as_t(shift, torch.int32), as_t(base >= max_base, torch.bool))


def _z13_pred(ext, h: int, w: int, d: int, zone3: bool):
    idx, shift, past = _z13_maps(h, w, d, zone3, ext.device)
    val = (ext[:, idx] * (32 - shift) + ext[:, idx + 1] * shift + 16) >> 5
    return torch.where(past, ext[:, w + h - 1][:, None, None], val)


def z1_pred(above_ext, h: int, w: int, angle: int):
    """Directional zone 1 (angle < 90), upsample off.

    above_ext: (B, w+h+1) — the above row extended across the top-right
    (prepared with availability replication); the last entry repeats
    above_ext[w+h-1] so that idx+1 gathers stay in range."""
    if not 0 < angle < 90:
        raise ValueError(f"zone-1 angle expected, got {angle}")
    return _z13_pred(above_ext, h, w, get_dx(angle), False)


def z3_pred(left_ext, h: int, w: int, angle: int):
    """Directional zone 3 (angle > 180), upsample off.

    left_ext: (B, w+h+1) — the left column extended across the
    bottom-left."""
    if not 180 < angle < 270:
        raise ValueError(f"zone-3 angle expected, got {angle}")
    return _z13_pred(left_ext, h, w, get_dy(angle), True)


def cfl_ac_420(luma, h: int, w: int):
    """CfL luma AC buffer for 4:2:0 (spec cfl_luma_subsampling_420 +
    subtract_average): 2x2 box sum << 1 (q3), minus the rounded block
    average.

    luma: (B, 2h, 2w) int32 reconstructed luma.  Returns (B, h, w) q3."""
    sub = ((luma[:, 0::2, 0::2] + luma[:, 0::2, 1::2]
            + luma[:, 1::2, 0::2] + luma[:, 1::2, 1::2]) << 1)
    npel_log2 = int(np.log2(h * w))
    ro = (h * w) // 2
    avg = (sub.sum(dim=(1, 2), dtype=torch.int32) + ro) >> npel_log2
    return sub - avg[:, None, None]


def cfl_predict(dc_pred, ac_q3, alpha_q3, bd: int = 8):
    """CfL prediction: dc + round(alpha_q3 * ac_q3 / 64), signed
    rounding, clipped.

    alpha_q3: int, or a (B,) or (B,1,1) int32 tensor, in [-16, 16]."""
    a = alpha_q3
    if isinstance(a, torch.Tensor) and a.dim() == 1:
        a = a[:, None, None]
    v = a * ac_q3
    scaled = torch.where(v < 0, -((-v + 32) >> 6), (v + 32) >> 6)
    return torch.clamp(dc_pred + scaled, 0, (1 << bd) - 1)


def predict(mode: int, above, left, above_left, h: int, w: int,
            have_above=None, have_left=None, bd: int = 8):
    """One intra mode (static) over a batch.

    have_above/have_left: optional (B,) bool tensors — only DC consults
    them (spec: DC averages only the available edges); the other modes
    rely on the neighbor substitution done by the caller."""
    b = above.shape[0]
    if mode == cc.DC_PRED:
        if have_above is None:
            return dc_pred(above, left, bd)
        ha = have_above[:, None, None]
        hl = have_left[:, None, None]
        return torch.where(
            ha & hl, dc_pred(above, left, bd),
            torch.where(ha, dc_top_pred(above, h),
                        torch.where(hl, dc_left_pred(left, w),
                                    dc_128_pred(b, h, w, bd,
                                                device=above.device))))
    if mode == cc.V_PRED:
        return v_pred(above, h)
    if mode == cc.H_PRED:
        return h_pred(left, w)
    if mode == cc.SMOOTH_PRED:
        return smooth_pred(above, left, h, w)
    if mode == cc.SMOOTH_V_PRED:
        return smooth_v_pred(above, left, h, w)
    if mode == cc.SMOOTH_H_PRED:
        return smooth_h_pred(above, left, h, w)
    if mode == cc.PAETH_PRED:
        return paeth_pred(above, left, above_left)
    if mode in (cc.D135_PRED, cc.D113_PRED, cc.D157_PRED):
        return z2_pred(above, left, above_left, h, w, MODE_TO_ANGLE[mode])
    raise NotImplementedError(
        f"intra mode {mode} is not ported yet (ROADMAP.md queue A item 7: "
        "D45/D67/D203 and filter-intra come with presets M0-M4)")
