"""Affine warped-motion prediction (spec 7.11.3.2; warped_motion.c
svt_av1_warp_affine_c / svt_get_shear_params), the PyTorch port of
svt_av1_tpu/ops/warp.py.

Every 8x8 output block of the warped region is one batch lane: the
per-block integer source anchors and fractional phases are computed up
front, the 15x18 clamped source windows are gathered once, and both
filter passes are multiply-and-sum against per-position 8-tap filters
looked up from the normative table (193 x 8), in int32.  Bit-exact with
the reference (non-compound path).
"""
from __future__ import annotations

import functools
import os

import numpy as np
import torch

WARPEDMODEL_PREC_BITS = 16
WARPEDPIXEL_PREC_BITS = 6
WARPEDDIFF_PREC_BITS = WARPEDMODEL_PREC_BITS - WARPEDPIXEL_PREC_BITS
WARPEDPIXEL_PREC_SHIFTS = 1 << WARPEDPIXEL_PREC_BITS
WARP_PARAM_REDUCE_BITS = 6
FILTER_BITS = 7

_DATA = os.path.join(os.path.dirname(__file__), "..", "codec", "data",
                     "av1_warp_filters.npz")


@functools.lru_cache(maxsize=1)
def warped_filter() -> np.ndarray:
    return np.load(_DATA)["warped_filter"].astype(np.int32)


@functools.lru_cache(maxsize=None)
def _filter_on(device) -> torch.Tensor:
    return torch.as_tensor(warped_filter(), device=device)


def _rpot_signed(v: int, n: int) -> int:
    m = (abs(v) + (1 << (n - 1))) >> n
    return -m if v < 0 else m


@functools.lru_cache(maxsize=1)
def _div_lut() -> np.ndarray:
    """div_lut[f] = round(2^14 * 256 / (256 + f)), the normative divisor
    table (warped_motion.c:298)."""
    f = np.arange(257)
    return np.round((1 << 14) * 256.0 / (256 + f)).astype(np.int32)


def _resolve_divisor_32(d: int):
    """(y, shift) such that 1/d ~= y >> shift (resolve_divisor_32)."""
    shift = d.bit_length() - 1
    e = d - (1 << shift)
    if shift > 8:
        f = (e + (1 << (shift - 9))) >> (shift - 8)
    else:
        f = e << (8 - shift)
    return int(_div_lut()[f]), shift + 14


def shear_params(mat):
    """(alpha, beta, gamma, delta), or None when the affine set is
    invalid (svt_get_shear_params)."""
    if mat[2] <= 0:
        return None
    alpha = int(np.clip(mat[2] - (1 << WARPEDMODEL_PREC_BITS),
                        -32768, 32767))
    beta = int(np.clip(mat[3], -32768, 32767))
    y, shift = _resolve_divisor_32(abs(mat[2]))
    y *= 1 if mat[2] >= 0 else -1
    v = (mat[4] << WARPEDMODEL_PREC_BITS) * y
    gamma = int(np.clip(_rpot_signed(v, shift), -32768, 32767))
    v = (mat[3] * mat[4]) * y
    delta = int(np.clip(mat[5] - _rpot_signed(v, shift)
                        - (1 << WARPEDMODEL_PREC_BITS), -32768, 32767))
    rb = WARP_PARAM_REDUCE_BITS
    alpha = _rpot_signed(alpha, rb) * (1 << rb)
    beta = _rpot_signed(beta, rb) * (1 << rb)
    gamma = _rpot_signed(gamma, rb) * (1 << rb)
    delta = _rpot_signed(delta, rb) * (1 << rb)
    if (4 * abs(alpha) + 7 * abs(beta) >= (1 << WARPEDMODEL_PREC_BITS)
            or 4 * abs(gamma) + 4 * abs(delta)
            >= (1 << WARPEDMODEL_PREC_BITS)):
        return None
    return alpha, beta, gamma, delta


def warp_core(ref, ix4, iy4, sx4, sy4, alpha, beta, gamma, delta,
              bd: int = 8) -> torch.Tensor:
    """Batched 8x8-block warp of an (h, w) int32 plane: per-block source
    anchors ix4/iy4 and phases sx4/sy4 ((nb,) int32), shear parameters
    as ints or 0-d int32 tensors.  Returns (nb, 8, 8) int32."""
    h, w = ref.shape
    dev = ref.device
    offset_bits_horiz = bd + FILTER_BITS - 1
    round0 = 3 + (2 if bd == 12 else 0)
    reduce_bits_vert = 2 * FILTER_BITS - round0
    offset_bits_vert = bd + 2 * FILTER_BITS - round0
    tbl = _filter_on(dev)
    # source windows: rows iy4-7..iy4+7 (15), cols ix4-7..ix4+10 (18)
    rr = (iy4[:, None] + torch.arange(-7, 8, device=dev)[None]).clamp(
        0, h - 1)
    cc_ = (ix4[:, None] + torch.arange(-7, 11, device=dev)[None]).clamp(
        0, w - 1)
    win = ref[rr[:, :, None].long(), cc_[:, None, :].long()]  # (nb,15,18)
    li = torch.arange(8, device=dev, dtype=torch.int32)
    ki15 = torch.arange(15, device=dev, dtype=torch.int32)
    # horizontal phases: row k (-7..7) advances by beta * (k + 4)
    sx = (sx4[:, None, None] + alpha * li[None, None, :]
          + beta * (ki15[None, :, None] - 3))
    offs_h = ((sx + (1 << (WARPEDDIFF_PREC_BITS - 1)))
              >> WARPEDDIFF_PREC_BITS) + WARPEDPIXEL_PREC_SHIFTS
    fh = tbl[offs_h.long()]                               # (nb,15,8,8)
    # samples(k, l, m) = win[k, l + m]
    smp = torch.stack([win[:, :, l:l + 8] for l in range(8)], dim=2)
    tmp = (smp * fh).sum(dim=-1, dtype=torch.int32)
    tmp = (tmp + (1 << offset_bits_horiz)
           + (1 << (round0 - 1))) >> round0              # (nb, 15, 8)
    ki = torch.arange(8, device=dev, dtype=torch.int32)
    sy = (sy4[:, None, None] + gamma * li[None, None, :]
          + delta * ki[None, :, None])
    offs_v = ((sy + (1 << (WARPEDDIFF_PREC_BITS - 1)))
              >> WARPEDDIFF_PREC_BITS) + WARPEDPIXEL_PREC_SHIFTS
    fv = tbl[offs_v.long()]                               # (nb,8,8,8)
    vs = torch.stack([tmp[:, k:k + 8, :] for k in range(8)], dim=1)
    acc = (vs.transpose(2, 3) * fv).sum(dim=-1, dtype=torch.int32)
    acc = acc + (1 << offset_bits_vert)
    acc = (acc + (1 << (reduce_bits_vert - 1))) >> reduce_bits_vert
    return (acc - (1 << (bd - 1)) - (1 << bd)).clamp(0, (1 << bd) - 1)


def warp_plane(ref: torch.Tensor, mat, p_width: int, p_height: int,
               bd: int = 8, p_col: int = 0, p_row: int = 0,
               subsampling: int = 0):
    """Warped prediction of a (p_height, p_width) region anchored at
    (p_row, p_col) of an int32 plane on its device, for a 6-entry wmmat
    of Python ints.  None when the model's shear is illegal."""
    sh = shear_params(mat)
    if sh is None:
        return None
    alpha, beta, gamma, delta = sh
    gbh, gbw = p_height // 8, p_width // 8
    nb = gbh * gbw
    bi = (np.arange(nb) // gbw) * 8 + p_row
    bj = (np.arange(nb) % gbw) * 8 + p_col
    src_x = (bj + 4) << subsampling
    src_y = (bi + 4) << subsampling
    dst_x = mat[2] * src_x + mat[3] * src_y + mat[0]
    dst_y = mat[4] * src_x + mat[5] * src_y + mat[1]
    x4 = dst_x >> subsampling
    y4 = dst_y >> subsampling
    ix4 = x4 >> WARPEDMODEL_PREC_BITS
    sx4 = x4 & ((1 << WARPEDMODEL_PREC_BITS) - 1)
    iy4 = y4 >> WARPEDMODEL_PREC_BITS
    sy4 = y4 & ((1 << WARPEDMODEL_PREC_BITS) - 1)
    sx4 = sx4 + alpha * (-4) + beta * (-4)
    sy4 = sy4 + gamma * (-4) + delta * (-4)
    sx4 &= ~((1 << WARP_PARAM_REDUCE_BITS) - 1)
    sy4 &= ~((1 << WARP_PARAM_REDUCE_BITS) - 1)
    t = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=ref.device)
    out = warp_core(ref.to(torch.int32), t(ix4), t(iy4), t(sx4), t(sy4),
                    alpha, beta, gamma, delta, bd)
    return (out.reshape(gbh, gbw, 8, 8).permute(0, 2, 1, 3)
            .reshape(p_height, p_width))
