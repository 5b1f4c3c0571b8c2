"""AV1 2-D transforms (PyTorch, batched over (B, H, W) blocks).

Port of svt_av1_tpu/ops/transforms.py, with the same two paths:

  * ``inv_txfm2d_add``: the normative inverse transform, bit-exact per
    AV1 spec §7.13, as an int32 interpreter over the butterfly stage
    programs stored in svt_av1_tpu/codec/data/av1_inv_txfm_programs.npz.
  * ``fwd_txfm2d``: the non-normative forward transform, two float32
    matmuls with the pseudo-inverse matrices of the linearized inverse,
    then round-half-even.  Float sums are taken in a device- and
    library-dependent order, so a coefficient whose exact value lies on a
    rounding tie may come out one apart from the reference's.
"""
from __future__ import annotations

import functools
import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from av1ref.codec import constants as cc

_DATA = os.path.join(os.path.dirname(cc.__file__), "data",
                     "av1_inv_txfm_programs.npz")

INV_COS_BIT = 12
NEW_SQRT2 = 5793
NEW_INV_SQRT2 = 2896
NEW_SQRT2_BITS = 12


@functools.lru_cache(maxsize=1)
def _load():
    return dict(np.load(_DATA))


@functools.lru_cache(maxsize=None)
def _program(name: str) -> List[Dict[str, np.ndarray]]:
    d = _load()
    n = int(d[f"{name}__nstages"])
    return [{k: d[f"{name}__s{i}__{k}"]
             for k in ("mode", "a", "b", "a_w", "b_w", "c0", "c1", "s0", "s1")}
            for i in range(n)]


@functools.lru_cache(maxsize=None)
def _cospi(bit: int) -> np.ndarray:
    return _load()["cospi"][bit - 10]


@functools.lru_cache(maxsize=None)
def _sinpi(bit: int) -> np.ndarray:
    return _load()["sinpi"][bit - 10]


def inv_shift(tx_size: int) -> Tuple[int, int]:
    w, h = int(cc.tx_size_wide[tx_size]), int(cc.tx_size_high[tx_size])
    s = _load()[f"inv_shift_{w}x{h}"]
    return int(s[0]), int(s[1])


def _rect_log_ratio(w: int, h: int) -> int:
    if w == h:
        return 0
    if w > h:
        return 1 if w == 2 * h else 2
    return -1 if h == 2 * w else -2


# ---------------------------------------------------------------------------
# int32 stage-program interpreter (bit-exact inverse path)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _program_tensors(name: str, cos_bit: int, device):
    """Per-stage (a, b, ca, cb, a_w, b_w, mode) as device tensors."""
    cospi = _cospi(cos_bit)
    out = []
    for st in _program(name):
        i32 = lambda v: torch.as_tensor(np.asarray(v, np.int32),
                                        device=device)
        out.append((torch.as_tensor(st["a"].astype(np.int64), device=device),
                    torch.as_tensor(st["b"].astype(np.int64), device=device),
                    i32(st["s0"] * cospi[st["c0"]]),
                    i32(st["s1"] * cospi[st["c1"]]),
                    i32(st["a_w"]), i32(st["b_w"]), i32(st["mode"])))
    return out


def _run_program_int(x: torch.Tensor, name: str, cos_bit: int,
                     clamp_bit: int) -> torch.Tensor:
    """Run a butterfly stage program over the last axis. x: (..., N)
    int32."""
    half = 1 << (cos_bit - 1)
    lo = -(1 << (clamp_bit - 1))
    hi = (1 << (clamp_bit - 1)) - 1
    mask = (1 << cos_bit) - 1
    for a, b, ca, cb, aw, bw, mode in _program_tensors(name, cos_bit,
                                                       x.device):
        av = x[..., a]
        bv = x[..., b]
        # Exact 45-bit mult-accumulate in int32 (the C uses int64): split
        # the operands at cos_bit; since 2^bit*H + L with H, L below
        # overflow,
        #   round_shift(ca*av + cb*bv, bit)
        #     == H + ((L + half) >> bit),  H = ca*(av>>bit) + cb*(bv>>bit),
        #                                  L = ca*(av&m) + cb*(bv&m)
        p_hi = ca * (av >> cos_bit) + cb * (bv >> cos_bit)
        p_lo = ca * (av & mask) + cb * (bv & mask)
        btf = p_hi + ((p_lo + half) >> cos_bit)
        add = aw * av + bw * bv
        x = torch.where(mode == 1, btf,
                        torch.where(mode == 2, torch.clamp(add, lo, hi),
                                    add))
    return x


def _round_shift(x: torch.Tensor, bit: int) -> torch.Tensor:
    if bit == 0:
        return x
    return (x + (1 << (bit - 1))) >> bit


def _round_shift_mul(x: torch.Tensor, mult: int, bit: int) -> torch.Tensor:
    """Exact round_shift(x * mult, bit) where x*mult may exceed int32
    (the C reference computes this in int64): split x at bit."""
    mask = (1 << bit) - 1
    half = 1 << (bit - 1)
    return mult * (x >> bit) + ((mult * (x & mask) + half) >> bit)


def _iadst4_int(x: torch.Tensor, cos_bit: int) -> torch.Tensor:
    """Normative 4-point inverse ADST (sinpi network, spec §7.13.2.6)."""
    sinpi = [int(v) for v in _sinpi(cos_bit)]
    x0, x1, x2, x3 = (x[..., i] for i in range(4))
    s0 = sinpi[1] * x0
    s1 = sinpi[2] * x0
    s2 = sinpi[3] * x1
    s3 = sinpi[4] * x2
    s4 = sinpi[1] * x2
    s5 = sinpi[2] * x3
    s6 = sinpi[4] * x3
    s7 = (x0 - x2) + x3
    s0 = s0 + s3
    s1 = s1 - s4
    s3 = s2
    s2 = sinpi[3] * s7
    s0 = s0 + s5
    s1 = s1 - s6
    o0 = s0 + s3
    o1 = s1 + s3
    o2 = s2
    o3 = (s0 + s1) - s3
    out = torch.stack([o0, o1, o2, o3], dim=-1)
    return _round_shift(out, cos_bit)


def _iidentity_int(x: torch.Tensor, n: int) -> torch.Tensor:
    if n == 4:
        return _round_shift_mul(x, NEW_SQRT2, NEW_SQRT2_BITS)
    if n == 8:
        return x * 2
    if n == 16:
        return _round_shift_mul(x, 2 * NEW_SQRT2, NEW_SQRT2_BITS)
    if n == 32:
        return x * 4
    if n == 64:
        return _round_shift_mul(x, 4 * NEW_SQRT2, NEW_SQRT2_BITS)
    raise ValueError(n)


def _run_1d_int(x: torch.Tensor, kind: int, n: int,
                clamp_bit: int) -> torch.Tensor:
    """1-D inverse transform over the last axis (length n).  FLIPADST
    shares the ADST network; flips are applied by inv_txfm2d_add."""
    if kind == cc.TX1D_IDTX:
        return _iidentity_int(x, n)
    if kind in (cc.TX1D_ADST, cc.TX1D_FLIPADST):
        if n == 4:
            return _iadst4_int(x, INV_COS_BIT)
        return _run_program_int(x, f"iadst{n}", INV_COS_BIT, clamp_bit)
    return _run_program_int(x, f"idct{n}", INV_COS_BIT, clamp_bit)


def inv_txfm2d_add(coeffs: torch.Tensor, pred: torch.Tensor, tx_type: int,
                   tx_size: int, bd: int = 8) -> torch.Tensor:
    """Normative inverse transform + reconstruction.

    coeffs: (B, H, W) int32 dequantized coefficients (for 64-point
            dimensions the coded (<= 32) region; the rest is zero).
    pred:   (B, H, W) integer prediction samples.
    Returns (B, H, W) int32 reconstructed samples clipped to
    [0, 2^bd - 1], bit-exact with the reference
    ``svt_av1_inv_txfm2d_add_*_c``."""
    w = int(cc.tx_size_wide[tx_size])
    h = int(cc.tx_size_high[tx_size])
    vt, ht = cc.tx_type_1d[tx_type]
    s0, s1 = inv_shift(tx_size)
    rect = _rect_log_ratio(w, h)

    x = coeffs.to(torch.int32)
    if x.shape[-1] < w or x.shape[-2] < h:
        x = torch.nn.functional.pad(
            x, (0, w - x.shape[-1], 0, h - x.shape[-2]))
    # -- rows ---------------------------------------------------------------
    if abs(rect) == 1:
        x = _round_shift_mul(x, NEW_INV_SQRT2, NEW_SQRT2_BITS)
    cb_in = bd + 8
    x = torch.clamp(x, -(1 << (cb_in - 1)), (1 << (cb_in - 1)) - 1)
    row_clamp = {8: 16, 10: 18, 12: 20}[bd]
    x = _run_1d_int(x, ht, w, row_clamp)
    x = _round_shift(x, -s0)
    # -- columns ------------------------------------------------------------
    if ht == cc.TX1D_FLIPADST:
        x = torch.flip(x, [-1])
    x = x.transpose(-1, -2)  # (B, W, H)
    cb_mid = max(bd + 6, 16)
    x = torch.clamp(x, -(1 << (cb_mid - 1)), (1 << (cb_mid - 1)) - 1)
    col_clamp = {8: 16, 10: 16, 12: 18}[bd]
    x = _run_1d_int(x, vt, h, col_clamp)
    x = _round_shift(x, -s1)
    x = x.transpose(-1, -2)  # (B, H, W)
    if vt == cc.TX1D_FLIPADST:
        x = torch.flip(x, [-2])
    return torch.clamp(pred.to(torch.int32) + x, 0, (1 << bd) - 1)


# ---------------------------------------------------------------------------
# forward transform: float32 matmuls
# ---------------------------------------------------------------------------


