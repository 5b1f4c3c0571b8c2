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

from svt_av1_tpu_torch.codec import constants as cc

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

def _run_program_float(x: np.ndarray, name: str) -> np.ndarray:
    """Linearized (no rounding/clamp) stage program in float64 — used only
    to derive the forward matrices."""
    cospi = _cospi(INV_COS_BIT).astype(np.float64) / (1 << INV_COS_BIT)
    for st in _program(name):
        av = x[..., st["a"]]
        bv = x[..., st["b"]]
        ca = st["s0"] * cospi[st["c0"]]
        cb = st["s1"] * cospi[st["c1"]]
        btf = ca * av + cb * bv
        add = st["a_w"] * av + st["b_w"] * bv
        x = np.where(st["mode"] == 1, btf, add)
    return x


def _linear_inv_1d(kind: int, n: int) -> np.ndarray:
    """Matrix M (n x n) of the linearized 1-D inverse: out = M @ in."""
    eye = np.eye(n, dtype=np.float64)
    if kind == cc.TX1D_IDTX:
        scale = {4: np.sqrt(2), 8: 2.0, 16: 2 * np.sqrt(2), 32: 4.0,
                 64: 4 * np.sqrt(2)}[n]
        return eye * scale
    if kind in (cc.TX1D_ADST, cc.TX1D_FLIPADST):
        if n == 4:
            sinpi = _sinpi(INV_COS_BIT).astype(np.float64) / (1 << INV_COS_BIT)
            rows = []
            for basis in eye:
                x0, x1, x2, x3 = basis
                s0 = sinpi[1] * x0 + sinpi[4] * x2 + sinpi[2] * x3
                s1 = sinpi[2] * x0 - sinpi[1] * x2 - sinpi[4] * x3
                s3 = sinpi[3] * x1
                s2 = sinpi[3] * ((x0 - x2) + x3)
                rows.append([s0 + s3, s1 + s3, s2, s0 + s1 - s3])
            return np.array(rows).T
        name = f"iadst{n}"
    else:
        name = f"idct{n}"
    cols = [_run_program_float(eye[i], name) for i in range(n)]
    return np.array(cols).T


@functools.lru_cache(maxsize=None)
def _fwd_matrices(tx_type: int, tx_size: int) -> Tuple[np.ndarray, np.ndarray,
                                                       bool, bool]:
    """(Fv [kh x H], Fh [kw x W], ud_flip, lr_flip): forward matrices such
    that coeff = Fv @ residual @ Fh.T lands in the normative coefficient
    domain (pseudo-inverse of the linearized inverse transform including
    rect-sqrt2 scaling and the 2-D shifts).  kh/kw are the coded dims
    (32 for 64-point axes)."""
    w = int(cc.tx_size_wide[tx_size])
    h = int(cc.tx_size_high[tx_size])
    vt, ht = cc.tx_type_1d[tx_type]
    s0, s1 = inv_shift(tx_size)
    rect = _rect_log_ratio(w, h)

    mh = _linear_inv_1d(ht, w)
    mv = _linear_inv_1d(vt, h)
    kw = min(w, 32)
    kh = min(h, 32)
    mh = mh[:, :kw]
    mv = mv[:, :kh]
    # full inverse linear map: resid = g * Mv @ C @ Mh.T
    g = float(2.0 ** (s0 + s1))
    if abs(rect) == 1:
        g /= np.sqrt(2.0)
    fh = np.linalg.pinv(mh * np.sqrt(g))
    fv = np.linalg.pinv(mv * np.sqrt(g))
    return (fv.astype(np.float32), fh.astype(np.float32),
            vt == cc.TX1D_FLIPADST, ht == cc.TX1D_FLIPADST)


@functools.lru_cache(maxsize=None)
def fwd_matrices_on(tx_type: int, tx_size: int, device):
    """(Fv, Fh) of ``_fwd_matrices`` as contiguous float32 tensors."""
    fv, fh, _, _ = _fwd_matrices(tx_type, tx_size)
    return (torch.as_tensor(fv, device=device).contiguous(),
            torch.as_tensor(fh, device=device).contiguous())


def fwd_txfm2d(residual: torch.Tensor, tx_type: int, tx_size: int
               ) -> torch.Tensor:
    """Forward transform: residual (B, H, W) int -> coeffs (B, kh, kw)
    int32 in the normative coefficient domain: vertical matmul, then
    horizontal, in float32, rounded half to even."""
    _, _, ud_flip, lr_flip = _fwd_matrices(tx_type, tx_size)
    fv, fh = fwd_matrices_on(tx_type, tx_size, residual.device)
    x = residual.to(torch.float32)
    if ud_flip:
        x = torch.flip(x, [-2])
    if lr_flip:
        x = torch.flip(x, [-1])
    y = torch.matmul(fv, x)                  # (B, kh, W)
    y = torch.matmul(y, fh.transpose(0, 1))  # (B, kh, kw)
    return torch.round(y).to(torch.int32)


@functools.lru_cache(maxsize=None)
def coeff_sse_scale(tx_size: int, tx_type: int) -> float:
    """Pixel SSE per unit coefficient SSE for this transform, measured
    once per (size, type) through the integer inverse, on the CPU with
    the port's own ops (the same seed and steps as the reference's).

    Mode decision estimates pixel distortion in the transform domain:
    for near-orthogonal AV1 transforms, pixel SSE ~= s2 * sum((coeff -
    dequant)^2)."""
    rng = np.random.default_rng(0)
    w, h, _, _ = txfm_block_dims(tx_size)
    b = 8
    r = rng.integers(-200, 201, (b, h, w)).astype(np.int32)
    x1 = fwd_txfm2d(torch.as_tensor(r), tx_type, tx_size)
    d = rng.integers(-40, 41, tuple(x1.shape)).astype(np.int32)
    pred = torch.full((b, h, w), 512, dtype=torch.int32)
    rec1 = inv_txfm2d_add(x1, pred, tx_type, tx_size, bd=10).numpy()
    rec2 = inv_txfm2d_add(x1 + torch.as_tensor(d), pred, tx_type, tx_size,
                          bd=10).numpy()
    num = float(((rec2 - rec1).astype(np.int64) ** 2).sum())
    den = float((d.astype(np.int64) ** 2).sum())
    return num / max(den, 1.0)


def txfm_block_dims(tx_size: int) -> Tuple[int, int, int, int]:
    """(W, H, coded_W, coded_H) for a tx size."""
    w = int(cc.tx_size_wide[tx_size])
    h = int(cc.tx_size_high[tx_size])
    return w, h, min(w, 32), min(h, 32)
