"""AV1 quantization / dequantization (PyTorch, batched).

Port of svt_av1_tpu/ops/quant.py.  The table construction is numpy and
identical to the reference (dc/ac qlookup tables from
svt_av1_tpu/codec/data/av1_quant_tables.npz); ``quantize`` and
``dequantize`` are elementwise int32 programs over (B, H, W) blocks with
the reference's operation order, so they are bit-exact on any device.
"""
from __future__ import annotations

import functools
import os
from typing import NamedTuple

import numpy as np
import torch

from svt_av1_tpu_torch.codec import constants as cc

_DATA = os.path.join(os.path.dirname(cc.__file__), "data",
                     "av1_quant_tables.npz")


@functools.lru_cache(maxsize=1)
def _q_tables():
    return dict(np.load(_DATA))


def dc_q(qindex: int, delta: int = 0, bd: int = 8) -> int:
    q = int(np.clip(qindex + delta, 0, 255))
    key = {8: "dc_qlookup", 10: "dc_qlookup_10", 12: "dc_qlookup_12"}[bd]
    return int(_q_tables()[key][q])


def ac_q(qindex: int, delta: int = 0, bd: int = 8) -> int:
    q = int(np.clip(qindex + delta, 0, 255))
    key = {8: "ac_qlookup", 10: "ac_qlookup_10", 12: "ac_qlookup_12"}[bd]
    return int(_q_tables()[key][q])


def invert_quant(d: int):
    """(quant, shift) fixed-point reciprocal of quantizer step d."""
    t = d
    l = 0
    while t > 1:
        t >>= 1
        l += 1
    m = 1 + (1 << (16 + l)) // d
    return m - (1 << 16), 1 << (16 - l)


class QuantParams(NamedTuple):
    """Per-(qindex, plane) quantizer constants for DC ([0]) and AC ([1]):
    numpy int32 (2,) arrays from ``make_quant_params``, int32 tensors
    after ``to_device``."""
    zbin: np.ndarray
    round: np.ndarray
    quant: np.ndarray
    quant_shift: np.ndarray
    dequant: np.ndarray


@functools.lru_cache(maxsize=None)
def make_quant_params(qindex: int, dc_delta: int = 0, ac_delta: int = 0,
                      bd: int = 8) -> QuantParams:
    qzbin_factor = 64 if qindex == 0 else 80
    qrounding_factor = 64 if qindex == 0 else 48
    zbin, rnd, quant, qshift, deq = ([] for _ in range(5))
    for i in range(2):
        q = (dc_q(qindex, dc_delta, bd) if i == 0
             else ac_q(qindex, ac_delta, bd))
        qv, sv = invert_quant(q)
        quant.append(qv)
        qshift.append(sv)
        zbin.append((qzbin_factor * q + 64) >> 7)
        rnd.append((qrounding_factor * q) >> 7)
        deq.append(q)
    mk = lambda v: np.array(v, dtype=np.int32)
    return QuantParams(mk(zbin), mk(rnd), mk(quant), mk(qshift), mk(deq))


def to_device(qp, device) -> QuantParams:
    """QuantParams (numpy or tensors) as contiguous int32 (2,) tensors.
    The five are rows of one (5, 2) tensor, so that a kernel can read all
    ten constants from one pointer (ops/fused_txq.py)."""
    packed = torch.stack([
        torch.as_tensor(a if isinstance(a, torch.Tensor) else np.asarray(a))
        .to(device=device, dtype=torch.int32).reshape(2) for a in qp])
    return QuantParams(*packed.unbind(0))


@functools.lru_cache(maxsize=64)
def params_on(qindex: int, device, bd: int = 8) -> QuantParams:
    """``to_device(make_quant_params(qindex, bd=bd), device)``, made once
    per (qindex, device, bd); never written."""
    return to_device(make_quant_params(qindex, bd=bd), device)


class StreamQuant(NamedTuple):
    """The quantizers of a stream batch (several independent encodes run
    as one program, parallel/multistream.py): ``table`` is (S, 5, 2)
    int32, the packed QuantParams of stream s in row s (``to_device``'s
    layout), and ``sid`` the (B,) int64 stream index of every block of
    the batch the quantizer serves.  Unlike the per-block rows of
    adaptive quantization, every block of a stream shares its stream's
    row, so the 16x16 DCT_DCT luma step may take K1's per-row form
    (ops/fused_txq.fused_txq_rows)."""
    table: torch.Tensor
    sid: torch.Tensor

    def rows(self) -> QuantParams:
        """The per-block (B, 2) rows of ``quantize`` (one gather)."""
        g = self.table[self.sid]
        return QuantParams(*(g[:, k] for k in range(5)))

    def repeat(self, k: int) -> "StreamQuant":
        """The quantizer of k stacked copies of the batch (candidate-major:
        block j of the result is block j % B)."""
        return StreamQuant(self.table, self.sid.repeat(k))

    def take(self, idx) -> "StreamQuant":
        return StreamQuant(self.table, self.sid[idx])


def stream_table(qindices, device, bd: int = 8) -> torch.Tensor:
    """(S, 5, 2) int32 quantizer table of a stream batch, one row per
    qindex (``StreamQuant.table``)."""
    return torch.stack([torch.stack(tuple(params_on(int(q), device, bd)))
                        for q in qindices])


def repeat_rows(qp, k: int):
    """The quantizer of k candidate-major copies of a block batch: a
    frame quantizer as it is, per-block rows or a StreamQuant repeated."""
    if isinstance(qp, StreamQuant):
        return qp.repeat(k)
    if qp.zbin.dim() == 2:
        return QuantParams(*(a.repeat(k, 1) for a in qp))
    return qp


def take_rows(qp, idx):
    """The quantizer of the blocks ``idx`` of a batch: a StreamQuant's
    rows, a frame quantizer as it is."""
    return qp.take(idx) if isinstance(qp, StreamQuant) else qp


def stream_ids(qp):
    """The per-block stream index of a StreamQuant, else None (the rate
    tables then hold one stream)."""
    return qp.sid if isinstance(qp, StreamQuant) else None


def tx_log_scale(tx_size: int) -> int:
    """av1_get_tx_scale: 0 (<=16pt), 1 (32pt), 2 (64pt) by square-up size."""
    up = int(cc.tx_size_sqr_up[tx_size])
    return max(0, up - cc.TX_16X16)


@functools.lru_cache(maxsize=None)
def _dc_select(h: int, w: int, device) -> torch.Tensor:
    """(H, W) bool, True at the DC position (row 0, col 0); shared,
    never written."""
    sel = torch.zeros((h, w), dtype=torch.bool, device=device)
    sel[0, 0] = True
    return sel


def _pick(arr: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """(2,) DC/AC constants -> (H, W) field; (B, 2) per-block rows (the
    adaptive-quantization path) -> (B, H, W)."""
    if arr.dim() == 2:
        return torch.where(sel, arr[:, 0, None, None], arr[:, 1, None, None])
    return torch.where(sel, arr[0], arr[1])


def quantize(coeffs: torch.Tensor, qp: QuantParams, tx_size: int):
    """Quantize batched coefficient blocks.

    coeffs: (B, H, W) int32 in the transform domain (coded region);
    qp: QuantParams of int32 (2,) tensors on the coeffs' device, or of
    (B, 2) rows, one per block, or a StreamQuant.
    Returns (qcoeff, dqcoeff), each (B, H, W) int32; dqcoeff is the
    normative dequantized value, so inv_txfm2d_add(dqcoeff, ...) is the
    decoder's reconstruction.  All products stay below 2^31: |tmp| is
    clipped to 32767, |quant| <= 2^15 and quant_shift <= 2^14."""
    if isinstance(qp, StreamQuant):
        qp = qp.rows()
    log_scale = tx_log_scale(tx_size)
    _, h, w = coeffs.shape
    sel = _dc_select(h, w, coeffs.device)
    zbin = _pick(qp.zbin, sel)
    rnd = _pick(qp.round, sel)
    if log_scale:
        zbin = (zbin + (1 << (log_scale - 1))) >> log_scale
        rnd = (rnd + (1 << (log_scale - 1))) >> log_scale
    quant = _pick(qp.quant, sel)
    qshift = _pick(qp.quant_shift, sel)
    deq = _pick(qp.dequant, sel)

    neg = coeffs < 0
    abs_c = coeffs.abs()
    tmp = torch.clamp(abs_c + rnd, -32768, 32767)
    tmp32 = ((((tmp * quant) >> 16) + tmp) * qshift) >> (16 - log_scale)
    tmp32 = torch.where(abs_c >= zbin, tmp32, 0)
    dq = (tmp32 * deq) >> log_scale
    return torch.where(neg, -tmp32, tmp32), torch.where(neg, -dq, dq)


def dequant_field(qp: QuantParams, h: int, w: int) -> torch.Tensor:
    """(1, h, w) per-position dequant steps (DC at [0,0], AC elsewhere),
    or (B, h, w) when qp carries per-block rows."""
    f = _pick(qp.dequant, _dc_select(h, w, qp.dequant.device))
    return f if f.dim() == 3 else f[None]


def dequantize(qcoeff: torch.Tensor, qp: QuantParams, tx_size: int):
    """Normative dequant of levels (decoder side / verification)."""
    log_scale = tx_log_scale(tx_size)
    _, h, w = qcoeff.shape
    deq = _pick(qp.dequant, _dc_select(h, w, qcoeff.device))
    mag = (qcoeff.abs() * deq) >> log_scale
    return torch.where(qcoeff < 0, -mag, mag)
