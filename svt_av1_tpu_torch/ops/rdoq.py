"""RDOQ, rate-distortion optimized quantization (the ``rdoq`` override,
off at every preset), on batched blocks.

Port of svt_av1_tpu/ops/rdoq.py.  After the uniform quantizer, levels are
adjusted where the modelled cost distortion + lambda * rate drops:

1. level-down: every coefficient with level >= 2 tries level - 1; the
   decisions are independent (no interior zero is made, so the scan
   contexts stay as they are) and run as one vectorized step;
2. eob truncation: the cheapest end of block under the model, in closed
   form from prefix sums of the keep / zero costs along the scan order,
   picked by an argmin (the first index on equal costs).

Rate comes from RDOQ's level + eob bundle (rate_est.rdoq_tables_for_qindex),
distortion from the transform-domain proxy the MD steps use.  The levels
stay normative: dqcoeff is the decoder's dequantization of them.

Float32 as in the reference, in the reference's order of operations: the
costs round as XLA's fused multiply-adds do (one rounding of a * b + c,
computed here in float64: the product of two float32 values is exact
there), and the prefix sums follow XLA's blocked scan of a reduce_window
(sequential sums within blocks of 16 along the scan, then the running
totals of the blocks, scanned the same way, added to each block).  Every
op is elementwise, so the card and the CPU round alike.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from svt_av1_tpu_torch.codec import tables as tb
from svt_av1_tpu_torch.ops import quant

MAX_LEVEL = 63    # the level table covers |level| 0..MAX_LEVEL
_SCAN_BLOCK = 16  # XLA's block length for a rewritten cumulative sum


@functools.lru_cache(maxsize=None)
def _scan_for(tx_size: int, tx_type: int) -> np.ndarray:
    return np.asarray(tb.get_scan(tx_size, tx_type), np.int32)


@functools.lru_cache(maxsize=None)
def _scan_on(tx_size: int, tx_type: int, device):
    """(scan, its inverse) as int64 tensors on ``device``: coefficient
    index of each scan position, scan position of each coefficient."""
    scan = _scan_for(tx_size, tx_type).astype(np.int64)
    inv = np.empty_like(scan)
    inv[scan] = np.arange(scan.shape[0])
    return (torch.as_tensor(scan, device=device),
            torch.as_tensor(inv, device=device))


def _level_bits(l, level_tbl):
    """Per-level bit cost from the level table (level_tbl[0]: a zero
    before the eob; zeros past it are priced by the eob pass)."""
    return level_tbl[l.clamp(max=MAX_LEVEL).long()]


def _fma(a, b, c):
    """a * b + c rounded once to float32 (a fused multiply-add); a may be
    a Python float that float32 holds exactly."""
    a = a.double() if torch.is_tensor(a) else a
    return (a * b.double() + c.double()).to(torch.float32)


def _cumsum_xla(x):
    """Inclusive prefix sums of (B, n) float32 along dim 1, rounded as
    XLA's blocked scan rounds them (see the module docstring)."""
    b, n = x.shape
    k = _SCAN_BLOCK
    if n <= k:
        out = x.clone()
        for i in range(1, n):
            out[:, i] = out[:, i - 1] + x[:, i]
        return out
    m = -(-n // k)
    r = torch.zeros((b, m, k), dtype=x.dtype, device=x.device)
    r.reshape(b, m * k)[:, :n] = x
    for i in range(1, k):
        r[:, :, i] = r[:, :, i - 1] + r[:, :, i]
    tot = _cumsum_xla(r[:, :, -1].contiguous())
    r[:, 1:] = r[:, 1:] + tot[:, :-1, None]
    return r.reshape(b, m * k)[:, :n]


def optimize_levels(coeffs, qcoeff, deq_field, tx_size: int, tx_type: int,
                    tbl, lam, s2: float):
    """Optimize the quantized levels of a batch of blocks.

    coeffs: (B, n, n) int32 transform coefficients (before the
    quantizer); qcoeff: (B, n, n) int32 levels of the uniform quantizer;
    deq_field: (B|1, n, n) int32 dequant step per position
    (quant.dequant_field); tbl: float32 (64 + n*n + 1,) bundle, level
    costs then eob-position costs (rate_est.rdoq_tables_for_qindex);
    lam: float32 0-d or (B,) lambda tensor; s2: float32 factor from
    coefficient-domain to pixel SSE.  Returns (qcoeff', dqcoeff'), the
    adjusted levels and their normative dequantization, (B, n, n) int32."""
    b, n, _ = qcoeff.shape
    nn = n * n
    dev = qcoeff.device
    log_scale = quant.tx_log_scale(tx_size)
    scan, inv = _scan_on(tx_size, tx_type, dev)
    level_tbl = tbl[:MAX_LEVEL + 1]
    eob_tbl = tbl[MAX_LEVEL + 1:MAX_LEVEL + 2 + nn]
    # all costs on magnitudes: the quantizer keeps the sign, so
    # |c - sign * dq| == ||c| - dq|
    c = coeffs.reshape(b, nn)[:, scan].abs().to(torch.float32)
    q = qcoeff.reshape(b, nn)[:, scan]
    dqv = deq_field.reshape(deq_field.shape[0], nn)[:, scan]
    lamc = lam[:, None] if lam.dim() else lam
    s2 = float(np.float32(s2))

    def cost(lv, dqlv):
        err = c - dqlv
        return _fma(s2, err * err, lamc * _level_bits(lv, level_tbl))

    l = q.abs()
    s = q.sign()
    dq = (l * dqv) >> log_scale
    l1 = (l - 1).clamp(min=0)
    dq1 = (l1 * dqv) >> log_scale

    # pass 1: independent level-down where l >= 2
    down = (l >= 2) & (cost(l1, dq1) < cost(l, dq))
    l = torch.where(down, l1, l)
    dq = torch.where(down, dq1, dq)

    # pass 2: the exact eob under the model,
    # cost(eob=k) = sum_{i<k} keep_i + sum_{i>=k} zero_i + lam * eob_tbl[k]
    keep = cost(l, dq)
    zero = s2 * c * c
    sums = _cumsum_xla(torch.cat([keep, zero]))
    pad = torch.zeros((2 * b, 1), dtype=torch.float32, device=dev)
    sums = torch.cat([pad, sums], dim=1)
    ka, za = sums[:b], sums[b:]
    cost_k = _fma(lamc, eob_tbl[None, :], ka + (za[:, -1:] - za))
    # legal eob: 0 (an all-zero block) or just past a nonzero level
    legal = torch.cat([torch.ones((b, 1), dtype=torch.bool, device=dev),
                       l > 0], dim=1)
    k_best = torch.where(legal, cost_k, float("inf")).argmin(dim=1)
    keep_m = torch.arange(nn, device=dev)[None, :] < k_best[:, None]
    l = torch.where(keep_m, l, 0)
    q_scan = s * l
    dq_scan = s * ((l * dqv) >> log_scale)
    return (q_scan[:, inv].reshape(b, n, n).to(qcoeff.dtype),
            dq_scan[:, inv].reshape(b, n, n).to(qcoeff.dtype))
