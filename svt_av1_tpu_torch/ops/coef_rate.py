"""Context-exact transform-block rate estimation (PyTorch).

Port of svt_av1_tpu/ops/coef_rate.py: every quantized coefficient is
priced with the context model the entropy coder uses — base-level
context from the 5-neighbor magnitude sum, base-range context from the
3-neighbor sum, eob-position class and the golomb tail — reading
per-symbol bit costs from small tables (codec/rate_est.py builds them
from a CDF state).  Gathers from those tables clamp their indices
explicitly (the reference's ``jnp.take(mode="clip")``).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch


class CoefTables(NamedTuple):
    """Per-(tx_size, plane) bit-cost tables (float32 tensors).

    base:     (42, 4)  coeff_base symbol bits per nz-map context
    base_eob: (4, 3)   coeff_base_eob symbol bits per eob-position class
    br:       (21, 4)  coeff_br (base-range) symbol bits per br context
    eob:      (ncoeffs + 1,) total eob-position signaling bits per eob
              value; [0] unused
    skip:     (2,) [txb_skip=0 (coded) bits, txb_skip=1 (skip) bits]
    dc_sign:  ()  mean DC-sign symbol bits (ctx 0)
    """
    base: torch.Tensor
    base_eob: torch.Tensor
    br: torch.Tensor
    eob: torch.Tensor
    skip: torch.Tensor
    dc_sign: torch.Tensor

    def to(self, device) -> "CoefTables":
        """The same tables as float32 tensors on ``device`` (numpy or
        tensor fields accepted)."""
        return CoefTables(*(torch.as_tensor(
            np.asarray(a, np.float32) if not isinstance(a, torch.Tensor)
            else a).to(device=device, dtype=torch.float32) for a in self))


def _statics(n: int):
    """Static (numpy) context maps for an (n, n) 2-D-class txb:
    (scan-position map, nz-ctx offset map, br region offsets,
    eob-position class per eob value)."""
    from svt_av1_tpu_torch.codec import constants as cc
    from svt_av1_tpu_torch.codec import tables as tb
    tx_size = {4: cc.TX_4X4, 8: cc.TX_8X8, 16: cc.TX_16X16,
               32: cc.TX_32X32}[n]
    scan = np.asarray(tb.get_scan(tx_size, cc.DCT_DCT))
    pos = np.zeros(scan.shape[0], np.int32)
    pos[scan] = np.arange(scan.shape[0], dtype=np.int32)
    pos = pos.reshape(n, n)
    off = tb.nz_map_ctx_offset(tx_size).reshape(n, n).astype(np.int32)
    rr, cmat = np.mgrid[0:n, 0:n]
    br_off = np.where((rr < 2) & (cmat < 2), 7, 14).astype(np.int32)
    br_off[0, 0] = 0
    hw = n * n
    e = np.arange(hw + 1, dtype=np.int64)
    si = e - 1
    ectx = np.where(si <= 0, 0,
                    np.where(si <= hw // 8, 1,
                             np.where(si <= hw // 4, 2, 3))).astype(np.int32)
    return pos, off, br_off, ectx


@functools.lru_cache(maxsize=None)
def _statics_on(n: int, device):
    """``_statics(n)`` as device tensors, built once per (n, device)."""
    return tuple(torch.as_tensor(a, device=device) for a in _statics(n))


def _lut(table: torch.Tensor, idx: torch.Tensor, sid=None) -> torch.Tensor:
    """Gather from a small flat table, indices clamped into range.  With
    ``sid`` (the (B,) stream of each block of idx (B, ...)), ``table`` has
    a leading stream axis and each block reads its stream's table."""
    if sid is None:
        flat = table.reshape(-1)
        return flat[idx.clamp(0, flat.numel() - 1).long()]
    flat = table.reshape(table.shape[0], -1)
    n = flat.shape[1]
    s = sid.reshape((-1,) + (1,) * (idx.dim() - 1))
    return flat.reshape(-1)[idx.clamp(0, n - 1).long() + s * n]


def stack_tables(tables) -> CoefTables:
    """The CoefTables of S streams stacked field-wise (a leading stream
    axis), as the reference stacks its per-stream rate pytrees."""
    return CoefTables(*(torch.stack(f) for f in zip(*tables)))


def _nsum(p: torch.Tensor, n: int, offs) -> torch.Tensor:
    """Sum of the (n, n) windows of a bottom/right zero-padded plane at
    the given (row, col) offsets."""
    out = None
    for r, c in offs:
        t = p[:, r:r + n, c:c + n]
        out = t if out is None else out + t
    return out


def txb_bits_exact(qabs: torch.Tensor, t: CoefTables, n: int, sid=None
                   ) -> torch.Tensor:
    """Context-exact coded bits for a batch of 2-D-class txbs.

    qabs: (B, n, n) int32 |quantized levels| in raster order.  sid: the
    (B,) stream of each block when ``t`` holds S streams' tables
    (``stack_tables``).
    Returns (B,) float32 bits including the txb_skip flag (the skip cost
    for all-zero blocks).  Exact vs the range coder up to the DC sign
    (priced at the ctx-0 mean) and the coder's 1/32768 probability
    quantization."""
    pos, off, broff, ectx_tbl = _statics_on(n, qabs.device)
    lv3 = torch.clamp(qabs, max=3)
    p3 = torch.nn.functional.pad(lv3, (0, 2, 0, 2))
    mag = _nsum(p3, n, ((0, 1), (1, 0), (1, 1), (0, 2), (2, 0)))
    ctxb = torch.clamp((mag + 1) >> 1, max=4) + off
    ctxb[:, 0, 0] = 0                         # DC short-circuits to 0

    nzm = qabs > 0
    eob = torch.where(nzm, pos + 1, 0).amax(dim=(1, 2))        # (B,)
    e3 = eob[:, None, None]
    before = pos < (e3 - 1)
    is_eob = pos == (e3 - 1)

    sym = lv3
    base_cost = _lut(t.base, ctxb * 4 + sym, sid)
    base_sum = torch.where(before, base_cost, 0.0).sum(dim=(1, 2))

    # the eob coefficient codes coeff_base_eob (symbols level-1 in 0..2)
    ectx = ectx_tbl[eob.clamp(0, ectx_tbl.numel() - 1).long()]
    sym_e = torch.where(is_eob, sym, 0).sum(dim=(1, 2),
                                            dtype=torch.int32) - 1
    eob_coef = _lut(t.base_eob, ectx * 3 + sym_e.clamp(0, 2), sid)

    # base-range rounds (level >= 3); same ctx every round
    lv15 = torch.clamp(qabs, max=15)
    p15 = torch.nn.functional.pad(lv15, (0, 1, 0, 1))
    magr = _nsum(p15, n, ((0, 1), (1, 0), (1, 1)))
    ctxr = torch.clamp((magr + 1) >> 1, max=6) + broff
    brr = torch.clamp(qabs - 3, 0, 12)
    full = brr // 3
    extra = brr - 3 * full
    br_cost = (full.to(torch.float32) * _lut(t.br, ctxr * 4 + 3, sid)
               + torch.where(brr < 12, _lut(t.br, ctxr * 4 + extra, sid),
                             0.0))
    br_sum = torch.where(qabs >= 3, br_cost, 0.0).sum(dim=(1, 2))

    # golomb tail (level > 14): write_golomb(level-15) = 2*len(l-14)-1
    gl = torch.where(
        qabs > 14,
        2.0 * torch.floor(torch.log2(torch.clamp(
            qabs - 14, min=1).to(torch.float32))) + 1.0,
        0.0)
    gl_sum = gl.sum(dim=(1, 2))

    # signs: 1 bit each; DC re-priced with the ctx-0 mean symbol cost
    nz_cnt = nzm.sum(dim=(1, 2)).to(torch.float32)
    dc_nz = nzm[:, 0, 0]
    dc_sign, skip = t.dc_sign, t.skip
    if sid is not None:
        dc_sign, skip = dc_sign[sid], skip[sid].T
    sign_sum = nz_cnt + torch.where(dc_nz, dc_sign - 1.0, 0.0)

    eob_bits = _lut(t.eob, eob, sid)
    coded = (skip[0] + eob_bits
             + base_sum + eob_coef + br_sum + gl_sum + sign_sum)
    return torch.where(eob > 0, coded, skip[1])
