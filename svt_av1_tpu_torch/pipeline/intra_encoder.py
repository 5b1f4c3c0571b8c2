"""Intra (key) frame encoder: wave-batched mode decision + reconstruction.

Port of svt_av1_tpu/pipeline/intra_encoder.py for the all-intra slice
(fixed 16x16 luma / 8x8 chroma blocks; the preset's luma modes — up to
all eleven, with the five filter-intra pseudo-modes at M0-M4 —, at M0-M8
crossed with the tx-type search set and the angle-delta refinements of
the directional modes; chroma DC/V/H/SMOOTH with their implied transform
types plus the CfL candidate; exact palettes on screen content; per-block
quantizers; RDOQ after the quantizer where the ``rdoq`` override asks).
The wave steps also take 32x32 and 64x64 blocks, for the
variable-partition program (pipeline/varpart.py).

The frame's 16x16 blocks are batched along 2:1 wavefronts (wave
k = 2*by + bx): every neighbor a block reads lies in an earlier wave.
Each wave runs one luma step (gather neighbors -> predict every
candidate -> transform + quantize -> rate + distortion -> pick ->
normative inverse -> scatter) and one joint U+V chroma step.  The
reference vmaps its frame program over a batch of frames; here the frame
axis is written out, so a wave's batch is F frames x maxb slots (x
candidates), and the wave loop is a plain Python loop of eager PyTorch
ops.  Slots past a wave's end are computed like the reference's and never
written back.

Recon planes are updated in place (``_scatter_blocks``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from svt_av1_tpu_torch import device as device_mod
from svt_av1_tpu_torch.codec import constants as cc
from svt_av1_tpu_torch.codec import palette as pal
from svt_av1_tpu_torch.codec import tables as tb
from svt_av1_tpu_torch.codec.rate_est import (exact_rates_override,
                                               md_rate_args)
from svt_av1_tpu_torch.codec.syntax import (MAX_TX, BlockDecision,
                                             _chroma_tx_type,
                                             _chroma_tx_type_inter,
                                             max_chroma_tx_size)
from svt_av1_tpu_torch.ops import dlf, fused_txq, intra, quant
from svt_av1_tpu_torch.ops import rdoq as rdoq_mod
from svt_av1_tpu_torch.ops import interintra as ii_ops
from svt_av1_tpu_torch.ops import transforms as tf
from svt_av1_tpu_torch.ops.coef_rate import CoefTables, txb_bits_exact

# luma modes of presets M5-M8 (M9-M11 use the first six, M12/M13 the
# first four); M3-M4 add D45 and D67, M0-M2 D203 too (ALL_MODES), and
# M0-M4 the filter-intra pseudo-modes FI_MODE_BASE + 0..4
MODES = (cc.DC_PRED, cc.V_PRED, cc.H_PRED, cc.SMOOTH_PRED, cc.PAETH_PRED,
         cc.D135_PRED, cc.D113_PRED, cc.D157_PRED)
ALL_MODES = MODES + (cc.D45_PRED, cc.D67_PRED, cc.D203_PRED)
FI_MODES = tuple(cc.FI_MODE_BASE + k for k in range(cc.FILTER_INTRA_MODES))
# chroma mode set; each uses its implied (unsignaled) transform type
UV_MODES = (cc.DC_PRED, cc.V_PRED, cc.H_PRED, cc.SMOOTH_PRED)
UV_TX_TYPES = (cc.DCT_DCT, cc.ADST_DCT, cc.DCT_ADST, cc.ADST_ADST)
# luma tx-type search set for 16x16 intra: the DTT4 members of the
# signalable EXT_TX_SET_DTT4_IDTX set (all share the default scan)
TX_SEARCH_SET = (cc.DCT_DCT, cc.ADST_ADST, cc.ADST_DCT, cc.DCT_ADST)
# angle-delta refinement per directional mode (spec MAX_ANGLE_DELTA=3,
# step 3 degrees); evaluated with DCT_DCT
ANGLE_DELTAS = (-3, -2, -1, 1, 2, 3)
BLK = 16
CBLK = 8
# cost added to a candidate that a block must not take
FORBID = 1e18


def pixel_dtype(bd: int) -> torch.dtype:
    """The dtype of recon planes on the device: uint8 at 8 bits, int16 at
    10 (samples up to 1023; torch's uint16 has few kernels).  The host
    copies of 10-bit planes are uint16, as the reference's are."""
    return torch.uint8 if bd == 8 else torch.int16


def source_planes(planes, bd: int, device):
    """Host source planes (uint8 or uint16 numpy, any leading axes) as
    tensors of ``pixel_dtype(bd)`` on ``device``."""
    dt = np.uint8 if bd == 8 else np.int16
    return [torch.from_numpy(np.ascontiguousarray(np.asarray(p).astype(
        dt, copy=False))).to(device) for p in planes]


def host_plane(t: torch.Tensor) -> np.ndarray:
    """A recon plane copied to the host: uint8 at 8 bits, uint16 at 10."""
    a = t.cpu().numpy()
    return a if a.dtype == np.uint8 else a.astype(np.uint16)


def cand_angle(mode: int, delta: int) -> int:
    """Prediction angle of a candidate (0 = non-directional)."""
    if cc.V_PRED <= mode <= cc.D67_PRED:
        return intra.MODE_TO_ANGLE[mode] + 3 * delta
    return 0


def expand_tx_cands(modes, angle_deltas=False):
    """Candidate expansion for luma 16x16 MD: (cand_modes, cand_txs)
    where each cand_mode is (mode, angle_delta).  Tx search crosses the
    search set with the delta-0 modes; angle-delta refinements run with
    DCT_DCT only."""
    reg = [m for m in modes if m < cc.FI_MODE_BASE]
    fi = [m for m in modes if m >= cc.FI_MODE_BASE]
    cand_modes = [(m, 0) for t in TX_SEARCH_SET for m in reg]
    cand_txs = [t for t in TX_SEARCH_SET for _ in reg]
    # filter-intra candidates run once, DCT only
    cand_modes += [(m, 0) for m in fi]
    cand_txs += [cc.DCT_DCT for _ in fi]
    modes = reg
    if angle_deltas:
        for m in modes:
            if not (cc.V_PRED <= m <= cc.D67_PRED):
                continue
            for d in ANGLE_DELTAS:
                cand_modes.append((m, d))
                cand_txs.append(cc.DCT_DCT)
    return tuple(cand_modes), tuple(cand_txs)


def _predict_cand(mode, delta, n, above, left, corner, above_ext, left_ext,
                  have_above, have_left, bd):
    """Prediction for one (mode, angle_delta) candidate; the zone comes
    from the final angle (spec §7.11.2).  Pseudo-modes >= FI_MODE_BASE
    are the filter-intra modes."""
    if mode >= cc.FI_MODE_BASE:
        return intra.filter_intra_pred(above, left, corner,
                                       mode - cc.FI_MODE_BASE, n, n, bd)
    angle = cand_angle(mode, delta)
    if angle and angle != 90 and angle != 180:
        if angle < 90:
            return intra.z1_pred(above_ext, n, n, angle)
        if angle > 180:
            return intra.z3_pred(left_ext, n, n, angle)
        return intra.z2_pred(above, left, corner, n, n, angle)
    return intra.predict(mode, above, left, corner, n, n,
                         have_above=have_above, have_left=have_left, bd=bd)


@functools.lru_cache(maxsize=None)
def _scan_pos(tx_size: int) -> np.ndarray:
    """(n, n) scan position of each coefficient (inverse default scan)."""
    scan = np.asarray(tb.get_scan(tx_size, cc.DCT_DCT))
    pos = np.zeros(scan.shape[0], np.int32)
    pos[scan] = np.arange(scan.shape[0], dtype=np.int32)
    n = int(np.sqrt(scan.shape[0]))
    return pos.reshape(n, n)


@functools.lru_cache(maxsize=None)
def _scan_pos_on(tx_size: int, device) -> torch.Tensor:
    return torch.as_tensor(_scan_pos(tx_size), device=device)


@functools.lru_cache(maxsize=None)
def _ids_on(ids: tuple, device, dtype=torch.int32) -> torch.Tensor:
    """A tuple of constants (mode ids, candidate indices, flags) as a
    tensor, built once per device."""
    return torch.as_tensor(ids, dtype=dtype, device=device)


def _txb_bits(qcoeff_abs, coef_bits, base, eob_tbl, pos, sid=None):
    """Transform-block rate: the context-exact model when ``coef_bits``
    is a CoefTables bundle (presets with exact_rates: M5-M10), else the
    analytic curve (M11-M13):
    2*log2(1+l) + 1 per nonzero level, the zero-symbol cost for zeros
    before eob, the eob-position cost and the txb flag.  sid: the (B,)
    stream of each block when the tables hold a stream batch's
    (rate_est.stack_rate_args; ``base`` is then (S,))."""
    if isinstance(coef_bits, CoefTables):
        return txb_bits_exact(qcoeff_abs, coef_bits, qcoeff_abs.shape[-1],
                              sid)
    nzm = qcoeff_abs > 0
    eob = torch.where(nzm, pos + 1, 0).amax(dim=(1, 2))
    af = qcoeff_abs.to(torch.float32)
    nz_cnt = nzm.sum(dim=(1, 2)).to(torch.float32)
    nz_bits = 2.0 * torch.log2(1.0 + af).sum(dim=(1, 2)) + nz_cnt
    zeros_before = eob.to(torch.float32) - nz_cnt
    if sid is not None:
        return (nz_bits + zeros_before * coef_bits[sid, 0]
                + eob_tbl[sid, eob.long()] + base[sid])
    return nz_bits + zeros_before * coef_bits[0] + eob_tbl[eob.long()] + base


def _morton(r: int, c: int) -> int:
    """z-order (coding order) index of a block within its superblock."""
    return (((r & 2) << 2) | ((c & 2) << 1) | ((r & 1) << 1) | (c & 1))


def tr_bl_avail(by: int, bx: int, gh: int, gw: int, m: int = 4,
                col_lo: int = 0, col_hi: int = 0):
    """(top-right, bottom-left) reconstructed-sample availability for a
    square block in the 64x64-SB z-order (a neighbor is available iff its
    coding order precedes ours).  (by, bx) index the block's own-size
    grid; ``m`` is blocks per SB side.  col_lo/col_hi bound the block's
    tile column in the same grid units (a tile clamps prediction as the
    frame edge does; 0/0 = the whole frame)."""
    if col_hi <= 0:
        col_hi = gw
    r, c = by & (m - 1), bx & (m - 1)
    if by == 0 or bx + 1 >= col_hi:
        tr = False
    elif r == 0:
        tr = True
    elif c == m - 1:
        tr = False
    else:
        tr = _morton(r - 1, c + 1) < _morton(r, c)
    if bx <= col_lo or by + 1 >= gh:
        bl = False
    elif c == 0:
        bl = r < m - 1
    elif r == m - 1:
        bl = False
    else:
        bl = _morton(r + 1, c - 1) < _morton(r, c)
    return tr, bl


def _wave_schedule(gh: int, gw: int, maxb: int):
    """2:1 wavefront: wave k = 2*by + bx.  Every neighbor a block reads
    (above: k-2, left: k-1, above-left: k-3, top-right: k-1) lands in a
    strictly earlier wave."""
    waves = []
    for k in range(2 * gh + gw - 2):
        blocks = [(by, k - 2 * by)
                  for by in range(max(0, (k - gw + 1 + 1) // 2),
                                  min(gh, k // 2 + 1))
                  if 0 <= k - 2 * by < gw]
        if not blocks:
            continue
        for i in range(0, len(blocks), maxb):
            waves.append(blocks[i:i + maxb])
    return waves


def _natural_maxb(gh: int, gw: int) -> int:
    """Largest wave size under the 2:1 slope (no slot padding needed)."""
    return max(1, min(gh, (gw + 1) // 2))


def _tile_bounds_of(bx: int, tile_starts) -> Tuple[int, int]:
    """(col_lo, col_hi) of the tile containing block column bx;
    tile_starts: ascending block-column starts, the first 0."""
    lo, hi = 0, 10 ** 9
    for s in tile_starts:
        if s <= bx:
            lo = s
        else:
            hi = s
            break
    return lo, hi


def _schedule_arrays(gh, gw, maxb, tile_starts=(0,)):
    """Wave schedule + per-slot availability, each (n_waves, maxb).
    tile_starts: the block-column starts of the tile columns (a tile
    clamps left, top-right and bottom-left availability as the frame
    edge does)."""
    waves = _wave_schedule(gh, gw, maxb)
    nw = len(waves)
    bys = np.zeros((nw, maxb), np.int32)
    bxs = np.zeros((nw, maxb), np.int32)
    valid = np.zeros((nw, maxb), bool)
    trs = np.zeros((nw, maxb), bool)
    bls = np.zeros((nw, maxb), bool)
    hls = np.zeros((nw, maxb), bool)
    starts = set(tile_starts)
    for i, wave in enumerate(waves):
        nb = len(wave)
        bys[i, :nb] = [b[0] for b in wave]
        bxs[i, :nb] = [b[1] for b in wave]
        valid[i, :nb] = True
        for j, (by, bx) in enumerate(wave):
            lo, hi = _tile_bounds_of(bx, tile_starts)
            trs[i, j], bls[i, j] = tr_bl_avail(by, bx, gh, gw, col_lo=lo,
                                               col_hi=min(hi, gw))
            hls[i, j] = bx > 0 and bx not in starts
    return waves, bys, bxs, valid, trs, bls, hls


class WaveSlots(NamedTuple):
    """One wave's batch over F frames (batch element b = f*maxb + j), as
    device tensors: frame index ``fi``, block coordinates ``by``/``bx``
    (in 16x16 units), neighbor availability ``ha``/``hl`` (above, left)
    and ``tr``/``bl`` (top-right, bottom-left), the raster id ``bid``
    (f*gh*gw + by*gw + bx) of every slot, the batch indices ``sel`` of
    the slots that hold a block, and their raster ids ``rid``."""
    fi: torch.Tensor
    by: torch.Tensor
    bx: torch.Tensor
    ha: torch.Tensor
    hl: torch.Tensor
    tr: torch.Tensor
    bl: torch.Tensor
    bid: torch.Tensor
    sel: torch.Tensor
    rid: torch.Tensor


@functools.lru_cache(maxsize=16)
def _device_schedule(gh: int, gw: int, nf: int, device, tile_starts=(0,)):
    """The static wave schedule for an F-frame batch, as WaveSlots, with
    the availability of the tile columns that start at ``tile_starts``
    (block columns)."""
    maxb = _natural_maxb(gh, gw)
    _, bys, bxs, valid, trs, bls, hls = _schedule_arrays(gh, gw, maxb,
                                                         tile_starts)
    t = lambda a, dt=torch.int64: torch.as_tensor(np.ascontiguousarray(a),
                                                  dtype=dt, device=device)
    fi = np.repeat(np.arange(nf), maxb)
    out = []
    for i in range(bys.shape[0]):
        by = np.tile(bys[i], nf)
        bx = np.tile(bxs[i], nf)
        va = np.tile(valid[i], nf)
        sel = np.nonzero(va)[0]
        bid = fi * gh * gw + by * gw + bx
        flag = lambda a: t(np.tile(a, nf) & va, torch.bool)
        out.append(WaveSlots(t(fi), t(by), t(bx), t((by > 0) & va,
                                                      torch.bool),
                             flag(hls[i]), flag(trs[i]), flag(bls[i]),
                             t(bid), t(sel), t(bid[sel])))
    return out


def _gather_block(plane, fi, ys, xs, h, w):
    """(B, h, w) windows of an (F, H, W) plane at per-slot frame index
    and top-left offsets.  Starts are clamped so that each window lies
    inside the plane, as dynamic_slice does in the reference."""
    _, hh, ww = plane.shape
    ys = ys.clamp(0, hh - h)
    xs = xs.clamp(0, ww - w)
    rows = ys[:, None, None] + torch.arange(h, device=plane.device)[:, None]
    cols = xs[:, None, None] + torch.arange(w, device=plane.device)
    return plane[fi[:, None, None], rows, cols]


def _scatter_blocks(plane, blocks, fi, ys, xs, sel):
    """Write (B, n, n) blocks into an (F, H, W) plane in place, for the
    batch slots ``sel`` only (the reference's dynamic_update_slice loop
    as one index_put_)."""
    n = blocks.shape[-1]
    ar = torch.arange(n, device=plane.device)
    f = fi[sel][:, None, None]
    rows = ys[sel][:, None, None] + ar[:, None]
    cols = xs[sel][:, None, None] + ar
    plane.index_put_((f.expand(-1, n, n), rows.expand(-1, n, n),
                      cols.expand(-1, n, n)), blocks[sel])


def _gather_neighbors(recon, fi, ys, xs, n, have_above, have_left, bd=8):
    """Batched neighbor prep with the spec's substitution rules
    (reconintra build_intra_predictors semantics).

    recon: (F, H, W) int32; fi/ys/xs: (B,) frame index and top-left
    coordinates; n: block dim.  Returns (above (B,n), left (B,n),
    corner (B,))."""
    base = 1 << (bd - 1)
    ay = (ys - 1).clamp(min=0)
    lx = (xs - 1).clamp(min=0)
    above_raw = _gather_block(recon, fi, ay, xs, 1, n)[:, 0, :]
    left_raw = _gather_block(recon, fi, ys, lx, n, 1)[:, :, 0]
    corner_raw = _gather_block(recon, fi, ay, lx, 1, 1)[:, 0, 0]
    above_ref0 = above_raw[:, 0]
    left_ref0 = left_raw[:, 0]
    ha = have_above[:, None]
    hl = have_left[:, None]
    # left: real | above_ref[0] | base+1
    left = torch.where(hl, left_raw,
                       torch.where(ha, above_ref0[:, None], base + 1))
    # above: real | left_ref[0] | base-1
    above = torch.where(ha, above_raw,
                        torch.where(hl, left_ref0[:, None], base - 1))
    corner = torch.where(have_above & have_left, corner_raw,
                         torch.where(have_above, above_ref0,
                                     torch.where(have_left, left_ref0,
                                                 base)))
    return above, left, corner


def _gather_ext_neighbors(recon, fi, ys, xs, n, above, left, tr_avail,
                          bl_avail, edge=None):
    """Extended (2n+1) above/left arrays for the zone-1/3 directional
    candidates: the second half is read from recon where the top-right /
    bottom-left block is available, else it repeats the last sample.

    edge: (max_x, max_y), the frame's last column and row (the plane's
    by default; the varpart program's plane is padded to whole
    superblocks, and a 64x64 leaf's top-right superblock may stick out
    of the frame): available samples past them repeat the frame's last
    one (spec 7.11.2, Min(maxX, x + i))."""
    _, hh, ww = recon.shape
    max_x, max_y = edge or (ww - 1, hh - 1)
    ay = (ys - 1).clamp(min=0)
    lx = (xs - 1).clamp(min=0)
    ar = torch.arange(n, device=recon.device)
    tr = recon[fi[:, None], ay[:, None],
               (xs[:, None] + n + ar).clamp(max=min(max_x, ww - 1))]
    bl = recon[fi[:, None],
               (ys[:, None] + n + ar).clamp(max=min(max_y, hh - 1)),
               lx[:, None]]
    tr = torch.where(tr_avail[:, None], tr, above[:, n - 1:n])
    above_ext = torch.cat([above, tr, tr[:, -1:]], dim=1)
    bl = torch.where(bl_avail[:, None], bl, left[:, n - 1:n])
    left_ext = torch.cat([left, bl, bl[:, -1:]], dim=1)
    return above_ext, left_ext


def _rd_step(recon, src, fi, ys, xs, sel, have_above, have_left, qp, lam,
             modes, rates, bd=8, tx_types=None, tr_avail=None,
             bl_avail=None, inter=None, return_index=False, n=BLK,
             tx_size=cc.TX_16X16, no_write=False, edge=None, rdoq_tbl=None):
    """One luma wave step over n x n blocks (16x16 by default): every
    candidate of every slot through predict -> transform + quantize ->
    rate + distortion, the cheapest per slot kept, its normative
    reconstruction written into ``recon`` (in place) for the slots
    ``sel``.

    recon/src: (F, H, W) int32; fi/ys/xs: (B,) frame index and pixel
    coordinates; qp: QuantParams tensors, (2,) each, or (B, 2) rows of
    per-block quantizers (adaptive quantization: the delta-q key frame),
    or a StreamQuant (a batch of streams at their own qindices, whose
    rates are rate_est.stack_rate_args tables read by the block's
    stream); lam: float32 scalar tensor, or (B,) with per-block rows;
    modes: mode ids or (mode, angle_delta) pairs (filter-intra pseudo-modes
    >= FI_MODE_BASE included; they are dropped above 32x32, where the
    spec forbids them); rates: (coef_bits, txb_base, mode_bits, eob_tbl),
    mode_bits one per candidate, or None for the analytic proxy
    2*sum(log2(1+|l|)) + nonzeros + 8 (the varpart program's).
    tx_types: optional tx type per candidate (DCT_DCT when None).
    tr_avail/bl_avail: (B,) bool, needed when a candidate's angle lies
    in zone 1 or 3.  inter: optional (cost (B,), rec (B, n, n)) of a
    precomputed alternative per block (the palette candidate, pass B's
    inter candidate), taken wherever its cost beats the best intra
    candidate.  n/tx_size: the block size and its square transform
    (TX_64X64 codes a 32x32 coefficient region; the energy the
    projection drops is charged as distortion).  edge: the frame's last
    (column, row) where recon is padded past the frame (see
    _gather_ext_neighbors).  no_write: leave recon
    alone and return the winners' reconstruction instead.  Returns
    (best_mode (B,) int32 — the candidate index when ``return_index`` —,
    best_q (B, kh, kw) int32, recon[, choose (B,) bool when ``inter``]),
    with recon replaced by the winners' (B, n, n) reconstruction and the
    best cost (B,) appended when ``no_write``.

    With one tx type, DCT_DCT at TX_16X16, and a frame quantizer, the
    transform + quantizer runs through ops/fused_txq: the hand-written
    CUDA kernel for tensors on the card, its plain version on the CPU
    (the reference takes its Pallas kernel under the same conditions on
    the TPU); a StreamQuant takes the kernel's per-row form; per-block
    quantizers take fwd_txfm2d + quantize, as in the reference.  With
    mixed tx types the candidates are grouped by type:
    one forward/quantize pass per distinct type over all its candidates,
    one inverse per distinct type on the winners.  Every filter-intra
    candidate comes from one batched wavefront pass.  rdoq_tbl: RDOQ's
    luma bundle (rate_est.md_rate_args()[7]); when given, the levels of
    every candidate go through ops/rdoq.optimize_levels after the
    quantizer (after K1 where K1 runs), before distortion and rate are
    measured, as in the reference."""
    dev = recon.device
    b = ys.shape[0]
    cands = [m if isinstance(m, tuple) else (m, 0) for m in modes]
    if n > 32 and any(m >= cc.FI_MODE_BASE for m, _ in cands):
        if rates is not None:
            raise ValueError("rate tables must match the filtered "
                             "candidate list")
        cands = [c for c in cands if c[0] < cc.FI_MODE_BASE]
    nm = len(cands)
    above, left, corner = _gather_neighbors(recon, fi, ys, xs, n,
                                            have_above, have_left, bd=bd)
    angles = [cand_angle(m, d) for m, d in cands]
    above_ext = left_ext = None
    if any(a and (a < 90 or a > 180) for a in angles):
        above_ext, left_ext = _gather_ext_neighbors(
            recon, fi, ys, xs, n, above, left, tr_avail, bl_avail, edge)
    src_blk = _gather_block(src, fi, ys, xs, n, n)
    stream_qp = isinstance(qp, quant.StreamQuant)
    per_block_qp = not stream_qp and qp.zbin.dim() == 2
    pred_cache = {}
    fi_list = sorted({m for m, _ in cands if m >= cc.FI_MODE_BASE})
    if fi_list:
        fi_all = intra.filter_intra_pred_multi(
            above, left, corner,
            tuple(m - cc.FI_MODE_BASE for m in fi_list), n, n, bd)
        for k, m in enumerate(fi_list):
            pred_cache[(m, 0)] = fi_all[k]
    for key in cands:
        if key not in pred_cache:
            pred_cache[key] = _predict_cand(
                key[0], key[1], n, above, left, corner, above_ext,
                left_ext, have_above, have_left, bd)
    # every candidate stacked on the batch axis: (nm, B, n, n)
    pred_all = torch.stack([pred_cache[key] for key in cands])
    resid_all = src_blk[None] - pred_all
    proj = tx_size == cc.TX_64X64

    def dist_of(coeffs, dq, resid, t):
        # transform-domain distortion: pixel SSE ~ s2 * coeff-error SSE;
        # the normative inverse runs only for the winner below
        s2 = float(np.float32(tf.coeff_sse_scale(tx_size, t)))
        err = coeffs.to(torch.float32) - dq.to(torch.float32)
        d = s2 * (err * err).sum(dim=(1, 2))
        if proj:
            # only a 32x32 coefficient subspace is coded: charge the
            # energy the projection throws away (Parseval)
            rf = resid.to(torch.float32)
            cf = coeffs.to(torch.float32)
            d = d + torch.clamp((rf * rf).sum(dim=(1, 2))
                                - s2 * (cf * cf).sum(dim=(1, 2)), min=0.0)
        return d

    def rd_opt(coeffs, qc, t, g):
        # RDOQ over g candidate-major copies of the batch
        return rdoq_mod.optimize_levels(
            coeffs, qc, quant.dequant_field(quant.repeat_rows(qp, g),
                                            *qc.shape[-2:]),
            tx_size, t, rdoq_tbl, lam.repeat(g) if lam.dim() else lam,
            float(np.float32(tf.coeff_sse_scale(tx_size, t))))

    same_tx = tx_types is None or len(set(tx_types)) == 1
    if same_tx:
        tx0 = cc.DCT_DCT if tx_types is None else tx_types[0]
        flat = resid_all.reshape(nm * b, n, n)
        if (tx0 == cc.DCT_DCT and tx_size == cc.TX_16X16
                and not per_block_qp):
            if stream_qp:
                coeffs, qcoeff_all, dq_all = fused_txq.fused_txq_rows(
                    flat, qp.repeat(nm))
            else:
                coeffs, qcoeff_all, dq_all = fused_txq.fused_txq(flat, qp)
        else:
            coeffs = tf.fwd_txfm2d(flat, tx0, tx_size)
            qcoeff_all, dq_all = quant.quantize(
                coeffs, quant.repeat_rows(qp, nm), tx_size)
        if rdoq_tbl is not None:
            qcoeff_all, dq_all = rd_opt(coeffs, qcoeff_all, tx0, nm)
        dist = dist_of(coeffs, dq_all, flat, tx0)
    else:
        uniq_tx = list(dict.fromkeys(tx_types))
        kk = n if not proj else 32
        qcoeff_all = torch.empty((nm, b, kk, kk), dtype=torch.int32,
                                 device=dev)
        dq_all = torch.empty_like(qcoeff_all)
        dist = torch.empty((nm, b), dtype=torch.float32, device=dev)
        for t in uniq_tx:
            idx = _ids_on(tuple(i for i, tt in enumerate(tx_types)
                                if tt == t), dev, torch.int64)
            g = idx.shape[0]
            res_t = resid_all[idx].reshape(g * b, n, n)
            coeffs_t = tf.fwd_txfm2d(res_t, t, tx_size)
            qc_t, dq_t = quant.quantize(
                coeffs_t, quant.repeat_rows(qp, g), tx_size)
            if rdoq_tbl is not None:
                qc_t, dq_t = rd_opt(coeffs_t, qc_t, t, g)
            qcoeff_all[idx] = qc_t.reshape(g, b, kk, kk)
            dq_all[idx] = dq_t.reshape(g, b, kk, kk)
            dist[idx] = dist_of(coeffs_t, dq_t, res_t, t).reshape(g, b)
        dist = dist.reshape(-1)
    kh, kw = qcoeff_all.shape[-2:]
    qcoeff_all = qcoeff_all.reshape(nm, b, kh, kw)
    dq_all = dq_all.reshape(nm, b, kh, kw)
    aq = qcoeff_all.abs().reshape(nm * b, kh, kw)
    if rates is None:
        # the analytic proxy of the light paths (varpart)
        bits = (torch.log2(1.0 + aq.to(torch.float32)).sum(dim=(1, 2))
                * 2.0 + (aq > 0).sum(dim=(1, 2)) + 8.0)
    else:
        coef_bits, txb_base, mode_bits, eob_tbl = rates
        if stream_qp:
            # a stream batch's tables: each block reads its stream's
            mb = mode_bits[qp.sid].T
            sid_all = qp.sid.repeat(nm)
        else:
            mb = mode_bits[:, None].expand(nm, b)
            sid_all = None
        bits = (_txb_bits(aq, coef_bits, txb_base[0], eob_tbl,
                          _scan_pos_on(tx_size, dev), sid_all)
                + mb.reshape(-1))
    # per-block lambdas follow the candidate-major (mode, block) stacking
    lam_flat = lam.repeat(nm) if lam.dim() else lam
    cost = (dist + lam_flat * bits).reshape(nm, b)
    # zone-3 candidates (angle > 180) read bottom-left recon, which the
    # wavefront has not written yet where the spec marks it available:
    # they stay legal only where encoder and decoder both repeat the
    # last left sample instead
    if bl_avail is not None and any(a > 180 for a in angles):
        z3 = _ids_on(tuple(a > 180 for a in angles), dev, torch.bool)
        cost = cost + torch.where(z3[:, None] & bl_avail[None, :],
                                  FORBID, 0.0)
    mi_best = cost.argmin(dim=0)                        # first minimum
    ar = torch.arange(b, device=dev)
    best_q = qcoeff_all[mi_best, ar]
    best_dq = dq_all[mi_best, ar]
    best_pred = pred_all[mi_best, ar]
    if same_tx:
        best_rec = tf.inv_txfm2d_add(best_dq, best_pred, tx0, tx_size,
                                     bd=bd)
    else:
        best_tx = _ids_on(tuple(tx_types), dev)[mi_best]
        best_rec = None
        for t in uniq_tx:
            r = tf.inv_txfm2d_add(best_dq, best_pred, t, tx_size, bd=bd)
            best_rec = r if best_rec is None else torch.where(
                (best_tx == t)[:, None, None], r, best_rec)
    if return_index:
        best_mode = mi_best.to(torch.int32)
    else:
        best_mode = _ids_on(tuple(m for m, _ in cands), dev)[mi_best]
    choose = None
    if inter is not None:
        inter_cost, inter_rec = inter
        choose = inter_cost < cost.amin(dim=0)
        best_rec = torch.where(choose[:, None, None], inter_rec, best_rec)
    if no_write:
        return best_mode, best_q, best_rec, cost.amin(dim=0)
    _scatter_blocks(recon, best_rec, fi, ys, xs, sel)
    if inter is not None:
        return best_mode, best_q, recon, choose
    return best_mode, best_q, recon


def _rd_step_chroma(recon_u, recon_v, src_u, src_v, fi, ys, xs, sel,
                    have_above, have_left, qp, lam, rates, bd=8,
                    luma_rec=None, cfl=False, inter=None, n=CBLK,
                    tx_size=cc.TX_8X8, uv_tx_types=UV_TX_TYPES,
                    no_write=False, rdoq_tbl=None):
    """Joint U+V mode decision for one wave (uv_mode is signaled once per
    block; the chroma transform type is implied by the mode).  Every
    (mode, plane) pair runs its forward transform, quantizer and the
    normative inverse; distortion is the true pixel SSE.  Writes the
    winners into recon_u/recon_v in place for the slots ``sel``.

    cfl (with luma_rec, the (B, 16, 16) reconstructed luma of the same
    blocks): a chroma-from-luma candidate — a least-squares alpha fit per
    plane, refined over alpha-1, alpha, alpha+1 by true RD cost —
    competes with the regular modes.

    inter: optional (choose (B,) bool, rec_u, rec_v) — the blocks whose
    luma step took the inter candidate (pass B of an inter frame) write
    its chroma recon instead.

    qp/lam: a frame quantizer and lambda, or (B, 2) / (B,) per-block rows
    (see _rd_step).

    n/tx_size: the chroma block size and transform (8x8 by default);
    uv_tx_types: the mode-implied tx types (all DCT_DCT at 32x32, where
    ADST is illegal).  rates None: the analytic proxy 2*sum(log2(1+|l|))
    + nonzeros + 4 per plane and no mode cost (the varpart program's).
    no_write: leave the planes alone and return the winners'
    reconstructions in their place.  rdoq_tbl: RDOQ's chroma bundle
    (rate_est.md_rate_args()[8]); when given, the regular modes' levels
    go through ops/rdoq.optimize_levels after the quantizer (not the CfL
    candidate's, as in the reference).

    Returns (uv_mode (B,), q_u, q_v, recon_u, recon_v) and, with cfl,
    (alpha_u, alpha_v) (B,) int32, signed q3, zero where CfL lost."""
    dev = recon_u.device
    nb_u = _gather_neighbors(recon_u, fi, ys, xs, n, have_above, have_left,
                             bd=bd)
    nb_v = _gather_neighbors(recon_v, fi, ys, xs, n, have_above, have_left,
                             bd=bd)
    src_ub = _gather_block(src_u, fi, ys, xs, n, n)
    src_vb = _gather_block(src_v, fi, ys, xs, n, n)
    b = ys.shape[0]
    nm = len(UV_MODES)
    lam_pair = lam
    sid = quant.stream_ids(qp)
    if sid is not None or qp.zbin.dim() == 2:
        # per-block rows; each (mode, plane-pair) group is 2*B blocks
        qp = quant.repeat_rows(qp, 2)
        lam_pair = lam.repeat(2)
    preds = []
    for mode in UV_MODES:
        for above, left, corner in (nb_u, nb_v):
            preds.append(intra.predict(mode, above, left, corner, n, n,
                                       have_above=have_above,
                                       have_left=have_left, bd=bd))
    pred_all = torch.cat(preds, dim=0)                 # (nm*2*B, n, n)
    src_pair = torch.cat([src_ub, src_vb], dim=0)
    src_all = src_pair.repeat(nm, 1, 1)
    resid_all = src_all - pred_all
    qcs, recs = [], []
    for mi, tx_type in enumerate(uv_tx_types):
        sl = slice(mi * 2 * b, (mi + 1) * 2 * b)
        coeffs = tf.fwd_txfm2d(resid_all[sl], tx_type, tx_size)
        qc, dq = quant.quantize(coeffs, qp, tx_size)
        if rdoq_tbl is not None:
            qc, dq = rdoq_mod.optimize_levels(
                coeffs, qc, quant.dequant_field(qp, n, n), tx_size, tx_type,
                rdoq_tbl, lam_pair,
                float(np.float32(tf.coeff_sse_scale(tx_size, tx_type))))
        recs.append(tf.inv_txfm2d_add(dq, pred_all[sl], tx_type, tx_size,
                                      bd=bd))
        qcs.append(qc)
    qcoeff_all = torch.cat(qcs, dim=0)
    rec_all = torch.cat(recs, dim=0)
    d = rec_all - src_all
    dist = (d * d).sum(dim=(1, 2)).to(torch.float32)
    lam_flat = lam_pair.repeat(nm) if lam_pair.dim() else lam
    if rates is None:
        aq = qcoeff_all.abs()
        bits = (torch.log2(1.0 + aq.to(torch.float32)).sum(dim=(1, 2))
                * 2.0 + (aq > 0).sum(dim=(1, 2)) + 4.0)
        cost_uv = (dist + lam_flat * bits).reshape(nm, 2, b).sum(dim=1)
    else:
        coef_bits, txb_base, uv_bits, eob_tbl = rates
        pos = _scan_pos_on(tx_size, dev)
        bits = _txb_bits(qcoeff_all.abs(), coef_bits, txb_base[1], eob_tbl,
                         pos, None if sid is None else qp.sid.repeat(nm))
        cost_uv = (dist + lam_flat * bits).reshape(nm, 2, b).sum(dim=1)
        cost_uv = cost_uv + lam * (uv_bits[:, None] if sid is None
                                   else uv_bits[sid].T)
    mi_best = cost_uv.argmin(dim=0)
    ar = torch.arange(b, device=dev)
    qall = qcoeff_all.reshape(nm, 2, b, n, n)
    rall = rec_all.reshape(nm, 2, b, n, n)
    um = _ids_on(UV_MODES, dev)[mi_best]
    qu, qv = qall[mi_best, 0, ar], qall[mi_best, 1, ar]
    rec_u, rec_v = rall[mi_best, 0, ar], rall[mi_best, 1, ar]
    alpha_u = alpha_v = None
    if cfl:
        ac = intra.cfl_ac_420(luma_rec, n, n)                # (B,n,n) q3
        dc_pair = torch.cat([preds[0], preds[1]], dim=0)     # DC preds
        acf = ac.to(torch.float32)
        den = (acf * acf).sum(dim=(1, 2)) + 1e-6

        def fit(src_blk, dc):
            # least squares in float32: the sum passes 2^24, so its last
            # bits depend on the order of summation (a counted tie)
            resid = (src_blk - dc).to(torch.float32)
            a = torch.round(64.0 * (resid * acf).sum(dim=(1, 2)) / den)
            return a.to(torch.int32).clamp(-16, 16)

        a0_pair = torch.cat([fit(src_ub, preds[0]), fit(src_vb, preds[1])])
        ac_pair = torch.cat([ac, ac], dim=0)
        # the three refinements stacked on the batch axis: (3, 2B, ...)
        offs = _ids_on((-1, 0, 1), dev)[:, None]
        a_try = (a0_pair[None] + offs).clamp(-16, 16)        # (3, 2B)
        pred_c = intra.cfl_predict(dc_pair[None], ac_pair[None],
                                   a_try[:, :, None, None], bd=bd)
        flat_pred = pred_c.reshape(3 * 2 * b, n, n)
        coeffs_c = tf.fwd_txfm2d(
            (src_pair[None] - pred_c).reshape(3 * 2 * b, n, n),
            cc.DCT_DCT, tx_size)
        qp_c = quant.repeat_rows(qp, 3)
        qc_c, dq_c = quant.quantize(coeffs_c, qp_c, tx_size)
        rec_c = tf.inv_txfm2d_add(dq_c, flat_pred, cc.DCT_DCT, tx_size,
                                  bd=bd)
        dd = rec_c.reshape(3, 2 * b, n, n) - src_pair[None]
        d_c = (dd * dd).sum(dim=(2, 3)).to(torch.float32)    # (3, 2B)
        bits_c = _txb_bits(qc_c.abs(), coef_bits, txb_base[1], eob_tbl,
                           pos, quant.stream_ids(qp_c)).reshape(3, 2 * b)
        co = d_c + lam_pair * bits_c
        oi = co.argmin(dim=0)                                # (2B,)
        ar2 = torch.arange(2 * b, device=dev)
        cost_c = co[oi, ar2]
        q_sel = qc_c.reshape(3, 2 * b, n, n)[oi, ar2]
        rec_sel = rec_c.reshape(3, 2 * b, n, n)[oi, ar2]
        a_sel = a_try[oi, ar2]
        au_s, av_s = a_sel[:b], a_sel[b:]
        cfl_cost = cost_c[:b] + cost_c[b:]
        # joint sign (0, 0) is not codable; DC_PRED covers that case
        cfl_cost = cfl_cost + torch.where((au_s == 0) & (av_s == 0),
                                          FORBID, 0.0)
        take_c = cfl_cost < cost_uv.amin(dim=0)
        t3c = take_c[:, None, None]
        um = torch.where(take_c, cc.UV_CFL_PRED, um)
        qu = torch.where(t3c, q_sel[:b], qu)
        qv = torch.where(t3c, q_sel[b:], qv)
        rec_u = torch.where(t3c, rec_sel[:b], rec_u)
        rec_v = torch.where(t3c, rec_sel[b:], rec_v)
        alpha_u = torch.where(take_c, au_s, 0)
        alpha_v = torch.where(take_c, av_s, 0)
    if inter is not None:
        choose, irec_u, irec_v = inter
        c3 = choose[:, None, None]
        rec_u = torch.where(c3, irec_u, rec_u)
        rec_v = torch.where(c3, irec_v, rec_v)
        if cfl:
            alpha_u = torch.where(choose, 0, alpha_u)
            alpha_v = torch.where(choose, 0, alpha_v)
            um = torch.where(choose, UV_MODES[0], um)
    if no_write:
        recon_u, recon_v = rec_u, rec_v
    else:
        _scatter_blocks(recon_u, rec_u, fi, ys, xs, sel)
        _scatter_blocks(recon_v, rec_v, fi, ys, xs, sel)
    if cfl:
        return um, qu, qv, recon_u, recon_v, alpha_u, alpha_v
    return um, qu, qv, recon_u, recon_v


def frame_program(sy, su, sv, qp, lam, rates, modes, bd=8, tx_search=False,
                  angle_deltas=False, cfl=False, palette=None,
                  tile_starts=(0,), rdoq=False):
    """Whole-frame MD for a batch of F frames: a Python loop over the
    waves, each running the luma and the chroma step on F x maxb slots.

    sy: (F, H, W), su/sv: (F, H/2, W/2) tensors of pixel_dtype(bd);
    qp/lam: the frame quantizer and lambda, or (F*gh*gw, 2) / (F*gh*gw,)
    per-block rows in raster block order (adaptive quantization), which
    each wave gathers for its slots, or a StreamQuant whose sid is the
    (F,) stream of each frame with (S,) lambdas (a stream batch at
    several qindices; the luma step takes K1's per-row form); rates: the
    md_rate_args tuple on the same device, its mode_bits one per luma
    candidate (with a StreamQuant, rate_est.stack_rate_args of the
    streams' tuples).
    tx_search/angle_deltas: the luma candidates are
    ``expand_tx_cands(modes, angle_deltas)`` and the returned y modes are
    indices into that list.  cfl: the chroma step gets the CfL
    candidate.  palette: optional (cost (F*nb,) float32, rec (F*nb, 16,
    16) int32, qy (F*nb, 256) int16) tensors in raster block order — a
    precomputed palette alternative per block, taken where it beats the
    best intra candidate.

    Returns (recon_y, recon_u, recon_v) of pixel_dtype(bd) and, in raster
    block order, y modes / uv modes (F, gh*gw) uint8, levels qy (F, gh*gw,
    256), qu/qv (F, gh*gw, 64) int16 (levels of 16x16/8x8 transforms fit:
    |level| <= 32767 / dequant_min <= 16384), CfL alphas au/av (F, gh*gw)
    int8 and, with ``palette``, the (F, gh*gw) bool palette choice (such
    blocks carry y mode DC_PRED and the palette's levels).  tile_starts:
    the block-column starts of the tile columns, which clamp the
    neighbours' availability (the wave schedule is the same).  rdoq: the
    luma and chroma steps run RDOQ on their levels with the rq_y / rq_uv
    bundles of ``rates``."""
    nf, h, w = sy.shape
    gh, gw = h // BLK, w // BLK
    dev = sy.device
    if tx_search:
        cand_modes, cand_txs = expand_tx_cands(modes, angle_deltas)
    else:
        cand_modes, cand_txs = modes, None
    src_y = sy.to(torch.int32)
    src_u = su.to(torch.int32)
    src_v = sv.to(torch.int32)
    recon_y = torch.zeros((nf, h, w), dtype=torch.int32, device=dev)
    recon_u = torch.zeros((nf, h // 2, w // 2), dtype=torch.int32,
                          device=dev)
    recon_v = torch.zeros_like(recon_u)
    nbk = nf * gh * gw
    ym = torch.zeros(nbk, dtype=torch.uint8, device=dev)
    um = torch.zeros_like(ym)
    qy = torch.zeros((nbk, BLK * BLK), dtype=torch.int16, device=dev)
    qu = torch.zeros((nbk, CBLK * CBLK), dtype=torch.int16, device=dev)
    qv = torch.zeros_like(qu)
    au = torch.zeros(nbk, dtype=torch.int8, device=dev)
    av = torch.zeros_like(au)
    pchoose = torch.zeros(nbk, dtype=torch.bool, device=dev)
    cy_t, cuv_t, txbb, modeb, uvb, eoby, eobuv, rqly, rqluv = rates
    streams = isinstance(qp, quant.StreamQuant)
    aq = not streams and qp.zbin.dim() == 2
    qp_w, lam_w = qp, lam
    for ws in _device_schedule(gh, gw, nf, dev, tuple(tile_starts)):
        if aq:
            qp_w = quant.QuantParams(*(f[ws.bid] for f in qp))
            lam_w = lam[ws.bid]
        elif streams:
            qp_w = qp.take(ws.fi)
            lam_w = lam[qp_w.sid]
        inter = None
        if palette is not None:
            inter = (palette[0][ws.bid], palette[1][ws.bid])
        out = _rd_step(recon_y, src_y, ws.fi, ws.by * BLK, ws.bx * BLK,
                       ws.sel, ws.ha, ws.hl, qp_w, lam_w, cand_modes,
                       (cy_t, txbb, modeb, eoby), bd=bd, tx_types=cand_txs,
                       tr_avail=ws.tr, bl_avail=ws.bl, inter=inter,
                       return_index=tx_search,
                       rdoq_tbl=rqly if rdoq else None)
        m, q = out[0], out[1]
        if palette is not None:
            pchoose[ws.rid] = out[3][ws.sel]
        luma_rec = None
        if cfl:
            luma_rec = _gather_block(recon_y, ws.fi, ws.by * BLK,
                                     ws.bx * BLK, BLK, BLK)
        cout = _rd_step_chroma(
            recon_u, recon_v, src_u, src_v, ws.fi, ws.by * CBLK,
            ws.bx * CBLK, ws.sel, ws.ha, ws.hl, qp_w, lam_w,
            (cuv_t, txbb, uvb, eobuv), bd=bd, luma_rec=luma_rec, cfl=cfl,
            rdoq_tbl=rqluv if rdoq else None)
        uvm, q_u, q_v = cout[0], cout[1], cout[2]
        if cfl:
            au[ws.rid] = cout[5][ws.sel].to(torch.int8)
            av[ws.rid] = cout[6][ws.sel].to(torch.int8)
        ym[ws.rid] = m[ws.sel].to(torch.uint8)
        um[ws.rid] = uvm[ws.sel].to(torch.uint8)
        qy[ws.rid] = q[ws.sel].reshape(-1, BLK * BLK).to(torch.int16)
        qu[ws.rid] = q_u[ws.sel].reshape(-1, CBLK * CBLK).to(torch.int16)
        qv[ws.rid] = q_v[ws.sel].reshape(-1, CBLK * CBLK).to(torch.int16)
    if palette is not None:
        ym = torch.where(pchoose, cc.DC_PRED, ym).to(torch.uint8)
        qy = torch.where(pchoose[:, None], palette[2], qy)
    pdt = pixel_dtype(bd)
    out = (recon_y.to(pdt), recon_u.to(pdt),
           recon_v.to(pdt), ym.reshape(nf, -1),
           um.reshape(nf, -1), qy.reshape(nf, gh * gw, -1),
           qu.reshape(nf, gh * gw, -1), qv.reshape(nf, gh * gw, -1),
           au.reshape(nf, -1), av.reshape(nf, -1))
    if palette is not None:
        out += (pchoose.reshape(nf, -1),)
    return out


def _rate_args(qindex: int, modes: tuple, exact: bool, device):
    """md_rate_args of a key frame, made once per (qindex, modes, the
    exact flag after SVT_TPU_EXACT_RATES, device)."""
    return _rate_args_on(qindex, modes, exact_rates_override(exact), device)


@functools.lru_cache(maxsize=32)
def _rate_args_on(qindex: int, modes: tuple, exact: bool, device):
    return md_rate_args(qindex, modes, UV_MODES, exact=exact, device=device)


def frame_lambda(qindex: int, bd: int = 8) -> np.float32:
    """MD Lagrangian 0.7 * (dc step / 8)^2, in float32."""
    qstep = quant.dc_q(qindex, bd=bd) / 8.0
    return np.float32(0.7 * qstep * qstep)


def stream_params(qindices, rates, device, bd: int = 8):
    """(qp, lam, rt) of a batch of S streams at ``qindices``: for one
    stream its frame quantizer, 0-d lambda and ``rates(qindex)``; for S >
    1 a StreamQuant with sid = arange(S), the (S,) lambdas and the
    streams' rate tuples stacked (rate_est.stack_rate_args)."""
    from svt_av1_tpu_torch.codec.rate_est import stack_rate_args
    if len(qindices) == 1:
        q = int(qindices[0])
        return (quant.params_on(q, device, bd),
                torch.tensor(frame_lambda(q, bd), device=device), rates(q))
    return (quant.StreamQuant(quant.stream_table(qindices, device, bd),
                              torch.arange(len(qindices), device=device)),
            torch.tensor([frame_lambda(q, bd) for q in qindices],
                         device=device),
            stack_rate_args([rates(int(q)) for q in qindices]))


def _check_slice(modes, bd, h, w):
    if bd not in (8, 10):
        raise ValueError(f"bit depth {bd} is not 8 or 10")
    bad = [m for m in modes if m not in ALL_MODES + FI_MODES]
    if bad:
        raise ValueError(f"{bad} are not luma intra modes")
    if h % BLK or w % BLK:
        raise ValueError(f"frame {w}x{h} is not a multiple of {BLK}")


def encode_intra_frames_launch(frames, qindex: int, modes=MODES,
                               bd: int = 8, exact_rates: bool = False,
                               tile_starts=(0,), rdoq: bool = False,
                               device=None):
    """Enqueue the batched frame program (plain luma modes, with the
    filter-intra pseudo-modes at M0-M4, DCT_DCT) for
    frames = [(y, u, v), ...] (numpy, same dims, multiples of 16) on
    ``device`` (default: the current CUDA device).  On CUDA the work runs
    asynchronously; pair with encode_intra_frames_finish, so the host can
    entropy-code the previous batch meanwhile.  tile_starts: the
    block-column starts of the frames' tile columns.  rdoq: RDOQ after
    the quantizer (after K1 on every luma step)."""
    h, w = frames[0][0].shape
    _check_slice(modes, bd, h, w)
    dev = device_mod.resolve(device)
    qp = quant.params_on(int(qindex), dev, bd)
    lam = torch.tensor(frame_lambda(qindex, bd), dtype=torch.float32,
                       device=dev)
    planes = source_planes([np.stack([f[p] for f in frames])
                            for p in range(3)], bd, dev)
    rt = _rate_args(int(qindex), tuple(modes), bool(exact_rates), dev)
    out = frame_program(*planes, qp, lam, rt, tuple(modes), bd=bd,
                        tile_starts=tile_starts, rdoq=rdoq)
    return (out, h // BLK, w // BLK, len(frames))


def encode_intra_frames_finish(pending, as_arrays: bool = True):
    """Bring a launched batch's decisions to the host: [(decisions,
    recon), ...] per frame, recon = dict(y, u, v) of pixel_dtype(bd)
    tensors left on the device (the in-loop filters run there; the caller
    copies out the final planes).  With ``as_arrays`` the decisions are
    the array bundle the native tile coder takes, (ym, um, qy, qu, qv,
    gh, gw); without, per-block BlockDecisions for the object tile
    coder."""
    out, gh, gw, nf = pending
    ym, um, qy, qu, qv, au, av = (o.cpu().numpy() for o in out[3:10])
    results = []
    for i in range(nf):
        recon = dict(y=out[0][i], u=out[1][i], v=out[2][i])
        if as_arrays:
            decisions = (ym[i], um[i], qy[i], qu[i], qv[i], gh, gw)
        else:
            decisions = _collect_decisions_dense(gh, gw, ym[i], um[i], qy[i],
                                                 qu[i], qv[i], au=au[i],
                                                 av=av[i])
        results.append((decisions, recon))
    return results


def split_fi_mode(m: int):
    """(y_mode, filter_intra_mode) from an MD mode id (pseudo-modes
    >= FI_MODE_BASE signal as DC + filter_intra_mode)."""
    if m >= cc.FI_MODE_BASE:
        return cc.DC_PRED, m - cc.FI_MODE_BASE
    return m, -1


def _collect_decisions_dense(gh, gw, ym, um, qy, qu, qv_, cands=None,
                             au=None, av=None, qmap=None):
    """Per-block BlockDecisions from dense raster (gh*gw) arrays.

    cands: optional [(mode, angle_delta, tx_type)] list — ym then holds
    candidate indices (tx-search programs) rather than modes.  qmap:
    optional per-64x64 qindex map; each block's decision carries its
    superblock's qindex (0 otherwise: the frame's)."""
    qy = qy.astype(np.int32).reshape(gh * gw, BLK, BLK)
    qu = qu.astype(np.int32).reshape(gh * gw, CBLK, CBLK)
    qv_ = qv_.astype(np.int32).reshape(gh * gw, CBLK, CBLK)
    decisions = {}
    for by in range(gh):
        for bx in range(gw):
            bid = by * gw + bx
            r4, c4 = by * (BLK >> 2), bx * (BLK >> 2)
            if cands is not None:
                y_mode, adelta, tx_type = cands[int(ym[bid])]
            else:
                y_mode, adelta, tx_type = int(ym[bid]), 0, cc.DCT_DCT
            y_mode, fi = split_fi_mode(int(y_mode))
            decisions[(r4, c4)] = BlockDecision(
                r4=r4, c4=c4, bsize=cc.BLOCK_16X16,
                y_mode=int(y_mode), uv_mode=int(um[bid]),
                tx_type=int(tx_type), qcoeff_y=qy[bid],
                qcoeff_u=qu[bid], qcoeff_v=qv_[bid],
                angle_delta_y=int(adelta), filter_intra_mode=fi,
                cfl_alpha_u=(int(au[bid]) if au is not None else 0),
                cfl_alpha_v=(int(av[bid]) if av is not None else 0),
                qindex=(int(qmap[by // 4, bx // 4])
                        if qmap is not None else 0))
    return decisions


def palette_md_candidates(src_y: np.ndarray, qindex: int, bd: int = 8,
                          max_colors: int = 8, device=None):
    """Per-16x16 palette candidates for screen content: blocks whose
    pixels use <= max_colors distinct values get an exact palette, the
    index map, and a batched RD evaluation on ``device`` (default: the
    current CUDA device): pred -> DCT -> quant -> dist + rate + a
    header-bits estimate.

    Returns None when no block qualifies, else (cost (nb,) float32, rec
    (nb, 16, 16) int32, qy (nb, 256) int16 — tensors on ``device`` —,
    info {bid: (colors, cmap)} on the host)."""
    dev = device_mod.resolve(device)
    h, w = src_y.shape
    gh, gw = h // BLK, w // BLK
    nb = gh * gw
    src = np.asarray(src_y)
    info = {}
    preds = np.zeros((nb, BLK, BLK), np.int32)
    use = np.zeros(nb, bool)
    hdr_bits = np.zeros(nb, np.float32)
    for by in range(gh):
        for bx in range(gw):
            blk = src[by * BLK:(by + 1) * BLK, bx * BLK:(bx + 1) * BLK]
            colors = np.unique(blk)
            if not (pal.PALETTE_MIN_SIZE <= len(colors) <= max_colors):
                continue
            bid = by * gw + bx
            cmap = np.searchsorted(colors, blk).astype(np.uint8)
            info[bid] = (colors.astype(np.uint16), cmap)
            preds[bid] = colors[cmap].astype(np.int32)
            use[bid] = True
            hdr_bits[bid] = (4.0 + len(colors) * (bd - 2)
                             + pal.map_bits_estimate(cmap, len(colors)))
    if not use.any():
        return None
    qp = quant.params_on(int(qindex), dev, bd)
    lam = float(frame_lambda(qindex, bd))
    blocks = (src.reshape(gh, BLK, gw, BLK).transpose(0, 2, 1, 3)
              .reshape(nb, BLK, BLK).astype(np.int32))
    pred_t = torch.from_numpy(preds).to(dev)
    resid = torch.from_numpy(blocks).to(dev) - pred_t
    cf = tf.fwd_txfm2d(resid, cc.DCT_DCT, cc.TX_16X16)
    qc, dq = quant.quantize(cf, qp, cc.TX_16X16)
    s2 = float(np.float32(tf.coeff_sse_scale(cc.TX_16X16, cc.DCT_DCT)))
    err = cf.to(torch.float32) - dq.to(torch.float32)
    dist = s2 * (err * err).sum(dim=(1, 2))
    af = qc.abs().to(torch.float32)
    coef_bits = (2.0 * torch.log2(1.0 + af).sum(dim=(1, 2))
                 + (af > 0).sum(dim=(1, 2)) + 4.0)
    rec = tf.inv_txfm2d_add(dq, pred_t, cc.DCT_DCT, cc.TX_16X16, bd=bd)
    cost = dist + lam * (coef_bits + torch.from_numpy(hdr_bits).to(dev))
    cost = torch.where(torch.from_numpy(use).to(dev), cost, 3.0e38)
    return (cost, rec, qc.to(torch.int16).reshape(nb, BLK * BLK), info)


def _qmap_rows(qmap, gh: int, gw: int, device, bd: int = 8):
    """Per-block quantizer rows (QuantParams of (gh*gw, 2) int32 tensors)
    and float32 lambdas (gh*gw,) on ``device`` from a per-64x64 qindex
    map, in raster block order."""
    nb = gh * gw
    fields = [np.zeros((nb, 2), np.int32) for _ in range(5)]
    lam = np.zeros(nb, np.float32)
    for by in range(gh):
        for bx in range(gw):
            q = int(qmap[by // 4, bx // 4])
            qp_b = quant.make_quant_params(q, bd=bd)
            bid = by * gw + bx
            for fi in range(5):
                fields[fi][bid] = qp_b[fi]
            qs = quant.dc_q(q, bd=bd) / 8.0
            lam[bid] = 0.7 * qs * qs
    return (quant.QuantParams(*(torch.from_numpy(f).to(device)
                                for f in fields)),
            torch.from_numpy(lam).to(device))


def encode_intra_frame(src_y: np.ndarray, src_u: np.ndarray,
                       src_v: np.ndarray, qindex: int, modes=MODES,
                       bd: int = 8, qmap=None, rdoq=False,
                       tx_search=False, angle_deltas=False, cfl=False,
                       exact_rates=False, palette_cands=None, device=None):
    """Encode one key frame on ``device`` (default: the current CUDA
    device): the frame program at F = 1.  Returns ({(r4, c4):
    BlockDecision}, recon dict(y, u, v) of pixel_dtype(bd) tensors on
    ``device``, where the in-loop filters take them).

    palette_cands: the tuple ``palette_md_candidates`` returned for this
    frame, or None.  qmap: optional (sb_rows, sb_cols) int array of
    per-64x64 qindex values (the TPL delta-q key frame): every block takes
    its superblock's quantizer and lambda 0.7 * (dc_q / 8)^2; None =
    uniform ``qindex``, which the rate tables take either way.  rdoq:
    RDOQ on the luma and chroma levels (ops/rdoq.py; with a qmap on the
    per-block quantizers)."""
    h, w = src_y.shape
    _check_slice(modes, bd, h, w)
    gh, gw = h // BLK, w // BLK
    dev = device_mod.resolve(device)
    if qmap is not None:
        qp, lam = _qmap_rows(qmap, gh, gw, dev, bd)
    else:
        qp = quant.params_on(int(qindex), dev, bd)
        lam = torch.tensor(frame_lambda(qindex, bd), dtype=torch.float32,
                           device=dev)
    mode_ids, cands = tuple(modes), None
    if tx_search:
        # one rate-table entry per candidate: the mode ids repeat
        cand_modes, cand_txs = expand_tx_cands(tuple(modes), angle_deltas)
        cands = [(m, d, t) for (m, d), t in zip(cand_modes, cand_txs)]
        mode_ids = tuple(m for m, _ in cand_modes)
    rt = _rate_args(int(qindex), mode_ids, bool(exact_rates), dev)
    palette = pinfo = None
    if palette_cands is not None:
        pc, prc, pqy, pinfo = palette_cands
        palette = (pc.to(dev), prc.to(dev), pqy.to(dev))
    planes = source_planes([np.asarray(p)[None]
                            for p in (src_y, src_u, src_v)], bd, dev)
    out = frame_program(*planes, qp, lam, rt, tuple(modes), bd=bd,
                        tx_search=tx_search, angle_deltas=angle_deltas,
                        cfl=cfl, palette=palette, rdoq=rdoq)
    (ym, um, qy, qu, qv, au, av) = (o[0].cpu().numpy() for o in out[3:10])
    decisions = _collect_decisions_dense(gh, gw, ym, um, qy, qu, qv,
                                         cands=cands, au=au, av=av,
                                         qmap=qmap)
    if palette is not None:
        pchoose = out[10][0].cpu().numpy()
        for bid, (colors, cmap) in pinfo.items():
            if not pchoose[bid]:
                continue
            k = ((bid // gw) * 4, (bid % gw) * 4)
            decisions[k] = dataclasses.replace(
                decisions[k], y_mode=cc.DC_PRED, tx_type=cc.DCT_DCT,
                angle_delta_y=0, filter_intra_mode=-1,
                palette=colors, palette_map=cmap)
    return decisions, dict(y=out[0][0], u=out[1][0], v=out[2][0])


def apply_loop_filter(recon, fp):
    """In-loop deblocking for the uniform grid (16x16 luma / 8x8 chroma)
    at the frame header's levels; the encoder and the decoder share it.
    recon: dict of y/u/v tensors; the result keeps their device and dtype.
    Bit depth follows the dtype (uint8 -> 8, else 10)."""
    out = dict(recon)
    bd = 8 if recon["y"].dtype == torch.uint8 else 10
    for p, lvl in (("y", fp.filter_level[0]), ("u", fp.filter_level_uv[0]),
                   ("v", fp.filter_level_uv[1])):
        if lvl > 0:
            luma = p == "y"
            out[p] = dlf.loop_filter_plane_uniform(
                recon[p], BLK if luma else CBLK, lvl, fp.sharpness,
                14 if luma else 6, bd).to(recon[p].dtype)
    return out


def _select_by(keys, make):
    """Per-block tensors picked by a host-side key: ``make(key)`` is
    computed once per distinct key over the whole batch and kept for the
    blocks that carry it."""
    out = None
    for k in dict.fromkeys(keys):
        val = make(k)
        if out is None:
            out = val
            continue
        take = torch.as_tensor(np.array([x == k for x in keys]),
                               device=val.device)[:, None, None]
        out = torch.where(take, val, out)
    return out


# interintra_mode -> the intra mode of its intra half
II_TO_INTRA = (cc.DC_PRED, cc.V_PRED, cc.H_PRED, cc.SMOOTH_PRED)


def reconstruct_from_decisions(decisions, width: int, height: int,
                               qindex: int, bd: int = 8, device=None,
                               base=None, inter_intra=None,
                               tile_starts=(0,)):
    """Decoder-side reconstruction from parsed BlockDecisions of a key
    frame: luma modes with angle deltas and tx types, filter-intra and
    palette blocks, chroma modes and CfL; a block whose decision carries
    a qindex (delta-q) is dequantized at it, the others at ``qindex``.
    A frame with 32x32 / 64x64 leaves (the variable-partition program's)
    takes ``_reconstruct_mixed``; the rest of this docstring is about the
    uniform 16x16 grid.

    The reference walks superblocks in z-order block by block; on this
    grid the encoder's 2:1 wave order is a valid order too (every sample
    a block predicts from lies in an earlier wave, availability depends
    on position only, and zone-3 candidates are coded only where
    bottom-left is unavailable), so the blocks of one wave are
    reconstructed as one batch on ``device`` (default: the current CUDA
    device), grouped by (mode, delta) for prediction and by tx type for
    the inverse, with the encoder's top-right/bottom-left flags.  CfL
    chroma of a wave reads that wave's reconstructed luma.  Returns
    dict(y, u, v) of pixel_dtype(bd) planes on ``device`` (the decoder
    filters them there before it copies them out).

    base: the (H, W) / (H/2, W/2) int32 planes of an inter frame with its
    inter blocks already reconstructed; ``decisions`` then holds its intra
    blocks only, which are reconstructed over it in wave order.

    inter_intra: dict(bids=[raster ids], preds={plane: (n, N, N) inter
    predictions}) of the inter frame's inter-intra blocks, which
    ``decisions`` then holds too: each blends the intra prediction of its
    interintra_mode with its inter prediction under the smooth mask, and
    inverts its residual at the signaled tx type.

    tile_starts: the tile columns' starts in 16x16 block columns; a tile
    clamps left, top-right and bottom-left availability as the frame edge
    does."""
    dev = device_mod.resolve(device)
    tile_starts = tuple(tile_starts)
    if base is None and any(d.bsize != cc.BLOCK_16X16
                            for d in decisions.values()):
        return _reconstruct_mixed(decisions, width, height, qindex, bd, dev,
                                  tile_starts)
    gh, gw = height // BLK, width // BLK
    nb = gh * gw
    ymode = [None] * nb        # (mode, delta), or "pal"
    ytx = np.zeros(nb, np.int64)
    um = np.zeros(nb, np.int64)
    alpha = np.zeros((2, nb), np.int32)
    qy = np.zeros((nb, BLK, BLK), np.int32)
    qu = np.zeros((nb, CBLK, CBLK), np.int32)
    qv = np.zeros((nb, CBLK, CBLK), np.int32)
    qidx = np.full(nb, int(qindex), np.int64)
    pal_pred = None
    ii_pred = None
    if inter_intra is not None:
        # full-frame (nb, n, n) inter predictions, gathered per wave
        ii_pred = {}
        for p, pr in inter_intra["preds"].items():
            ii_pred[p] = torch.zeros((nb,) + tuple(pr.shape[1:]),
                                     dtype=pr.dtype, device=pr.device)
            ii_pred[p][torch.as_tensor(inter_intra["bids"],
                                       device=pr.device)] = pr
    for (r4, c4), d in decisions.items():
        bid = (r4 // 4) * gw + c4 // 4
        if (ii_pred is not None and d.is_inter and d.interintra_mode >= 0
                and d.bsize == cc.BLOCK_16X16 and not (r4 % 4 or c4 % 4)):
            # the luma type as a decoder derives it (read only for a luma
            # txb with coefficients); chroma inherits it
            ymode[bid] = ("ii", int(d.interintra_mode))
            ytx[bid] = d.tx_type if np.any(d.qcoeff_y) else cc.DCT_DCT
            um[bid] = -1 - int(d.interintra_mode)
            qy[bid], qu[bid], qv[bid] = d.qcoeff_y, d.qcoeff_u, d.qcoeff_v
            continue
        if d.angle_delta_uv or d.is_inter or r4 % 4 or c4 % 4:
            raise NotImplementedError(
                f"block at ({r4}, {c4}) uses a tool outside the port "
                "(chroma angle deltas): ROADMAP.md queue A item 7")
        if d.bsize != cc.BLOCK_16X16:
            raise ValueError(f"{d.bsize}: a leaf of a mixed-size frame "
                             "among uniform-grid blocks")
        if d.qindex:
            qidx[bid] = d.qindex
        if d.palette is not None:
            if pal_pred is None:
                pal_pred = np.zeros((nb, BLK, BLK), np.int32)
            pal_pred[bid] = np.asarray(d.palette, np.int32)[
                np.asarray(d.palette_map, np.int32)]
            ymode[bid], ytx[bid] = "pal", cc.DCT_DCT
        else:
            ymode[bid], ytx[bid] = _luma_key(d), d.tx_type
        um[bid] = d.uv_mode
        alpha[:, bid] = d.cfl_alpha_u, d.cfl_alpha_v
        qy[bid], qu[bid], qv[bid] = d.qcoeff_y, d.qcoeff_u, d.qcoeff_v
    if base is None and any(m is None for m in ymode):
        raise ValueError("decisions do not cover the 16x16 grid")
    qp = quant.params_on(int(qindex), dev, bd)
    qp_rows = None
    if (qidx != qindex).any():
        # per-block quantizer rows in raster order, gathered per wave
        qp_rows = quant.QuantParams(*(
            torch.as_tensor(np.stack([quant.make_quant_params(
                int(q), bd=bd)[f] for q in qidx]), device=dev)
            for f in range(5)))
    if base is None:
        rec = dict(y=torch.zeros((1, height, width), dtype=torch.int32,
                                 device=dev),
                   u=torch.zeros((1, height // 2, width // 2),
                                 dtype=torch.int32, device=dev))
        rec["v"] = torch.zeros_like(rec["u"])
    else:
        rec = {p: base[p][None] for p in ("y", "u", "v")}
    lvl = dict(y=torch.as_tensor(qy, device=dev),
               u=torch.as_tensor(qu, device=dev),
               v=torch.as_tensor(qv, device=dev))
    alpha_t = torch.as_tensor(alpha, device=dev)
    if pal_pred is not None:
        pal_pred = torch.as_tensor(pal_pred, device=dev)
    coded = np.array([m is not None for m in ymode])
    for ws in _device_schedule(gh, gw, 1, dev, tile_starts):
        rid = ws.rid.cpu().numpy()
        sel = ws.sel
        if base is not None:
            # the inter frame's intra blocks of this wave only
            keep = coded[rid]
            if not keep.any():
                continue
            rid, sel = rid[keep], sel[torch.as_tensor(keep, device=dev)]
        rid_t = torch.as_tensor(rid, device=dev)
        fi, ha, hl = ws.fi[sel], ws.ha[sel], ws.hl[sel]
        ar = torch.arange(len(rid), device=dev)
        qp_w = qp if qp_rows is None else quant.QuantParams(
            *(f[rid_t] for f in qp_rows))
        for p in ("y", "u", "v"):
            luma = p == "y"
            n = BLK if luma else CBLK
            tx = cc.TX_16X16 if luma else cc.TX_8X8
            ys, xs = ws.by[sel] * n, ws.bx[sel] * n
            above, left, corner = _gather_neighbors(rec[p], fi, ys, xs, n,
                                                    ha, hl, bd=bd)

            def ii_blend(mode, p):
                """An inter-intra block's prediction: the smooth-mask
                blend of its intra mode's prediction over its inter
                one."""
                ip = intra.predict(II_TO_INTRA[mode], above, left, corner, n,
                                   n, have_above=ha, have_left=hl, bd=bd)
                mask = torch.as_tensor((ii_ops.MASKS_Y16 if p == "y"
                                        else ii_ops.MASKS_UV8)[mode],
                                       device=dev)
                return ii_ops.blend(ip, ii_pred[p][rid_t], mask)

            if luma:
                keys = [ymode[i] for i in rid]
                ext = (None, None)
                if any(k != "pal" and k[0] != "ii" and (a := cand_angle(*k))
                       and (a < 90 or a > 180) for k in keys):
                    ext = _gather_ext_neighbors(rec[p], fi, ys, xs, n,
                                                above, left, ws.tr[sel],
                                                ws.bl[sel])
                pred = _select_by(keys, lambda k: (
                    pal_pred[rid_t] if k == "pal" else
                    ii_blend(k[1], p) if k[0] == "ii" else _predict_cand(
                        k[0], k[1], n, above, left, corner, ext[0], ext[1],
                        ha, hl, bd)))
                tx_types = [int(t) for t in ytx[rid]]
            elif ii_pred is not None and (um[rid] < 0).any():
                keys = [int(m) for m in um[rid]]
                pred = _select_by(keys, lambda m: (
                    ii_blend(-1 - m, p) if m < 0 else _predict_cand(
                        m, 0, n, above, left, corner, None, None, ha, hl,
                        bd)))
                tx_types = [_chroma_tx_type_inter(int(ytx[i]), tx, False)
                            if um[i] < 0 else _chroma_tx_type(int(um[i]), tx)
                            for i in rid]
            else:
                keys = [int(m) for m in um[rid]]
                if cc.UV_CFL_PRED in keys:
                    ac = intra.cfl_ac_420(_gather_block(
                        rec["y"], fi, ys * 2, xs * 2, BLK, BLK), n, n)
                    a_q3 = alpha_t[0 if p == "u" else 1][rid_t]
                dc = lambda: intra.predict(
                    cc.DC_PRED, above, left, corner, n, n, have_above=ha,
                    have_left=hl, bd=bd)
                pred = _select_by(keys, lambda m: (
                    intra.cfl_predict(dc(), ac, a_q3, bd=bd)
                    if m == cc.UV_CFL_PRED else _predict_cand(
                        m, 0, n, above, left, corner, None, None, ha, hl,
                        bd)))
                tx_types = [_chroma_tx_type(m, tx) for m in keys]
            dq = quant.dequantize(lvl[p][rid_t], qp_w, tx)
            recon = _select_by(tx_types, lambda t: tf.inv_txfm2d_add(
                dq, pred, t, tx, bd=bd))
            _scatter_blocks(rec[p], recon, fi, ys, xs, ar)
    return {p: rec[p][0].to(pixel_dtype(bd)) for p in ("y", "u", "v")}


def _luma_key(d):
    """The luma prediction key of an intra decision: (mode, angle delta),
    filter-intra as its pseudo-mode."""
    if d.filter_intra_mode >= 0:
        return (cc.FI_MODE_BASE + int(d.filter_intra_mode), 0)
    return (int(d.y_mode), int(d.angle_delta_y))


def _sb_leaves(decisions, mi_rows: int, mi_cols: int, r4: int, c4: int,
               size: int, out: list):
    """Append the leaves of the square tree under (r4, c4) in coding
    (z) order."""
    if r4 >= mi_rows or c4 >= mi_cols:
        return
    d = decisions.get((r4, c4))
    if d is not None and int(cc.block_size_wide[d.bsize]) == size:
        out.append(d)
        return
    if size <= BLK:
        raise ValueError(f"no {size}x{size} leaf at ({r4}, {c4})")
    half = size >> 3
    for dr, dc in ((0, 0), (0, half), (half, 0), (half, half)):
        _sb_leaves(decisions, mi_rows, mi_cols, r4 + dr, c4 + dc, size >> 1,
                   out)


def _reconstruct_mixed(decisions, width: int, height: int, qindex: int,
                       bd: int, dev, tile_starts=(0,)):
    """Reconstruction of a key frame with 16x16, 32x32 and 64x64 leaves
    (the reference's z-order walk, batched): 64x64 superblocks run in 2:1
    waves (every sample a superblock reads lies in an earlier wave), and
    step t of a wave reconstructs the t-th leaf (z-order) of each of its
    superblocks, grouped by leaf size.  Top-right / bottom-left
    availability is tr_bl_avail on the leaf size's own grid, partial last
    row and column included, as the encoder derives it; available
    samples past the frame's edge repeat its last one (spec 7.11.2).
    The reference's decoder counts whole grid cells only: it takes a
    64x64 leaf's top-right as unavailable where the frame's width is not
    a multiple of 64, while its encoder reads the zeros past the frame
    there (ROADMAP.md queue C item 4 (c)).  tile_starts clamps the
    availability to each leaf's tile column.  Returns dict(y, u, v)
    pixel_dtype(bd) planes on ``dev``."""
    mi_rows, mi_cols = height // 4, width // 4
    gh64, gw64 = (height + 63) // 64, (width + 63) // 64
    sb_leaves = {}
    for sr in range(gh64):
        for sc in range(gw64):
            leaves = []
            _sb_leaves(decisions, mi_rows, mi_cols, sr * 16, sc * 16, 64,
                       leaves)
            sb_leaves[(sr, sc)] = leaves
    for d in decisions.values():
        # what the varpart program codes: no palette, CfL or delta-q
        if (d.is_inter or d.angle_delta_uv or d.palette is not None
                or d.uv_mode == cc.UV_CFL_PRED or d.qindex
                or d.bsize not in (cc.BLOCK_16X16, cc.BLOCK_32X32,
                                   cc.BLOCK_64X64)):
            raise NotImplementedError(
                f"block at ({d.r4}, {d.c4}) of a mixed-size key frame uses "
                "a tool the variable-partition program does not code "
                "(palette, CfL, delta-q, chroma angle deltas, other block "
                "sizes): ROADMAP.md queue A item 7")
    rec = dict(y=torch.zeros((1, height, width), dtype=torch.int32,
                             device=dev),
               u=torch.zeros((1, height // 2, width // 2), dtype=torch.int32,
                             device=dev))
    rec["v"] = torch.zeros_like(rec["u"])
    qp = quant.params_on(int(qindex), dev, bd)
    for wave in _wave_schedule(gh64, gw64, gh64 * gw64):
        steps = max(len(sb_leaves[sb]) for sb in wave)
        for t in range(steps):
            by_size = {}
            for sb in wave:
                if t < len(sb_leaves[sb]):
                    d = sb_leaves[sb][t]
                    by_size.setdefault(d.bsize, []).append(d)
            for bsize, ds in by_size.items():
                _recon_leaves(rec, ds, bsize, width, height, qp, bd, dev,
                              tile_starts)
    return {p: rec[p][0].to(pixel_dtype(bd)) for p in ("y", "u", "v")}


def _recon_leaves(rec, ds, bsize, width, height, qp, bd, dev,
                  tile_starts=(0,)):
    """Reconstruct a batch of independent same-size intra leaves into
    ``rec`` (dict of (1, H, W) int32 planes) in place, each clamped to its
    tile column (``tile_starts``, in 16x16 block columns)."""
    n = int(cc.block_size_wide[bsize])
    n4 = n >> 2
    # the leaf size's grid over the frame, a partial last row / column
    # included: a 64x64 leaf's top-right superblock may stick out of the
    # frame (its samples past the edge repeat the last one)
    gh_n, gw_n = -(-height // n), -(-width // n)
    nl = len(ds)
    fl = torch.zeros(nl, dtype=torch.int64, device=dev)
    ar = torch.arange(nl, device=dev)
    bounds = []
    for d in ds:
        lo16, hi16 = _tile_bounds_of(d.c4 // 4, tile_starts)
        bounds.append((lo16 * 16 // n, min(hi16 * 16 // n, gw_n)))
    flags = np.array([tr_bl_avail(d.r4 // n4, d.c4 // n4, gh_n, gw_n,
                                  m=16 // n4, col_lo=lo, col_hi=hi)
                      for d, (lo, hi) in zip(ds, bounds)], bool)
    tr = torch.as_tensor(flags[:, 0], device=dev)
    bl = torch.as_tensor(flags[:, 1], device=dev)
    tile_left = torch.as_tensor([d.c4 // n4 > lo
                                 for d, (lo, _) in zip(ds, bounds)],
                                device=dev)
    for p in ("y", "u", "v"):
        luma = p == "y"
        m = n if luma else n // 2
        sc = 4 if luma else 2
        ys = torch.as_tensor([d.r4 * sc for d in ds], device=dev)
        xs = torch.as_tensor([d.c4 * sc for d in ds], device=dev)
        ha, hl = ys > 0, tile_left
        above, left, corner = _gather_neighbors(rec[p], fl, ys, xs, m, ha,
                                                hl, bd=bd)
        if luma:
            keys = [_luma_key(d) for d in ds]
            ext = (None, None)
            if any((a := cand_angle(*k)) and (a < 90 or a > 180)
                   for k in keys):
                ext = _gather_ext_neighbors(rec[p], fl, ys, xs, m, above,
                                            left, tr, bl,
                                            (width - 1, height - 1))
            tx_types = [int(d.tx_type) for d in ds]
            lv = [d.qcoeff_y for d in ds]
            t_sz = MAX_TX[bsize]
        else:
            keys = [(int(d.uv_mode), 0) for d in ds]
            ext = (None, None)
            t_sz = max_chroma_tx_size(bsize)
            tx_types = [_chroma_tx_type(k[0], t_sz) for k in keys]
            lv = [d.qcoeff_u if p == "u" else d.qcoeff_v for d in ds]
        pred = _select_by(keys, lambda k: _predict_cand(
            k[0], k[1], m, above, left, corner, ext[0], ext[1], ha, hl, bd))
        dq = quant.dequantize(torch.as_tensor(
            np.stack([np.asarray(q, np.int32) for q in lv]), device=dev), qp,
            t_sz)
        out = _select_by(tx_types, lambda t: tf.inv_txfm2d_add(
            dq, pred, t, t_sz, bd=bd))
        _scatter_blocks(rec[p], out, fl, ys, xs, ar)
