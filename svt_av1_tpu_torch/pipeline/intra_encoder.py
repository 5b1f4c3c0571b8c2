"""Intra (key) frame encoder: wave-batched mode decision + reconstruction.

Port of svt_av1_tpu/pipeline/intra_encoder.py for the all-intra slice
(presets M10-M13: fixed 16x16 luma / 8x8 chroma blocks, luma modes
DC/V/H/SMOOTH/PAETH/D135 with DCT_DCT, chroma DC/V/H/SMOOTH with their
implied transform types, no tx search, angle deltas, CfL, filter-intra,
palette, RDOQ or AQ).

The frame's 16x16 blocks are batched along 2:1 wavefronts (wave
k = 2*by + bx): every neighbor a block reads lies in an earlier wave.
Each wave runs one luma step (gather neighbors -> predict every mode ->
transform + quantize -> rate + distortion -> pick -> normative inverse
-> scatter) and one joint U+V chroma step.  The reference vmaps its
frame program over a batch of frames; here the frame axis is written
out, so a wave's batch is F frames x maxb slots (x modes), and the wave
loop is a plain Python loop of eager PyTorch ops.  Slots past a wave's
end are computed like the reference's and never written back.

Recon planes are updated in place (``_scatter_blocks``).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from svt_av1_tpu.codec import constants as cc

from svt_av1_tpu_torch import device as device_mod
from svt_av1_tpu_torch.codec.rate_est import md_rate_args
from svt_av1_tpu_torch.ops import fused_txq, intra, quant
from svt_av1_tpu_torch.ops import transforms as tf
from svt_av1_tpu_torch.ops.coef_rate import CoefTables, txb_bits_exact

# luma candidates the slice supports (presets M10/M11 use all six,
# M12/M13 the first four)
MODES = (cc.DC_PRED, cc.V_PRED, cc.H_PRED, cc.SMOOTH_PRED, cc.PAETH_PRED,
         cc.D135_PRED)
# chroma mode set; each uses its implied (unsignaled) transform type
UV_MODES = (cc.DC_PRED, cc.V_PRED, cc.H_PRED, cc.SMOOTH_PRED)
UV_TX_TYPES = (cc.DCT_DCT, cc.ADST_DCT, cc.DCT_ADST, cc.ADST_ADST)
BLK = 16
CBLK = 8


def cand_angle(mode: int, delta: int) -> int:
    """Prediction angle of a candidate (0 = non-directional)."""
    if cc.V_PRED <= mode <= cc.D67_PRED:
        return intra.MODE_TO_ANGLE[mode] + 3 * delta
    return 0


def _predict_cand(mode, delta, n, above, left, corner, have_above,
                  have_left, bd):
    """Prediction for one (mode, angle_delta) candidate; the zone comes
    from the final angle (spec §7.11.2).  Zones 1 and 3, filter-intra and
    angle deltas are not in this slice."""
    angle = cand_angle(mode, delta)
    if mode >= cc.FI_MODE_BASE or delta or (
            angle and (angle < 90 or angle > 180)):
        raise NotImplementedError(
            f"candidate (mode {mode}, delta {delta}) needs zone-1/3, "
            "filter-intra or angle deltas: ROADMAP.md queue A item 2 (M6)")
    if angle and angle != 90 and angle != 180:
        return intra.z2_pred(above, left, corner, n, n, angle)
    return intra.predict(mode, above, left, corner, n, n,
                         have_above=have_above, have_left=have_left, bd=bd)


@functools.lru_cache(maxsize=None)
def _scan_pos(tx_size: int) -> np.ndarray:
    """(n, n) scan position of each coefficient (inverse default scan)."""
    from svt_av1_tpu.codec import tables as tb
    scan = np.asarray(tb.get_scan(tx_size, cc.DCT_DCT))
    pos = np.zeros(scan.shape[0], np.int32)
    pos[scan] = np.arange(scan.shape[0], dtype=np.int32)
    n = int(np.sqrt(scan.shape[0]))
    return pos.reshape(n, n)


@functools.lru_cache(maxsize=None)
def _scan_pos_on(tx_size: int, device) -> torch.Tensor:
    return torch.as_tensor(_scan_pos(tx_size), device=device)


@functools.lru_cache(maxsize=None)
def _ids_on(ids: tuple, device) -> torch.Tensor:
    """Mode ids as an int32 tensor (built once per device)."""
    return torch.as_tensor(ids, dtype=torch.int32, device=device)


def _txb_bits(qcoeff_abs, coef_bits, base, eob_tbl, pos):
    """Transform-block rate: the context-exact model when ``coef_bits``
    is a CoefTables bundle (M10), else the analytic curve (M11-M13):
    2*log2(1+l) + 1 per nonzero level, the zero-symbol cost for zeros
    before eob, the eob-position cost and the txb flag."""
    if isinstance(coef_bits, CoefTables):
        return txb_bits_exact(qcoeff_abs, coef_bits, qcoeff_abs.shape[-1])
    nzm = qcoeff_abs > 0
    eob = torch.where(nzm, pos + 1, 0).amax(dim=(1, 2))
    af = qcoeff_abs.to(torch.float32)
    nz_cnt = nzm.sum(dim=(1, 2)).to(torch.float32)
    nz_bits = 2.0 * torch.log2(1.0 + af).sum(dim=(1, 2)) + nz_cnt
    zeros_before = eob.to(torch.float32) - nz_cnt
    return nz_bits + zeros_before * coef_bits[0] + eob_tbl[eob.long()] + base


def _morton(r: int, c: int) -> int:
    """z-order (coding order) index of a block within its superblock."""
    return (((r & 2) << 2) | ((c & 2) << 1) | ((r & 1) << 1) | (c & 1))


def tr_bl_avail(by: int, bx: int, gh: int, gw: int, m: int = 4):
    """(top-right, bottom-left) reconstructed-sample availability for a
    square block in the 64x64-SB z-order of a one-tile frame (a neighbor
    is available iff its coding order precedes ours).  (by, bx) index the
    block's own-size grid; ``m`` is blocks per SB side."""
    r, c = by & (m - 1), bx & (m - 1)
    if by == 0 or bx + 1 >= gw:
        tr = False
    elif r == 0:
        tr = True
    elif c == m - 1:
        tr = False
    else:
        tr = _morton(r - 1, c + 1) < _morton(r, c)
    if bx == 0 or by + 1 >= gh:
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


def _schedule_arrays(gh, gw, maxb):
    """Wave schedule + per-slot availability, each (n_waves, maxb), for a
    frame of one tile."""
    waves = _wave_schedule(gh, gw, maxb)
    nw = len(waves)
    bys = np.zeros((nw, maxb), np.int32)
    bxs = np.zeros((nw, maxb), np.int32)
    valid = np.zeros((nw, maxb), bool)
    trs = np.zeros((nw, maxb), bool)
    bls = np.zeros((nw, maxb), bool)
    hls = np.zeros((nw, maxb), bool)
    for i, wave in enumerate(waves):
        nb = len(wave)
        bys[i, :nb] = [b[0] for b in wave]
        bxs[i, :nb] = [b[1] for b in wave]
        valid[i, :nb] = True
        for j, (by, bx) in enumerate(wave):
            trs[i, j], bls[i, j] = tr_bl_avail(by, bx, gh, gw)
            hls[i, j] = bx > 0
    return waves, bys, bxs, valid, trs, bls, hls


class WaveSlots(NamedTuple):
    """One wave's batch over F frames (batch element b = f*maxb + j), as
    device tensors: frame index ``fi``, block coordinates ``by``/``bx``
    (in 16x16 units), neighbor availability ``ha``/``hl``, the batch
    indices ``sel`` of the slots that hold a block, and their raster ids
    ``rid`` (f*gh*gw + by*gw + bx)."""
    fi: torch.Tensor
    by: torch.Tensor
    bx: torch.Tensor
    ha: torch.Tensor
    hl: torch.Tensor
    sel: torch.Tensor
    rid: torch.Tensor


@functools.lru_cache(maxsize=16)
def _device_schedule(gh: int, gw: int, nf: int, device):
    """The static wave schedule for an F-frame batch, as WaveSlots."""
    maxb = _natural_maxb(gh, gw)
    _, bys, bxs, valid, _, _, hls = _schedule_arrays(gh, gw, maxb)
    t = lambda a, dt=torch.int64: torch.as_tensor(np.ascontiguousarray(a),
                                                  dtype=dt, device=device)
    fi = np.repeat(np.arange(nf), maxb)
    out = []
    for i in range(bys.shape[0]):
        by = np.tile(bys[i], nf)
        bx = np.tile(bxs[i], nf)
        va = np.tile(valid[i], nf)
        sel = np.nonzero(va)[0]
        rid = fi[sel] * gh * gw + by[sel] * gw + bx[sel]
        out.append(WaveSlots(t(fi), t(by), t(bx), t((by > 0) & va,
                                                      torch.bool),
                             t(np.tile(hls[i], nf) & va, torch.bool),
                             t(sel), t(rid)))
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


def _rd_step(recon, src, fi, ys, xs, sel, have_above, have_left, qp, lam,
             modes, rates, bd=8):
    """One luma wave step over 16x16 blocks: every candidate mode of every
    slot through
    predict -> transform + quantize -> rate + distortion, the cheapest
    per slot kept, its normative reconstruction written into ``recon``
    (in place) for the slots ``sel``.

    recon/src: (F, H, W) int32; fi/ys/xs: (B,) frame index and pixel
    coordinates; qp: QuantParams tensors; lam: float32 scalar tensor;
    rates: (coef_bits, txb_base, mode_bits, eob_tbl).  Returns
    (best_mode (B,) int32, best_q (B, n, n) int32, recon).

    The 16x16 DCT_DCT transform + quantizer runs through
    ops/fused_txq: the hand-written CUDA kernel for tensors on the card,
    its plain version on the CPU (the reference takes its Pallas kernel
    under the same conditions on the TPU)."""
    n, tx_size = BLK, cc.TX_16X16
    b = ys.shape[0]
    above, left, corner = _gather_neighbors(recon, fi, ys, xs, n,
                                            have_above, have_left, bd=bd)
    src_blk = _gather_block(src, fi, ys, xs, n, n)
    preds = [_predict_cand(m, 0, n, above, left, corner, have_above,
                           have_left, bd) for m in modes]
    nm = len(modes)
    pred_all = torch.cat(preds, dim=0)                 # (nm*B, n, n)
    src_all = src_blk.repeat(nm, 1, 1)
    resid_all = (src_all - pred_all).contiguous()
    coeffs, qcoeff_all, dq_all = fused_txq.fused_txq(resid_all, qp)
    # transform-domain distortion: pixel SSE ~ s2 * coeff-error SSE; the
    # normative inverse runs only for the winner below
    s2 = float(np.float32(tf.coeff_sse_scale(tx_size, cc.DCT_DCT)))
    err = coeffs.to(torch.float32) - dq_all.to(torch.float32)
    dist = s2 * (err * err).sum(dim=(1, 2))
    coef_bits, txb_base, mode_bits, eob_tbl = rates
    bits = (_txb_bits(qcoeff_all.abs(), coef_bits, txb_base[0], eob_tbl,
                      _scan_pos_on(tx_size, recon.device))
            + mode_bits[:, None].expand(nm, b).reshape(-1))
    cost = (dist + lam * bits).reshape(nm, b)
    mi_best = cost.argmin(dim=0)                        # first minimum
    ar = torch.arange(b, device=recon.device)
    best_mode = _ids_on(tuple(modes), recon.device)[mi_best]
    best_q = qcoeff_all.reshape(nm, b, n, n)[mi_best, ar]
    best_dq = dq_all.reshape(nm, b, n, n)[mi_best, ar]
    best_pred = pred_all.reshape(nm, b, n, n)[mi_best, ar]
    best_rec = tf.inv_txfm2d_add(best_dq, best_pred, cc.DCT_DCT, tx_size,
                                 bd=bd)
    _scatter_blocks(recon, best_rec, fi, ys, xs, sel)
    return best_mode, best_q, recon


def _rd_step_chroma(recon_u, recon_v, src_u, src_v, fi, ys, xs, sel,
                    have_above, have_left, qp, lam, rates, bd=8):
    """Joint U+V mode decision for one wave (uv_mode is signaled once per
    block; the chroma transform type is implied by the mode).  Every
    (mode, plane) pair runs its forward transform, quantizer and the
    normative inverse; distortion is the true pixel SSE.  Writes the
    winners into recon_u/recon_v in place for the slots ``sel``.
    Returns (uv_mode (B,), q_u, q_v, recon_u, recon_v)."""
    n, tx_size = CBLK, cc.TX_8X8
    nb_u = _gather_neighbors(recon_u, fi, ys, xs, n, have_above, have_left,
                             bd=bd)
    nb_v = _gather_neighbors(recon_v, fi, ys, xs, n, have_above, have_left,
                             bd=bd)
    src_ub = _gather_block(src_u, fi, ys, xs, n, n)
    src_vb = _gather_block(src_v, fi, ys, xs, n, n)
    b = ys.shape[0]
    nm = len(UV_MODES)
    preds = []
    for mode in UV_MODES:
        for above, left, corner in (nb_u, nb_v):
            preds.append(intra.predict(mode, above, left, corner, n, n,
                                       have_above=have_above,
                                       have_left=have_left, bd=bd))
    pred_all = torch.cat(preds, dim=0)                 # (nm*2*B, n, n)
    src_all = torch.cat([src_ub, src_vb], dim=0).repeat(nm, 1, 1)
    resid_all = src_all - pred_all
    qcs, recs = [], []
    for mi, tx_type in enumerate(UV_TX_TYPES):
        sl = slice(mi * 2 * b, (mi + 1) * 2 * b)
        coeffs = tf.fwd_txfm2d(resid_all[sl], tx_type, tx_size)
        qc, dq = quant.quantize(coeffs, qp, tx_size)
        recs.append(tf.inv_txfm2d_add(dq, pred_all[sl], tx_type, tx_size,
                                      bd=bd))
        qcs.append(qc)
    qcoeff_all = torch.cat(qcs, dim=0)
    rec_all = torch.cat(recs, dim=0)
    d = rec_all - src_all
    dist = (d * d).sum(dim=(1, 2)).to(torch.float32)
    coef_bits, txb_base, uv_bits, eob_tbl = rates
    bits = _txb_bits(qcoeff_all.abs(), coef_bits, txb_base[1], eob_tbl,
                     _scan_pos_on(tx_size, recon_u.device))
    cost_uv = (dist + lam * bits).reshape(nm, 2, b).sum(dim=1)
    cost_uv = cost_uv + lam * uv_bits[:, None]
    mi_best = cost_uv.argmin(dim=0)
    ar = torch.arange(b, device=recon_u.device)
    qall = qcoeff_all.reshape(nm, 2, b, n, n)
    rall = rec_all.reshape(nm, 2, b, n, n)
    um = _ids_on(UV_MODES, recon_u.device)[mi_best]
    qu, qv = qall[mi_best, 0, ar], qall[mi_best, 1, ar]
    _scatter_blocks(recon_u, rall[mi_best, 0, ar], fi, ys, xs, sel)
    _scatter_blocks(recon_v, rall[mi_best, 1, ar], fi, ys, xs, sel)
    return um, qu, qv, recon_u, recon_v


def frame_program(sy, su, sv, qp, lam, rates, modes, bd=8):
    """Whole-frame MD for a batch of F frames: a Python loop over the
    waves, each running the luma and the chroma step on F x maxb slots.

    sy: (F, H, W), su/sv: (F, H/2, W/2) uint8 tensors; rates: the
    md_rate_args tuple on the same device.  Returns (recon_y, recon_u,
    recon_v) uint8 and, in raster block order, y modes / uv modes
    (F, gh*gw) uint8 and levels qy (F, gh*gw, 256), qu/qv (F, gh*gw, 64)
    int16 (levels of 16x16/8x8 transforms fit: |level| <= 32767 /
    dequant_min <= 16384)."""
    nf, h, w = sy.shape
    gh, gw = h // BLK, w // BLK
    dev = sy.device
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
    cy_t, cuv_t, txbb, modeb, uvb, eoby, eobuv = rates[:7]
    for ws in _device_schedule(gh, gw, nf, dev):
        m, q, _ = _rd_step(recon_y, src_y, ws.fi, ws.by * BLK, ws.bx * BLK,
                           ws.sel, ws.ha, ws.hl, qp, lam, modes,
                           (cy_t, txbb, modeb, eoby), bd=bd)
        uvm, q_u, q_v, _, _ = _rd_step_chroma(
            recon_u, recon_v, src_u, src_v, ws.fi, ws.by * CBLK,
            ws.bx * CBLK, ws.sel, ws.ha, ws.hl, qp, lam,
            (cuv_t, txbb, uvb, eobuv), bd=bd)
        ym[ws.rid] = m[ws.sel].to(torch.uint8)
        um[ws.rid] = uvm[ws.sel].to(torch.uint8)
        qy[ws.rid] = q[ws.sel].reshape(-1, BLK * BLK).to(torch.int16)
        qu[ws.rid] = q_u[ws.sel].reshape(-1, CBLK * CBLK).to(torch.int16)
        qv[ws.rid] = q_v[ws.sel].reshape(-1, CBLK * CBLK).to(torch.int16)
    return (recon_y.to(torch.uint8), recon_u.to(torch.uint8),
            recon_v.to(torch.uint8), ym.reshape(nf, -1),
            um.reshape(nf, -1), qy.reshape(nf, gh * gw, -1),
            qu.reshape(nf, gh * gw, -1), qv.reshape(nf, gh * gw, -1))


@functools.lru_cache(maxsize=32)
def _rate_args(qindex: int, modes: tuple, exact: bool, device):
    return md_rate_args(qindex, modes, UV_MODES, exact=exact, device=device)


def frame_lambda(qindex: int, bd: int = 8) -> np.float32:
    """MD Lagrangian 0.7 * (dc step / 8)^2, in float32."""
    qstep = quant.dc_q(qindex, bd=bd) / 8.0
    return np.float32(0.7 * qstep * qstep)


def encode_intra_frames_launch(frames, qindex: int, modes=MODES,
                               bd: int = 8, exact_rates: bool = False,
                               device=None):
    """Enqueue the batched frame program for frames = [(y, u, v), ...]
    (numpy, same dims, multiples of 16).  On CUDA the work runs
    asynchronously; pair with encode_intra_frames_finish, so the host
    can entropy-code the previous batch meanwhile."""
    if bd != 8:
        raise NotImplementedError("10-bit: ROADMAP.md queue A item 7")
    bad = [m for m in modes if m not in MODES]
    if bad:
        raise NotImplementedError(
            f"luma modes {bad} are not in the M10-M13 slice: ROADMAP.md "
            "queue A item 2 (M6)")
    h, w = frames[0][0].shape
    if h % BLK or w % BLK:
        raise ValueError(f"frame {w}x{h} is not a multiple of {BLK}")
    dev = device_mod.resolve(device)
    qp = quant.to_device(quant.make_quant_params(qindex, bd=bd), dev)
    lam = torch.tensor(frame_lambda(qindex, bd), dtype=torch.float32,
                       device=dev)
    planes = [torch.from_numpy(np.stack([f[p] for f in frames])
                               .astype(np.uint8)).to(dev)
              for p in range(3)]
    rt = _rate_args(int(qindex), tuple(modes), bool(exact_rates), dev)
    out = frame_program(*planes, qp, lam, rt, tuple(modes), bd=bd)
    return (out, h // BLK, w // BLK, len(frames))


def encode_intra_frames_finish(pending):
    """Bring a launched batch to the host: [((ym, um, qy, qu, qv, gh,
    gw), recon), ...] per frame, the array bundle the native tile coder
    takes, with recon = dict(y, u, v) uint8."""
    out, gh, gw, nf = pending
    ry, ru, rv, ym, um, qy, qu, qv = (o.cpu().numpy() for o in out)
    return [((ym[i], um[i], qy[i], qu[i], qv[i], gh, gw),
             dict(y=ry[i], u=ru[i], v=rv[i])) for i in range(nf)]


def apply_loop_filter(recon, fp):
    """In-loop deblocking.  The slice codes with DLF off (level 0), where
    this returns its input; DLF is ROADMAP.md queue A item 3."""
    if fp.filter_level[0] or fp.filter_level[1] or any(fp.filter_level_uv):
        raise NotImplementedError("DLF: ROADMAP.md queue A item 3")
    return recon


def reconstruct_from_decisions(decisions, width: int, height: int,
                               qindex: int, bd: int = 8, device=None):
    """Decoder-side reconstruction from parsed BlockDecisions of a key
    frame coded on the uniform 16x16 grid (the slice's streams).

    The reference walks superblocks in z-order block by block; on this
    grid the encoder's 2:1 wave order is a valid order too (every sample
    a block predicts from lies in an earlier wave, and availability
    depends on position only), so the blocks of one wave are
    reconstructed as one batch, with the decoded modes and levels.
    Returns dict(y, u, v) uint8 numpy planes."""
    from svt_av1_tpu.codec.syntax import _chroma_tx_type
    dev = device_mod.resolve(device)
    gh, gw = height // BLK, width // BLK
    nb = gh * gw
    ym = np.zeros(nb, np.int64)
    um = np.zeros(nb, np.int64)
    qy = np.zeros((nb, BLK, BLK), np.int32)
    qu = np.zeros((nb, CBLK, CBLK), np.int32)
    qv = np.zeros((nb, CBLK, CBLK), np.int32)
    seen = np.zeros(nb, bool)
    for (r4, c4), d in decisions.items():
        if (d.bsize != cc.BLOCK_16X16 or d.tx_type != cc.DCT_DCT
                or d.filter_intra_mode >= 0 or d.angle_delta_y
                or getattr(d, "palette", None) is not None
                or d.uv_mode == cc.UV_CFL_PRED
                or d.qindex not in (0, qindex) or r4 % 4 or c4 % 4):
            raise NotImplementedError(
                f"block at ({r4}, {c4}) uses a tool outside the all-intra "
                "M10-M13 slice (varpart, tx types, angle deltas, CfL, "
                "filter-intra, palette or AQ): ROADMAP.md queue A")
        bid = (r4 // 4) * gw + c4 // 4
        ym[bid], um[bid] = d.y_mode, d.uv_mode
        qy[bid], qu[bid], qv[bid] = d.qcoeff_y, d.qcoeff_u, d.qcoeff_v
        seen[bid] = True
    if not seen.all():
        raise ValueError("decisions do not cover the 16x16 grid")
    qp = quant.to_device(quant.make_quant_params(qindex, bd=bd), dev)
    rec = dict(y=torch.zeros((1, height, width), dtype=torch.int32,
                             device=dev),
               u=torch.zeros((1, height // 2, width // 2),
                             dtype=torch.int32, device=dev))
    rec["v"] = torch.zeros_like(rec["u"])
    lvl = dict(y=torch.as_tensor(qy, device=dev),
               u=torch.as_tensor(qu, device=dev),
               v=torch.as_tensor(qv, device=dev))
    for ws in _device_schedule(gh, gw, 1, dev):
        rid = ws.rid.cpu().numpy()
        sel = ws.sel
        for p in ("y", "u", "v"):
            luma = p == "y"
            n = BLK if luma else CBLK
            tx = cc.TX_16X16 if luma else cc.TX_8X8
            modes = ym[rid] if luma else um[rid]
            above, left, corner = _gather_neighbors(
                rec[p], ws.fi[sel], ws.by[sel] * n, ws.bx[sel] * n, n,
                ws.ha[sel], ws.hl[sel], bd=bd)
            dq = quant.dequantize(lvl[p][ws.rid], qp, tx)
            pred = None
            recon = None
            for m in np.unique(modes):
                take = torch.as_tensor(modes == m, device=dev)[:, None,
                                                               None]
                pm = _predict_cand(int(m), 0, n, above, left, corner,
                                   ws.ha[sel], ws.hl[sel], bd)
                pred = pm if pred is None else torch.where(take, pm, pred)
            tx_types = ([cc.DCT_DCT] * len(rid) if luma else
                        [_chroma_tx_type(int(m), tx) for m in modes])
            for t in sorted(set(tx_types)):
                take = torch.as_tensor(np.array(tx_types) == t,
                                       device=dev)[:, None, None]
                r = tf.inv_txfm2d_add(dq, pred, t, tx, bd=bd)
                recon = r if recon is None else torch.where(take, r, recon)
            ar = torch.arange(len(rid), device=dev)
            _scatter_blocks(rec[p], recon, ws.fi[sel], ws.by[sel] * n,
                            ws.bx[sel] * n, ar)
    return {p: rec[p][0].to(torch.uint8).cpu().numpy()
            for p in ("y", "u", "v")}
