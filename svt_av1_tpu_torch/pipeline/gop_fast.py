"""Fast hierarchical-GOP pipeline: the two programs of an inter frame, the
PyTorch port of svt_av1_tpu/pipeline/gop_fast.py (presets M5-M13).

Each inter frame runs as

  P1 "md"      — per-reference HME -> global-motion fit (device least
                 squares + normative shear/quantization) -> warped
                 reference -> frame interp-filter pick -> pass A over all
                 references and candidates (gm / subpel ring / neighbour
                 MVs; at M5-M8 the inter tx-type search on the winner, at
                 M5-M6 the 8x8 split alternative), merged on the device ->
                 compound pairs (average, wedge, diffwtd, the skip-mode
                 pair) -> pass B: the intra wave loop with the inter
                 candidate as an override (at M5-M8 first priced against
                 its OBMC and inter-intra alternatives; the luma step's
                 transform + quantizer is K1, ops/fused_txq) -> dense
                 per-block decisions, 32x32/64x64/rect merges and the
                 unfiltered recon.
  P2 "filters" — DLF ladder search + apply with the mask-aware edge
                 enables (at 8-px granularity where blocks split), CDEF
                 direction search, per-SB / per-candidate SSE, the
                 frame-uniform pick and the apply.
  host         — one bundled copy of the decision arrays, entropy coding.

Here a "program" is a Python function of eager PyTorch ops on one device:
every tensor of a frame stays there (the final recon is the DPB entry of
later frames), and the copies the host needs are issued, non-blocking,
when the frame has been dispatched.  Pass B is a Python loop over the
2:1 waves (the reference's fori_loop); nothing in it reads a value back
to the host.

Float parts: the GM fit is float32 least squares (sums in the order the
device picks, held to a tie rule against the reference); the frame-wide
interp-pick SSE and the filter SSEs are exact int64 sums here (the
reference sums in float32); RD costs are float32 as in the reference.
One departure from the reference, where it departs from the AV1
specification: an OBMC candidate next to an 8x8 split neighbour blends
that neighbour per 8-px segment with the sub MVs that touch the block
(spec 7.11.3.10), as a decoder does; the reference leaves the neighbour
out (ROADMAP.md queue C item 4).  1/8-pel MVs (hp_mv, off at every
preset) raise.
"""
from __future__ import annotations

import functools
from typing import Dict

import numpy as np
import torch

from svt_av1_tpu_torch import device as device_mod
from svt_av1_tpu_torch.codec import constants as cc
from svt_av1_tpu_torch.codec.rate_est import md_rate_args
from svt_av1_tpu_torch.ops import cdef as cdef_ops
from svt_av1_tpu_torch.ops import dlf as dlf_ops
from svt_av1_tpu_torch.ops import interintra as ii_ops
from svt_av1_tpu_torch.ops import intra as intra_ops
from svt_av1_tpu_torch.ops import obmc as obmc_ops
from svt_av1_tpu_torch.ops import mc, quant, transforms as tf
from svt_av1_tpu_torch.ops import warp as warp_ops
from svt_av1_tpu_torch.ops import wedge as wedge_ops
from svt_av1_tpu_torch.pipeline import cdef_stage
from svt_av1_tpu_torch.pipeline import me as me_pipe
from svt_av1_tpu_torch.pipeline import tpl as tpl_mod
from svt_av1_tpu_torch.pipeline.dlf_stage import _ladder, default_filter_level
from svt_av1_tpu_torch.pipeline.inter_encoder import _SUBPEL_RING, _mv_bits
from svt_av1_tpu_torch.pipeline.intra_encoder import (
    BLK, CBLK, II_TO_INTRA, UV_MODES, _device_schedule, _gather_neighbors,
    _rd_step, _rd_step_chroma, _scan_pos_on, _txb_bits, frame_lambda)

WM = 1 << 16  # WARPEDMODEL_PREC_BITS unit
# named ranges of the two programs, read by torch.profiler
# (tools/profile_torch_encode.py --gop); without a profiler they cost a
# few microseconds each
_region = torch.profiler.record_function
NLVL = 5      # DLF ladder size (padded to a fixed length)
HP_MV = ("1/8-pel MVs (hp_mv, off at every preset): not ported yet "
         "(ROADMAP.md queue A item 7)")

# extra luma tx types searched on inter winners (beyond DCT_DCT); they
# share the TX_16X16 default scan, so one rate table serves all
ITX_SEARCH_SET = (cc.ADST_ADST, cc.ADST_DCT, cc.DCT_ADST)
_ITX_ENUM = (cc.DCT_DCT,) + ITX_SEARCH_SET   # tx index -> tx_type
# per-type signaling delta over DCT_DCT under the TX_16X16 inter set's
# default CDF, aligned with ITX_SEARCH_SET
_ITX_EXTRA_BITS = (1.62, 1.40, 1.31)
# 8x8 split overhead over one 16x16 leaf (the SPLIT symbol, four NONE
# symbols and three more per-sub headers; static estimate)
_SPLIT_EXTRA_BITS = 18.0
# masked-compound syntax overhead over the plain average (static
# estimates from the default CDFs, as in the reference)
_WEDGE_EXTRA_BITS = 6.0
_DIFFWTD_EXTRA_BITS = 3.0
# the OBMC motion-mode flag and the inter-intra flag + mode over their
# flag-0 sides
_OBMC_FLAG_BITS = 1.2
_II_EXTRA_BITS = 3.0


def _t(a, dev, dtype=torch.int32):
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)


# --------------------------------------------------------------------------
# device global-motion estimation
# --------------------------------------------------------------------------

def _rpot_signed_t(v, n):
    """round_power_of_two_signed with a tensor shift."""
    m = (v.abs() + (1 << (n - 1))) >> n
    return torch.where(v < 0, -m, m)


def _rpot_signed_wide(p, y, s):
    """round_power_of_two_signed(p * y, s) for a product past int32: the
    product is formed in int64 (the reference emulates it in two 32-bit
    limbs, which gives the same value)."""
    v = p.to(torch.int64) * y.to(torch.int64)
    m = (v.abs() + (1 << (s.to(torch.int64) - 1))) >> s.to(torch.int64)
    return torch.where(v < 0, -m, m).to(torch.int32)


def _msb_int(d, maxbit=18):
    """floor(log2(d)) for 1 <= d < 2^maxbit."""
    acc = torch.zeros_like(d)
    for k in range(1, maxbit + 1):
        acc = acc + (d >= (1 << k)).to(d.dtype)
    return acc


@functools.lru_cache(maxsize=None)
def _div_lut_on(device):
    return torch.as_tensor(warp_ops._div_lut(), device=device)


def _shear_device(mat):
    """(alpha, beta, gamma, delta, valid) of a device wmmat
    (svt_get_shear_params, warped_motion.c:298-360)."""
    div_lut = _div_lut_on(mat.device)
    alpha = (mat[2] - WM).clamp(-32768, 32767)
    beta = mat[3].clamp(-32768, 32767)
    d = mat[2].abs().clamp(min=1)
    shift = _msb_int(d)
    e = d - (1 << shift)
    hi = (e + (1 << (shift - 9).clamp(min=0))) >> (shift - 8).clamp(min=0)
    lo = e << (8 - shift).clamp(min=0)
    f = torch.where(shift > 8, hi, lo)
    y = div_lut[f.clamp(0, 256).long()]
    shift_t = shift + 14
    gamma = _rpot_signed_t(mat[4] * y, shift_t - 16).clamp(-32768, 32767)
    dterm = _rpot_signed_wide(mat[3] * mat[4], y, shift_t)
    delta = (mat[5] - dterm - WM).clamp(-32768, 32767)
    rb = warp_ops.WARP_PARAM_REDUCE_BITS
    alpha = _rpot_signed_t(alpha, rb) << rb
    beta = _rpot_signed_t(beta, rb) << rb
    gamma = _rpot_signed_t(gamma, rb) << rb
    delta = _rpot_signed_t(delta, rb) << rb
    valid = ((mat[2] > 0)
             & (4 * alpha.abs() + 7 * beta.abs() < WM)
             & (4 * gamma.abs() + 4 * delta.abs() < WM))
    return alpha, beta, gamma, delta, valid


def _median(x, keep=None):
    """Median as the reference takes it (the mean of the two middle
    values for an even count); with ``keep``, over the kept entries only
    (nanmedian).  No value leaves the device."""
    if keep is None:
        s = torch.sort(x).values
        n = x.shape[0]
        return 0.5 * s[(n - 1) // 2] + 0.5 * s[n // 2]
    s = torch.sort(torch.where(keep, x, torch.inf)).values
    k = keep.sum()
    lo = ((k - 1).clamp(min=0) // 2)
    hi = k // 2
    return 0.5 * s[lo] + 0.5 * s[hi.clamp(max=x.shape[0] - 1)]


def _gm_fit(mv_y, mv_x, gh, gw, dtype=torch.float32, raw=False):
    """Device GM fit from the HME field: (mat (6,) int32, trans (2,) int32
    in 1/8 pel, kind int32: 0 IDENTITY, 1 TRANSLATION, 2 ROTZOOM).

    A centered closed-form least squares of a rotation-zoom model with
    two trimmed refits, quantized to the coded grids, with a translation
    fallback (median + inlier mean).  The encoder runs float32, as the
    reference does.  ``raw`` also returns the six values that are rounded
    to the coded grids (with ``dtype`` float64: the values the tie rule
    measures rounding boundaries against)."""
    dev = mv_y.device
    dy = mv_y.to(dtype).reshape(-1)
    dx = mv_x.to(dtype).reshape(-1)
    n = gh * gw
    ysc = (np.arange(gh) * BLK + BLK // 2).astype(np.float32)
    xsc = (np.arange(gw) * BLK + BLK // 2).astype(np.float32)
    px = torch.as_tensor(np.tile(xsc, gh), device=dev).to(dtype)
    py = torch.as_tensor(np.repeat(ysc, gw), device=dev).to(dtype)

    def fit(wsel):
        wsum = wsel.sum().clamp(min=1.0)
        mx = (px * wsel).sum() / wsum
        my = (py * wsel).sum() / wsum
        cx = px - mx
        cy = py - my
        s = ((cx * cx + cy * cy) * wsel).sum() + 1e-6
        a = ((cx * dx + cy * dy) * wsel).sum() / s
        b = ((cy * dx - cx * dy) * wsel).sum() / s
        txp = (dx * wsel).sum() / wsum
        typ = (dy * wsel).sum() / wsum
        tx = txp - a * mx - b * my
        ty = typ + b * mx - a * my
        resx = a * px + b * py + tx - dx
        resy = -b * px + a * py + ty - dy
        return a, b, tx, ty, torch.sqrt(resx * resx + resy * resy)

    ones = torch.ones(n, dtype=dtype, device=dev)
    _, _, _, _, r0 = fit(ones)
    thr = torch.clamp(_median(r0) * 2.0, min=1.5)
    keep = (r0 <= thr).to(dtype)
    keep = torch.where(keep.sum() >= 8, keep, ones)
    _, _, _, _, r1 = fit(keep)
    med1 = _median(r1, keep > 0)
    thr2 = torch.clamp(med1 * 2.0, min=1.0)
    keep2 = keep * (r1 <= thr2).to(dtype)
    a, b, tx, ty, _ = fit(torch.where(keep2.sum() >= 8, keep2, keep))
    rounded = [(1.0 + a) * WM / 2, b * WM / 2, tx * 64, ty * 64]
    mat2 = (torch.round(rounded[0]) * 2).to(torch.int32).clamp(
        WM - 8190, WM + 8190)
    mat3 = (torch.round(rounded[1]) * 2).to(torch.int32).clamp(-8190, 8190)
    mat0 = (torch.round(rounded[2]) * 1024).to(torch.int32).clamp(
        -(4095 << 10), 4095 << 10)
    mat1 = (torch.round(rounded[3]) * 1024).to(torch.int32).clamp(
        -(4095 << 10), 4095 << 10)
    mat = torch.stack([mat0, mat1, mat2, mat3, -mat3, mat2])
    span = float(np.float32(max(gh, gw) * BLK))
    rot_sig = (a.abs() * span >= 0.7) | (b.abs() * span >= 0.7)
    shear_ok = _shear_device(mat)[4]
    non_ident = ~((mat2 == WM) & (mat3 == 0))
    rot_ok = rot_sig & shear_ok & non_ident
    med_y = _median(dy)
    med_x = _median(dx)
    inl = (((dy - med_y).abs() <= 1.5)
           & ((dx - med_x).abs() <= 1.5)).to(dtype)
    frac = inl.sum() / float(n)
    isum = inl.sum().clamp(min=1.0)
    rounded += [(dy * inl).sum() / isum, (dx * inl).sum() / isum]
    tr = (torch.round(rounded[4]) * 8).clamp(-504, 504).to(torch.int32) & ~1
    tc = (torch.round(rounded[5]) * 8).clamp(-504, 504).to(torch.int32) & ~1
    tr_ok = (((med_y.abs() >= 1) | (med_x.abs() >= 1)) & (frac >= 0.4)
             & ((tr != 0) | (tc != 0)))
    kind = torch.where(rot_ok, 2, torch.where(tr_ok, 1, 0)).to(torch.int32)
    trans = torch.where(kind == 1, torch.stack([tr, tc]),
                        torch.zeros(2, dtype=torch.int32, device=dev))
    ident = _t([0, 0, WM, 0, 0, WM], dev)
    mat = torch.where(kind == 2, mat, ident)
    if raw:
        return mat, trans, kind, torch.stack(rounded)
    return mat, trans, kind


def _gm_block_mvs(mat, gh, gw):
    """(nb, 2) int32 1/8-pel block-center projections of a gm model on the
    16x16 grid (gm_block_mv at quarter-pel precision: shift 14, doubled)."""
    dev = mat.device
    nb = gh * gw
    x = _t(np.arange(nb) % gw * BLK + BLK // 2 - 1, dev)
    y = _t(np.arange(nb) // gw * BLK + BLK // 2 - 1, dev)
    xc = (mat[2] - WM) * x + mat[3] * y + mat[0]
    yc = mat[4] * x + (mat[5] - WM) * y + mat[1]
    return torch.stack([_rpot_signed_t(yc, 14) * 2,
                        _rpot_signed_t(xc, 14) * 2], dim=-1)


def _warp_plane_traced(ref, mat, shear, p_w, p_h, bd, ss):
    """Whole-plane warped prediction with device wmmat/shear parameters
    (warp_plane's filter, bit-exact)."""
    dev = ref.device
    gbh, gbw = p_h // 8, p_w // 8
    nb = gbh * gbw
    src_x = _t(((np.arange(nb) % gbw) * 8 + 4) << ss, dev)
    src_y = _t(((np.arange(nb) // gbw) * 8 + 4) << ss, dev)
    dst_x = mat[2] * src_x + mat[3] * src_y + mat[0]
    dst_y = mat[4] * src_x + mat[5] * src_y + mat[1]
    x4 = dst_x >> ss
    y4 = dst_y >> ss
    ix4 = x4 >> warp_ops.WARPEDMODEL_PREC_BITS
    sx4 = x4 & (WM - 1)
    iy4 = y4 >> warp_ops.WARPEDMODEL_PREC_BITS
    sy4 = y4 & (WM - 1)
    alpha, beta, gamma, delta = shear
    sx4 = (sx4 - 4 * (alpha + beta)) & ~((1 << 6) - 1)
    sy4 = (sy4 - 4 * (gamma + delta)) & ~((1 << 6) - 1)
    out = warp_ops.warp_core(ref, ix4, iy4, sx4, sy4, alpha, beta, gamma,
                             delta, bd)
    return (out.reshape(gbh, gbw, 8, 8).permute(0, 2, 1, 3)
            .reshape(p_h, p_w))


def _clamp_cands(cand, ys, xs, blk, h, w, pad=mc.PAD, blk_h=None):
    """clamp_mvs_for_pad over (nb, K, 2) candidates, low bit cleared
    (quarter-pel MVs).  blk_h: block height when it differs from the
    width."""
    bh = blk if blk_h is None else blk_h
    r = torch.clamp(cand[..., 0], (-(ys + pad - 4) * 8)[:, None],
                    ((h + pad - 4 - (ys + bh)) * 8)[:, None])
    c = torch.clamp(cand[..., 1], (-(xs + pad - 4) * 8)[:, None],
                    ((w + pad - 4 - (xs + blk)) * 8)[:, None])
    return torch.stack([r & ~1, c & ~1], dim=-1)


def _interp_pick(src_y, refp0_y, hme0, ys, xs, h, w, bd=8):
    """The frame's interpolation filter (choose_interp_filter role): the
    kind of the three (REGULAR, SMOOTH, SHARP) whose MC of every block at
    its HME MV (+ a quarter pel) from reference 0 has the least SSE.  The
    SSEs are exact int64 sums (the reference sums in float32).  Returns
    (kind 0-d int32, the three SSEs)."""
    probe_mv = _clamp_cands((hme0 + 2)[:, None], ys, xs, BLK, h, w)[:, 0]
    srcb = _blocks_at(src_y, ys, xs, BLK)
    sses = []
    for kind in (0, 1, 2):
        pp = mc.mc_blocks(refp0_y, ys, xs, probe_mv, BLK, mc.PAD, 0, bd,
                          kind=kind)
        d = (srcb - pp).to(torch.int64)
        sses.append((d * d).sum())
    sses = torch.stack(sses)
    return sses.argmin().to(torch.int32), sses


# --------------------------------------------------------------------------
# pass A (multi-reference, merged on the device)
# --------------------------------------------------------------------------

def _blocks_at(plane, ys, xs, n):
    """(B, n, n) blocks of an (H, W) plane at per-block offsets."""
    ar = torch.arange(n, device=plane.device)
    return plane[(ys[:, None, None] + ar[:, None]).long(),
                 (xs[:, None, None] + ar).long()]


def _sq_sum(x):
    """float32 sum of squares over the trailing two dims."""
    xf = x.to(torch.float32)
    return (xf * xf).sum(dim=(1, 2))


def _txq_rd(resid, qp, tx_type, tx_size, coef, txbb_k, eob, lam):
    """Forward transform + quantize one batch of residuals: (q, dq,
    distortion, coefficient bits)."""
    coeffs = tf.fwd_txfm2d(resid, tx_type, tx_size)
    qc, dq = quant.quantize(coeffs, qp, tx_size)
    s2 = float(np.float32(tf.coeff_sse_scale(tx_size, tx_type)))
    err = coeffs.to(torch.float32) - dq.to(torch.float32)
    dist = s2 * (err * err).sum(dim=(1, 2))
    bits = _txb_bits(qc.abs(), coef, txbb_k, eob,
                     _scan_pos_on(tx_size, resid.device))
    return qc, dq, dist, bits


def _rd_chroma(pred_u, pred_v, resid_u, resid_v, t, qp, lam, coef_uv,
               txbb_k, eob_uv, bd):
    """Chroma RD of both planes at TX_8X8 and tx type ``t`` (inter chroma
    inherits the luma type): ((q, rec, coded cost) of U, of V)."""
    out = []
    for pred_c, resid_c in ((pred_u, resid_u), (pred_v, resid_v)):
        qcc, dqc, dist_c, bits_c = _txq_rd(resid_c, qp, t, cc.TX_8X8,
                                           coef_uv, txbb_k, eob_uv, lam)
        rec_c = tf.inv_txfm2d_add(dqc, pred_c, t, cc.TX_8X8, bd=bd)
        out.append((qcc, rec_c, dist_c + lam * bits_c))
    return out


def _tx_funnel(resid, pred, bq, rec_coded, coded, chroma, mvb, qp, lam, rt,
               bd):
    """The inter luma tx-type search on one residual (ITX_SEARCH_SET after
    DCT_DCT): each type repays its signaling delta and is compared jointly
    with chroma, whose type it sets; a win needs a nonzero luma txb (with
    eob 0 the type is not signaled and the decoder takes DCT_DCT).
    chroma: [(qu, rec_u, cu), (qv, rec_v, cv)] at DCT_DCT, with the chroma
    prediction and residual as (pred_u, pred_v, resid_u, resid_v) after
    them.  Returns (coded, q, rec, tx index, chroma) at the winner."""
    coef_y, coef_uv, txbb, eob_y, eob_uv = rt
    (qu, rec_u, cu), (qv_, rec_v, cvq), cpr = chroma
    btx = torch.zeros(resid.shape[0], dtype=torch.int32,
                      device=resid.device)
    for ti, t in enumerate(ITX_SEARCH_SET, 1):
        q_t, dq_t, dist_t, bits_t = _txq_rd(resid, qp, t, cc.TX_16X16,
                                            coef_y, txbb[0], eob_y, lam)
        cost_t = dist_t + lam * (bits_t + mvb + _ITX_EXTRA_BITS[ti - 1])
        (qu_t, rec_u_t, cu_t), (qv_t, rec_v_t, cv_t) = _rd_chroma(
            *cpr, t, qp, lam, coef_uv, txbb[1], eob_uv, bd)
        take = ((q_t != 0).any(dim=2).any(dim=1)
                & ((cost_t + cu_t + cv_t) < (coded + cu + cvq)))
        t3 = take[:, None, None]
        coded = torch.where(take, cost_t, coded)
        bq = torch.where(t3, q_t, bq)
        rec_coded = torch.where(
            t3, tf.inv_txfm2d_add(dq_t, pred, t, cc.TX_16X16, bd=bd),
            rec_coded)
        btx = torch.where(take, ti, btx)
        qu = torch.where(t3, qu_t, qu)
        rec_u = torch.where(t3, rec_u_t, rec_u)
        cu = torch.where(take, cu_t, cu)
        qv_ = torch.where(t3, qv_t, qv_)
        rec_v = torch.where(t3, rec_v_t, rec_v)
        cvq = torch.where(take, cv_t, cvq)
    return coded, bq, rec_coded, btx, [(qu, rec_u, cu), (qv_, rec_v, cvq)]


def _eval_split8(src_y, src_u, src_v, refp_y, refp_u, refp_v, cand, ys, xs,
                 qp, lam, rt, bd, interp, nb, K, h, w):
    """The 8x8 partition-split alternative of a 16x16 block against ONE
    reference: each of the four 8x8 subs picks its own MV from the
    parent's candidates, codes TX_8X8 luma and TX_4X4 chroma and decides
    skip on its own.  Returns (cost, cost_y, sub MVs (nb, 4, 2), sub skips
    (nb, 4), qy, rec_y (nb, 16, 16), qu, rec_u, qv, rec_v (nb, 8, 8)):
    each sub's coefficients and recon in its quadrant."""
    coef_y, coef_uv, txbb, eob_y, eob_uv = rt
    dev = src_y.device
    SUB, CSUB = BLK // 2, CBLK // 2
    ar = torch.arange(nb, device=dev)
    s2c4 = float(np.float32(tf.coeff_sse_scale(cc.TX_4X4, cc.DCT_DCT)))
    cost_tot = torch.zeros(nb, dtype=torch.float32, device=dev)
    cost_y_tot = torch.zeros_like(cost_tot)
    smvs, sskips = [], []
    z = lambda n: torch.zeros((nb, n, n), dtype=torch.int32, device=dev)
    qy_c, rec_c, qu_c, ru_c, qv_c, rv_c = (z(BLK), z(BLK), z(CBLK), z(CBLK),
                                           z(CBLK), z(CBLK))
    for dy, dx in ((0, 0), (0, SUB), (SUB, 0), (SUB, SUB)):
        ys_s, xs_s = ys + dy, xs + dx
        cand_s = _clamp_cands(cand, ys_s, xs_s, SUB, h, w)
        mvsK = cand_s.permute(1, 0, 2).reshape(nb * K, 2)
        ysK, xsK = ys_s.repeat(K), xs_s.repeat(K)
        pred = mc.mc_blocks(refp_y, ysK, xsK, mvsK, SUB, mc.PAD, 0, bd,
                            kind=interp)
        resid = _blocks_at(src_y, ysK, xsK, SUB) - pred
        # luma TX_8X8 priced with the 8-wide table set (an MD
        # approximation, as in the reference)
        qc, dq, dist, bits = _txq_rd(resid, qp, cc.DCT_DCT, cc.TX_8X8,
                                     coef_uv, txbb[1], eob_uv, lam)
        mvb = _mv_bits(mvsK)
        cost_coded = dist + lam * (bits + mvb)
        cost_skip = _sq_sum(resid) + lam * (mvb + 2.0)
        kbest = torch.minimum(cost_coded, cost_skip).reshape(K, nb).argmin(
            dim=0)
        pick = lambda a: a.reshape((K, nb) + a.shape[1:])[kbest, ar]
        bq, bdq, bpred, bmv = pick(qc), pick(dq), pick(pred), pick(mvsK)
        bcoded, bskipc = pick(cost_coded), pick(cost_skip)
        rec_cod = tf.inv_txfm2d_add(bdq, bpred, cc.DCT_DCT, cc.TX_8X8, bd=bd)
        cys_s, cxs_s = ys_s // 2, xs_s // 2
        ch = []
        for refp_c, src_c in ((refp_u, src_u), (refp_v, src_v)):
            pred_c = mc.mc_blocks(refp_c, cys_s, cxs_s, bmv, CSUB, mc.PAD, 1,
                                  bd, kind=interp)
            resid_c = _blocks_at(src_c, cys_s, cxs_s, CSUB) - pred_c
            cf = tf.fwd_txfm2d(resid_c, cc.DCT_DCT, cc.TX_4X4)
            qcc, dqc = quant.quantize(cf, qp, cc.TX_4X4)
            err = cf.to(torch.float32) - dqc.to(torch.float32)
            dist_c = s2c4 * (err * err).sum(dim=(1, 2))
            # the analytic level curve (the exact model has no 4-wide
            # table set; an MD approximation, as in the reference)
            af = qcc.abs().to(torch.float32)
            bits_c = (2.0 * torch.log2(1.0 + af).sum(dim=(1, 2))
                      + (af > 0).sum(dim=(1, 2)) + 2.0)
            rcc = tf.inv_txfm2d_add(dqc, pred_c, cc.DCT_DCT, cc.TX_4X4,
                                    bd=bd)
            ch.append((qcc, rcc, pred_c, dist_c + lam * bits_c,
                       _sq_sum(resid_c)))
        (qu_s, ru_s, pu_s, cu_s, su_s), (qv_s, rv_s, pv_s, cv_s, sv_s) = ch
        coded_tot = bcoded + cu_s + cv_s
        skip_tot = bskipc + su_s + sv_s
        ssk = skip_tot < coded_tot
        s3 = ssk[:, None, None]
        cost_tot = cost_tot + torch.where(ssk, skip_tot, coded_tot)
        cost_y_tot = cost_y_tot + torch.where(
            ssk, bskipc, torch.minimum(bcoded, bskipc))
        smvs.append(bmv)
        sskips.append(ssk)
        qy_c[:, dy:dy + SUB, dx:dx + SUB] = torch.where(s3, 0, bq)
        rec_c[:, dy:dy + SUB, dx:dx + SUB] = torch.where(s3, bpred, rec_cod)
        cdy, cdx = dy // 2, dx // 2
        qu_c[:, cdy:cdy + CSUB, cdx:cdx + CSUB] = torch.where(s3, 0, qu_s)
        ru_c[:, cdy:cdy + CSUB, cdx:cdx + CSUB] = torch.where(s3, pu_s, ru_s)
        qv_c[:, cdy:cdy + CSUB, cdx:cdx + CSUB] = torch.where(s3, 0, qv_s)
        rv_c[:, cdy:cdy + CSUB, cdx:cdx + CSUB] = torch.where(s3, pv_s, rv_s)
    return (cost_tot + lam * _SPLIT_EXTRA_BITS, cost_y_tot,
            torch.stack(smvs, dim=1), torch.stack(sskips, dim=1), qy_c,
            rec_c, qu_c, ru_c, qv_c, rv_c)


def _eval_ref(src_y, src_u, src_v, refp_y, refp_u, refp_v, wref_y, wref_u,
              wref_v, cand, is_warp0, ys, xs, qp, lam, rt, bd, interp, nb,
              K, h, w, tx_search=False, split8=False):
    """Pass-A candidate evaluation against ONE reference (skip-aware).

    cand: (nb, K, 2) clamped MVs (slot 0 = the global-motion candidate,
    signaling-only when is_warp0).  tx_search: the inter tx-type search on
    the winner's residual (_tx_funnel); split8: the 8x8 split alternative
    (_eval_split8).  Returns the per-block winner: (cost_tot, cost_y, mv,
    skip, qy, rec_y, qu, rec_u, qv, rec_v, warp_flag, tx index, split,
    sub MVs, sub skips)."""
    coef_y, coef_uv, txbb, eob_y, eob_uv = rt
    dev = src_y.device
    ar = torch.arange(nb, device=dev)
    ysK = ys.repeat(K)
    xsK = xs.repeat(K)
    mvsK = cand.permute(1, 0, 2).reshape(nb * K, 2)
    pred = mc.mc_blocks(refp_y, ysK, xsK, mvsK, BLK, mc.PAD, 0, bd,
                        kind=interp)
    wslice = _blocks_at(wref_y, ys, xs, BLK)
    pred = torch.cat([torch.where(is_warp0, wslice, pred[:nb]), pred[nb:]])
    resid = _blocks_at(src_y, ysK, xsK, BLK) - pred
    qc, dq, dist, bits = _txq_rd(resid, qp, cc.DCT_DCT, cc.TX_16X16, coef_y,
                                 txbb[0], eob_y, lam)
    mvb = _mv_bits(mvsK)
    cost_coded = dist + lam * (bits + mvb)
    cost_skip = _sq_sum(resid) + lam * (mvb + 2.0)
    skip_k = cost_skip < cost_coded
    cost = torch.where(skip_k, cost_skip, cost_coded).reshape(K, nb)
    kbest = cost.argmin(dim=0)
    pick = lambda a: a.reshape((K, nb) + a.shape[1:])[kbest, ar]
    bmv, bq, bdq, bpred = pick(mvsK), pick(qc), pick(dq), pick(pred)
    bcoded, bskipc = pick(cost_coded), pick(cost_skip)
    warp_flag = (kbest == 0) & is_warp0
    rec_coded = tf.inv_txfm2d_add(bdq, bpred, cc.DCT_DCT, cc.TX_16X16, bd=bd)
    # chroma at the winner MV (the warped chroma planes under warp),
    # before the luma tx-type search: the inter chroma tx type is the
    # signaled luma type, so a non-DCT luma win re-transforms chroma too
    cys, cxs = ys // 2, xs // 2
    ch = []
    for refp_c, wref_c, src_c in ((refp_u, wref_u, src_u),
                                  (refp_v, wref_v, src_v)):
        pred_c = mc.mc_blocks(refp_c, cys, cxs, bmv, CBLK, mc.PAD, 1, bd,
                              kind=interp)
        pred_c = torch.where(warp_flag[:, None, None],
                             _blocks_at(wref_c, cys, cxs, CBLK), pred_c)
        resid_c = _blocks_at(src_c, cys, cxs, CBLK) - pred_c
        ch.append((pred_c, resid_c, _sq_sum(resid_c)))
    (pred_u, resid_u, su), (pred_v, resid_v, sv) = ch
    cpr = (pred_u, pred_v, resid_u, resid_v)
    chroma = _rd_chroma(*cpr, cc.DCT_DCT, qp, lam, coef_uv, txbb[1], eob_uv,
                        bd)
    btx = torch.zeros(nb, dtype=torch.int32, device=dev)
    if tx_search:
        bcoded, bq, rec_coded, btx, chroma = _tx_funnel(
            _blocks_at(src_y, ys, xs, BLK) - bpred, bpred, bq, rec_coded,
            bcoded, chroma + [cpr], _mv_bits(bmv), qp, lam, rt, bd)
    (qu, rec_u, cu), (qv_, rec_v, cvq) = chroma
    # joint skip decision across planes (one skip flag covers all)
    coded_tot = bcoded + cu + cvq
    skip_tot = bskipc + su + sv
    skip = skip_tot < coded_tot
    s3 = skip[:, None, None]
    out = [torch.where(skip, skip_tot, coded_tot),
           torch.where(skip, bskipc, torch.minimum(bcoded, bskipc)),
           bmv, skip,
           torch.where(s3, 0, bq), torch.where(s3, bpred, rec_coded),
           torch.where(s3, 0, qu), torch.where(s3, pred_u, rec_u),
           torch.where(s3, 0, qv_), torch.where(s3, pred_v, rec_v),
           warp_flag,
           torch.where(skip, 0, btx),       # skip blocks signal no type
           torch.zeros(nb, dtype=torch.bool, device=dev),
           torch.zeros((nb, 4, 2), dtype=torch.int32, device=dev),
           torch.zeros((nb, 4), dtype=torch.bool, device=dev)]
    if split8:
        sp = _eval_split8(src_y, src_u, src_v, refp_y, refp_u, refp_v, cand,
                          ys, xs, qp, lam, rt, bd, interp, nb, K, h, w)
        take = sp[0] < out[0]
        t3 = take[:, None, None]
        out[0] = torch.where(take, sp[0], out[0])
        out[1] = torch.where(take, sp[1], out[1])
        out[2] = torch.where(take[:, None], sp[2][:, 0], out[2])
        out[3] = torch.where(take, sp[3].all(dim=1), out[3])
        for fi, si in ((4, 4), (5, 5), (6, 6), (7, 7), (8, 8), (9, 9)):
            out[fi] = torch.where(t3, sp[si], out[fi])
        out[10] = torch.where(take, False, out[10])
        out[11] = torch.where(take, 0, out[11])
        out[12] = take
        out[13] = sp[2]
        out[14] = sp[3]
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _wedge_masks_on(device):
    """(32, 256) float32 luma wedge weights / 64, their squares, and the
    (32, 16, 16) / (32, 8, 8) int32 luma / chroma masks, sign-major."""
    m_all = np.concatenate([wedge_ops.masks_16[0], wedge_ops.masks_16[1]])
    muv = np.concatenate([wedge_ops.masks_16_uv[0],
                          wedge_ops.masks_16_uv[1]])
    M = torch.as_tensor(m_all.reshape(32, -1).astype(np.float32) / 64.0,
                        device=device)
    return (M, M * M, torch.as_tensor(m_all.astype(np.int32), device=device),
            torch.as_tensor(muv.astype(np.int32), device=device))


def _wedge_pick(d1, e, M, M2):
    """The wedge option (sign * 16 + index) of least prediction SSE per
    block, int32: with m in [0, 1], sse(m) = sum((src - pB) - m * (pA -
    pB))^2 in float32, d1 = src - pB and e = pA - pB as (nb, 256)."""
    sse = ((d1 * d1).sum(dim=1, keepdim=True)
           - 2.0 * (d1 * e) @ M.T + (e * e) @ M2.T)
    return sse.argmin(dim=1).to(torch.int32)


def _eval_pair(src_y, src_u, src_v, p0, p1, mv0, mv1, ys, xs, qp, lam, rt,
               bd, interp, nb, wedge=True, sm=False):
    """Compound (mv0, mv1) pair evaluation with a joint skip decision:
    COMPOUND_AVERAGE, then (wedge=True) the wedge mask picked by
    prediction-SSE algebra over all 32 sign/index options and priced by
    one exact masked-blend RD, then COMPOUND_DIFFWTD with its mask type
    picked the same way.  sm: this is the skip-mode pair, whose all-skip
    blocks cost one skip_mode symbol.  Returns (cost, cost_y, skip, qy,
    rec_y, qu, rec_u, qv, rec_v, code) where code is -1 average,
    sign * 16 + index for wedge, 64 + mask_type for diffwtd."""
    coef_y, coef_uv, txbb, eob_y, eob_uv = rt
    dev = src_y.device
    srcb = _blocks_at(src_y, ys, xs, BLK)
    cys, cxs = ys // 2, xs // 2
    src_cs = (_blocks_at(src_u, cys, cxs, CBLK),
              _blocks_at(src_v, cys, cxs, CBLK))
    mvb = _mv_bits(mv0) + _mv_bits(mv1) + 2.0

    def rd(pred, pred_u, pred_v, extra_bits, sm_ok=False):
        resid = srcb - pred
        qc, dq, dist, bits = _txq_rd(resid, qp, cc.DCT_DCT, cc.TX_16X16,
                                     coef_y, txbb[0], eob_y, lam)
        coded_y = dist + lam * (bits + mvb + extra_bits)
        skip_sig = 1.5 if (sm and sm_ok) else (mvb + extra_bits + 2.0)
        skip_y = _sq_sum(resid) + lam * skip_sig
        rec_coded = tf.inv_txfm2d_add(dq, pred, cc.DCT_DCT, cc.TX_16X16,
                                      bd=bd)
        ch = []
        for pred_c, src_c in ((pred_u, src_cs[0]), (pred_v, src_cs[1])):
            resid_c = src_c - pred_c
            qcc, dqc, dist_c, bits_c = _txq_rd(resid_c, qp, cc.DCT_DCT,
                                               cc.TX_8X8, coef_uv, txbb[1],
                                               eob_uv, lam)
            rec_c = tf.inv_txfm2d_add(dqc, pred_c, cc.DCT_DCT, cc.TX_8X8,
                                      bd=bd)
            ch.append((qcc, rec_c, pred_c, dist_c + lam * bits_c,
                       _sq_sum(resid_c)))
        (qu, rec_u, pu, cu, su), (qv_, rec_v, pv, cvq, sv) = ch
        coded_tot = coded_y + cu + cvq
        skip_tot = skip_y + su + sv
        skip = skip_tot < coded_tot
        s3 = skip[:, None, None]
        return [torch.where(skip, skip_tot, coded_tot),
                torch.where(skip, skip_y, torch.minimum(coded_y, skip_y)),
                skip, torch.where(s3, 0, qc), torch.where(s3, pred, rec_coded),
                torch.where(s3, 0, qu), torch.where(s3, pu, rec_u),
                torch.where(s3, 0, qv_), torch.where(s3, pv, rec_v)]

    def take(won, best, new):
        for fi in range(len(best)):
            sh = (nb,) + (1,) * (best[fi].ndim - 1)
            best[fi] = torch.where(won.reshape(sh), new[fi], best[fi])

    comp = lambda pl, yy, xx, n, ss, mask=None: mc.mc_blocks_compound(
        p0[pl], p1[pl], yy, xx, mv0, mv1, n, mc.PAD, ss, bd, kind=interp,
        mask=mask)
    best = rd(comp(0, ys, xs, BLK, 0), comp(1, cys, cxs, CBLK, 1),
              comp(2, cys, cxs, CBLK, 1), 0.0, sm_ok=True)
    code = torch.full((nb,), -1, dtype=torch.int32, device=dev)
    if wedge:
        M, M2, m_y_all, m_uv_all = _wedge_masks_on(dev)
        pA = mc.mc_blocks(p0[0], ys, xs, mv0, BLK, mc.PAD, 0, bd,
                          kind=interp)
        pB = mc.mc_blocks(p1[0], ys, xs, mv1, BLK, mc.PAD, 0, bd,
                          kind=interp)
        d1 = (srcb - pB).to(torch.float32).reshape(nb, -1)
        e = (pA - pB).to(torch.float32).reshape(nb, -1)
        widx = _wedge_pick(d1, e, M, M2)
        m_y = m_y_all[widx.long()]
        m_uv = m_uv_all[widx.long()]
        wrd = rd(comp(0, ys, xs, BLK, 0, m_y),
                 comp(1, cys, cxs, CBLK, 1, m_uv),
                 comp(2, cys, cxs, CBLK, 1, m_uv), _WEDGE_EXTRA_BITS)
        won = wrd[0] < best[0]
        code = torch.where(won, widx, code)
        take(won, best, wrd)
        # diffwtd: the mask type by the same algebra on the estimated
        # mask, then one exact d16-mask RD
        m_est = (38 + (pA - pB).abs().reshape(nb, -1) // 16).clamp(
            0, 64).to(torch.float32) / 64.0
        sse_d0 = ((d1 - m_est * e) ** 2).sum(dim=1)
        sse_d1 = ((d1 - (1.0 - m_est) * e) ** 2).sum(dim=1)
        inv = (sse_d1 < sse_d0).to(torch.int32)
        pred_dw, m16 = mc.mc_blocks_compound_diffwtd(
            p0[0], p1[0], ys, xs, mv0, mv1, BLK, mc.PAD, inv, bd,
            kind=interp)
        m_uv_d = (m16[:, ::2, ::2] + m16[:, 1::2, ::2] + m16[:, ::2, 1::2]
                  + m16[:, 1::2, 1::2] + 2) >> 2
        drd = rd(pred_dw, comp(1, cys, cxs, CBLK, 1, m_uv_d),
                 comp(2, cys, cxs, CBLK, 1, m_uv_d), _DIFFWTD_EXTRA_BITS)
        dwin = drd[0] < best[0]
        code = torch.where(dwin, 64 + inv, code)
        take(dwin, best, drd)
    return tuple(best) + (code,)


# --------------------------------------------------------------------------
# P1: the inter-frame MD program
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _obmc_ii_masks_on(device):
    """The OBMC (16 luma / 8 chroma rows) and inter-intra (4 modes of
    16x16 / 8x8) masks as int32 tensors."""
    t = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=device)
    return (t(obmc_ops.MASK_Y16), t(obmc_ops.MASK_C8),
            t(ii_ops.MASKS_Y16), t(ii_ops.MASKS_UV8))


def _wave_valid(ws):
    """(B,) bool: the slots of a wave that hold a block."""
    va = torch.zeros(ws.bid.shape[0], dtype=torch.bool, device=ws.bid.device)
    va[ws.sel] = True
    return va


class _AltEnv:
    """Pass B's motion-mode alternatives of a wave's blocks (M5-M8): OBMC
    and inter-intra predictions built on the pass-A winner's MV, each
    priced by a joint luma + chroma RD through the same tx funnel as the
    pass-A winner (``rd_joint``), the reference's motion-mode MD."""

    def __init__(self, src_y, src_u, src_v, refps, imv, iref_idx, icomp,
                 iwarp, isplit, ismv, cost_tot, qp, lam, rt, bd, interp, gw,
                 tx_search):
        self.src = (src_y, src_u, src_v)
        self.refps = refps
        self.imv, self.iref_idx, self.ismv = imv, iref_idx, ismv
        self.icomp, self.iwarp, self.isplit = icomp, iwarp, isplit
        self.cost_tot = cost_tot
        self.qp, self.lam, self.rt, self.bd = qp, lam, rt, bd
        self.interp, self.gw, self.tx_search = interp, gw, tx_search
        self.masks = _obmc_ii_masks_on(src_y.device)

    def wave(self, ws, ry, ru, rv, choose, obmc, interintra):
        """The alternatives of one wave's slots, merged as the reference
        merges them: inter-intra replaces OBMC where it beats it.  Returns
        (OBMC won, inter-intra mode or -1, the winning alternative's
        (won, skip, cost_y, rec_y, qy, rec_u, qu, rec_v, qv, tx index))."""
        bid = ws.bid
        va = _wave_valid(ws)
        ys = (ws.by * BLK).to(torch.int32)
        xs = (ws.bx * BLK).to(torch.int32)
        base = self.base_preds(bid, ys, xs)
        best_tot = self.cost_tot[bid]
        alt = None
        ow = torch.zeros_like(va)
        iimode = torch.full_like(bid, -1, dtype=torch.int32)
        if obmc:
            out = self.obmc_alt(bid, ws.by, ws.bx, va, base, ys, xs, choose)
            ow = out[0]
            best_tot = torch.where(ow, out[1], best_tot)
            alt = [ow] + list(out[2:])
        if interintra:
            out = self.ii_alt(ry, ru, rv, ws.fi, bid, va, ws.ha, ws.hl, base,
                              ys, xs)
            iw = out[0] & (out[2] < best_tot)
            iimode = torch.where(iw, out[1], -1)
            if alt is None:
                alt = [iw] + list(out[3:])
            else:
                for k, b_ in enumerate(out[3:], 1):
                    sh = iw.reshape(iw.shape + (1,) * (b_.ndim - 1))
                    alt[k] = torch.where(sh, b_, alt[k])
                alt[0] = alt[0] | iw
                ow = ow & ~iw
        return ow, iimode, alt

    def sel_ref_mc(self, ys, xs, mvs, ridx, plane):
        """MC of each block from its reference (ridx), plane 0/1/2."""
        n, ss = (BLK, 0) if plane == 0 else (CBLK, 1)
        if ss:
            ys, xs = ys // 2, xs // 2
        out = None
        for r, rp in enumerate(self.refps):
            pr = mc.mc_blocks(rp[plane], ys, xs, mvs, n, mc.PAD, ss, self.bd,
                              kind=self.interp)
            out = pr if out is None else torch.where(
                (ridx == r)[:, None, None], pr, out)
        return out

    def base_preds(self, bid, ys, xs):
        mv, ridx = self.imv[bid], self.iref_idx[bid].to(torch.int32)
        return tuple(self.sel_ref_mc(ys, xs, mv, ridx, p) for p in range(3))

    def rd_joint(self, pred, pred_u, pred_v, mvb, ys, xs):
        """Joint luma + chroma RD of an alternative prediction, as pass A
        prices its winner (the tx funnel included).  Returns (cost, skip,
        cost_y, rec_y, qy, rec_u, qu, rec_v, qv, tx index)."""
        src_y, src_u, src_v = self.src
        qp, lam, bd = self.qp, self.lam, self.bd
        coef_y, coef_uv, txbb, eob_y, eob_uv = self.rt
        resid = _blocks_at(src_y, ys, xs, BLK) - pred
        cys, cxs = ys // 2, xs // 2
        resid_u = _blocks_at(src_u, cys, cxs, CBLK) - pred_u
        resid_v = _blocks_at(src_v, cys, cxs, CBLK) - pred_v
        qc, dq, dist, bits = _txq_rd(resid, qp, cc.DCT_DCT, cc.TX_16X16,
                                     coef_y, txbb[0], eob_y, lam)
        coded_y = dist + lam * (bits + mvb)
        skip_y = _sq_sum(resid) + lam * (mvb + 2.0)
        rec_cod = tf.inv_txfm2d_add(dq, pred, cc.DCT_DCT, cc.TX_16X16, bd=bd)
        cpr = (pred_u, pred_v, resid_u, resid_v)
        chroma = _rd_chroma(*cpr, cc.DCT_DCT, qp, lam, coef_uv, txbb[1],
                            eob_uv, bd)
        txi = torch.zeros(pred.shape[0], dtype=torch.int32,
                          device=pred.device)
        if self.tx_search:
            coded_y, qc, rec_cod, txi, chroma = _tx_funnel(
                resid, pred, qc, rec_cod, coded_y, chroma + [cpr], mvb, qp,
                lam, self.rt, bd)
        (qu, rec_u, cu), (qv_, rec_v, cv) = chroma
        coded_tot = coded_y + cu + cv
        skip_tot = skip_y + _sq_sum(resid_u) + _sq_sum(resid_v)
        oskip = skip_tot < coded_tot
        s3 = oskip[:, None, None]
        return (torch.where(oskip, skip_tot, coded_tot), oskip,
                torch.where(oskip, skip_y, torch.minimum(coded_y, skip_y)),
                torch.where(s3, pred, rec_cod), torch.where(s3, 0, qc),
                torch.where(s3, pred_u, rec_u), torch.where(s3, 0, qu),
                torch.where(s3, pred_v, rec_v), torch.where(s3, 0, qv_),
                torch.where(oskip, 0, txi))

    def obmc_alt(self, bid, by, bx, va, base, ys, xs, choose):
        """OBMC_CAUSAL: the base prediction blended with the ABOVE, then
        the LEFT neighbour's prediction (the normative masks and order)
        where that neighbour chose inter.  As spec 7.11.3.10 reads the
        neighbours per 8-px segment, an 8x8 split neighbour blends each
        half of the edge with the MV of the sub that touches it (the
        reference leaves split neighbours out here while a decoder blends
        them: ROADMAP.md queue C item 4).  Returns (won,) + rd_joint."""
        gw = self.gw
        abid = (bid - gw).clamp(min=0)
        lbid = (bid - 1).clamp(min=0)
        a_in = (by > 0) & choose[abid]
        l_in = (bx > 0) & choose[lbid]
        el = (va & ~self.icomp[bid] & ~self.iwarp[bid] & ~self.isplit[bid]
              & (a_in | l_in))
        my, mc8 = self.masks[:2]
        preds = list(base)
        b = bid.shape[0]
        for nbid, on, fn, subs in ((abid, a_in, obmc_ops.blend_above, (2, 3)),
                                   (lbid, l_in, obmc_ops.blend_left, (1, 3))):
            sp = self.isplit[nbid][:, None]
            mvs = torch.cat([torch.where(sp, self.ismv[nbid, k], self.imv[nbid])
                             for k in subs])
            nridx = self.iref_idx[nbid].to(torch.int32).repeat(2)
            for p in range(3):
                n = BLK if p == 0 else CBLK
                pn = self.sel_ref_mc(ys.repeat(2), xs.repeat(2), mvs, nridx, p)
                # the first half of the edge (columns above, rows left)
                # from the first segment's MV, the rest from the second's
                half = torch.arange(n, device=bid.device) < n // 2
                h3 = half[None, None, :] if fn is obmc_ops.blend_above \
                    else half[None, :, None]
                pn = torch.where(h3, pn[:b], pn[b:])
                preds[p] = torch.where(on[:, None, None],
                                       fn(preds[p], pn, my if p == 0 else mc8),
                                       preds[p])
        out = self.rd_joint(*preds, _mv_bits(self.imv[bid]) + _OBMC_FLAG_BITS,
                            ys, xs)
        return (el & (out[0] < self.cost_tot[bid]),) + out

    def ii_alt(self, ry, ru, rv, fi, bid, va, ha, hl, base, ys, xs):
        """Inter-intra: smooth-mask blends of the base prediction with the
        DC / V / H / SMOOTH intra predictions from the causal wave recon;
        the least prediction SSE picks the mode, one joint RD prices it.
        Returns (eligible, mode) + rd_joint."""
        bd = self.bd
        el = va & ~self.icomp[bid] & ~self.iwarp[bid] & ~self.isplit[bid]
        srcb = _blocks_at(self.src[0], ys, xs, BLK)
        pred, pred_u, pred_v = base
        _, _, my, muv = self.masks
        nbr = _gather_neighbors(ry, fi, ys, xs, BLK, ha, hl, bd=bd)
        blends, sses = [], []
        for mi, im in enumerate(II_TO_INTRA):
            ip = intra_ops.predict(im, *nbr, BLK, BLK, have_above=ha,
                                   have_left=hl, bd=bd)
            bl = ii_ops.blend(ip, pred, my[mi])
            blends.append(bl)
            sses.append(_sq_sum(srcb - bl))
        best = torch.stack(sses).argmin(dim=0).to(torch.int32)
        pick = blends[0]
        for mi in range(1, 4):
            pick = torch.where((best == mi)[:, None, None], blends[mi], pick)
        cys, cxs = ys // 2, xs // 2
        nbu = _gather_neighbors(ru, fi, cys, cxs, CBLK, ha, hl, bd=bd)
        nbv = _gather_neighbors(rv, fi, cys, cxs, CBLK, ha, hl, bd=bd)
        pu, pv = pred_u, pred_v
        for mi, im in enumerate(II_TO_INTRA):
            t3 = (best == mi)[:, None, None]
            for nb_c, pc in ((nbu, 0), (nbv, 1)):
                ipc = intra_ops.predict(im, *nb_c, CBLK, CBLK, have_above=ha,
                                        have_left=hl, bd=bd)
                if pc == 0:
                    pu = torch.where(t3, ii_ops.blend(ipc, pred_u, muv[mi]),
                                     pu)
                else:
                    pv = torch.where(t3, ii_ops.blend(ipc, pred_v, muv[mi]),
                                     pv)
        out = self.rd_joint(pick, pu, pv,
                            _mv_bits(self.imv[bid]) + _II_EXTRA_BITS, ys, xs)
        return (el, best) + out


def _check_p1_tools(hp):
    if hp:
        raise NotImplementedError(HP_MV)


def build_p1(h, w, R, modes, bd=8, ring=True, compound=True, rad2=8,
             rad0=7, hp=False, obmc=False, interintra=False,
             skip_mode=False, tx_search=False, split8=False):
    """P1 for an (h, w) frame with R references: returns p1(src_y, src_u,
    src_v, refs_y, refs_u, refs_v, qp, lam, rt) -> the reference's 30
    outputs (see the end of ``p1``).  src planes: int32 (H, W) / (H/2,
    W/2); refs_*: (R, ...) uint8 or int32; qp: QuantParams tensors; lam:
    float32 0-d tensor; rt: md_rate_args(..., inter_frame=True) on the
    same device."""
    _check_p1_tools(hp)
    gh, gw = h // BLK, w // BLK
    nb = gh * gw
    h64 = (h + 63) & ~63
    w64 = (w + 63) & ~63
    hme_run = me_pipe.hme_core(h64, w64, rad2, 8, rad0)
    ring_np = np.asarray(_SUBPEL_RING if ring else _SUBPEL_RING[:1])
    K = 1 + len(ring_np) + 2   # gm + ring + (above, left) neighbour MVs
    modes = tuple(modes)

    def p1(src_y, src_u, src_v, refs_y, refs_u, refs_v, qp, lam, rt):
        dev = src_y.device
        cy_t, cuv_t, txbb, modeb, uvb, eoby, eobuv = rt[:7]
        rt5 = (cy_t, cuv_t, txbb, eoby, eobuv)
        ar = torch.arange(nb, device=dev)
        ys = (ar // gw * BLK).to(torch.int32)
        xs = (ar % gw * BLK).to(torch.int32)
        refs = [tuple(p[r].to(torch.int32) for p in (refs_y, refs_u, refs_v))
                for r in range(R)]
        src64 = _edge_pad_to(src_y, h64, w64)

        # per-reference HME + GM
        hmes, fields = [], []
        with _region("p1.hme"):
            for r in range(R):
                mvy, mvx, _ = hme_run(src64,
                                      _edge_pad_to(refs[r][0], h64, w64))
                fields.append((mvy[:gh, :gw], mvx[:gh, :gw]))
                hmes.append(torch.stack(
                    [fields[-1][0].reshape(nb) * 8,
                     fields[-1][1].reshape(nb) * 8], dim=-1).to(torch.int32))
        with _region("p1.gm_fit"):
            gms = [_gm_fit(mvy, mvx, gh, gw) for mvy, mvx in fields]

        # padded reference planes, shared by pass A and the compound
        # pairs, and the frame's interp filter
        with _region("p1.interp_pick"):
            refps = [(mc.pad_plane(ry, mc.PAD),
                      mc.pad_plane(ru, mc.PAD // 2),
                      mc.pad_plane(rv, mc.PAD // 2)) for ry, ru, rv in refs]
            interp = _interp_pick(src_y, refps[0][0], hmes[0], ys, xs, h, w,
                                  bd)[0]

        # pass A per reference, merged on the device
        best = None
        iref_idx = torch.zeros(nb, dtype=torch.int32, device=dev)
        ring_t = _t(ring_np, dev)
        for r in range(R):
            mat, trans, kind = gms[r]
            is_warp0 = kind == 2
            ry_, ru_, rv_ = refs[r]
            with _region("p1.warp"):
                shear = _shear_device(mat)[:4]
                wy = _warp_plane_traced(ry_, mat, shear, w, h, bd, 0)
                wu = _warp_plane_traced(ru_, mat, shear, w // 2, h // 2, bd,
                                        1)
                wv = _warp_plane_traced(rv_, mat, shear, w // 2, h // 2, bd,
                                        1)
            gm_mv = torch.where(
                is_warp0, _gm_block_mvs(mat, gh, gw),
                torch.where(kind == 1, trans.expand(nb, 2),
                            torch.zeros((nb, 2), dtype=torch.int32,
                                        device=dev)))
            hme = hmes[r]
            above = torch.roll(hme.reshape(gh, gw, 2), 1, dims=0)
            above[0] = 0
            left = torch.roll(hme.reshape(gh, gw, 2), 1, dims=1)
            left[:, 0] = 0
            cand = torch.cat([gm_mv[:, None], hme[:, None] + ring_t[None],
                              above.reshape(nb, 1, 2),
                              left.reshape(nb, 1, 2)], dim=1)
            cand = _clamp_cands(cand, ys, xs, BLK, h, w)
            # warp candidate 0 signals the exact projection; ring
            # candidates that collide with it are nudged (the syntax
            # would map them to GLOBALMV and the decoder would warp)
            cand[:, 0] = torch.where(is_warp0, gm_mv, cand[:, 0])
            coll = (cand[:, 1:] == cand[:, :1]).all(dim=2) & is_warp0
            cand[:, 1:, 1] += coll.to(torch.int32) * 2
            with _region("p1.pass_a"):
                out = _eval_ref(src_y, src_u, src_v, *refps[r], wy, wu, wv,
                                cand, is_warp0, ys, xs, qp, lam, rt5, bd,
                                interp, nb, K, h, w, tx_search, split8)
            if best is None:
                best = list(out)
            else:
                take = out[0] < best[0]
                iref_idx = torch.where(take, r, iref_idx)
                for fi in range(len(best)):
                    t_ = take.reshape((nb,) + (1,) * (best[fi].ndim - 1))
                    best[fi] = torch.where(t_, out[fi], best[fi])
        (cost_tot, cost_y, imv, iskip, iqy, irec_y, iqu, irec_u, iqv,
         irec_v, iwarp, itx, isplit, ismv, issk) = best

        icomp = torch.zeros(nb, dtype=torch.bool, device=dev)
        imv2 = torch.zeros((nb, 2), dtype=torch.int32, device=dev)
        iwedge = torch.full((nb,), -1, dtype=torch.int32, device=dev)
        if compound and R >= 2:
            # the pair is (first, last) reference: LAST is index 0 and
            # ALTREF (the backward reference) index R-1
            mv0 = _clamp_cands(hmes[0][:, None], ys, xs, BLK, h, w)[:, 0]
            mv1 = _clamp_cands(hmes[R - 1][:, None], ys, xs, BLK, h,
                               w)[:, 0]
            zero = torch.zeros_like(mv0)
            merged = None
            for pi, (m0, m1) in enumerate(((mv0, mv1), (zero, zero))):
                with _region("p1.compound"):
                    outc = list(_eval_pair(
                        src_y, src_u, src_v, refps[0], refps[R - 1], m0, m1,
                        ys, xs, qp, lam, rt5, bd, interp, nb,
                        sm=skip_mode and pi == 1)) + [m0, m1]
                if merged is None:
                    merged = outc
                else:
                    tk = outc[0] < merged[0]
                    for fi in range(len(merged)):
                        sh_ = (nb,) + (1,) * (merged[fi].ndim - 1)
                        merged[fi] = torch.where(tk.reshape(sh_), outc[fi],
                                                 merged[fi])
            (ccost, ccost_y, cskip, cqy, crec_y, cqu, crec_u, cqv, crec_v,
             ccode, m0, m1) = merged
            take = ccost < cost_tot
            t3 = take[:, None, None]
            icomp = take
            iwedge = torch.where(take, ccode, -1)
            cost_y = torch.where(take, ccost_y, cost_y)
            imv = torch.where(take[:, None], m0, imv)
            imv2 = torch.where(take[:, None], m1, imv2)
            iskip = torch.where(take, cskip, iskip)
            iwarp = torch.where(take, False, iwarp)
            itx = torch.where(take, 0, itx)
            isplit = torch.where(take, False, isplit)
            iref_idx = torch.where(take, 0, iref_idx)
            iqy = torch.where(t3, cqy, iqy)
            irec_y = torch.where(t3, crec_y, irec_y)
            iqu = torch.where(t3, cqu, iqu)
            irec_u = torch.where(t3, crec_u, irec_u)
            iqv = torch.where(t3, cqv, iqv)
            irec_v = torch.where(t3, crec_v, irec_v)

        # ---- pass B: the intra wave loop with the inter override ----
        ry = torch.zeros((1, h, w), dtype=torch.int32, device=dev)
        ru = torch.zeros((1, h // 2, w // 2), dtype=torch.int32, device=dev)
        rv = torch.zeros_like(ru)
        sy, su, sv = src_y[None], src_u[None], src_v[None]
        ymode = torch.zeros(nb, dtype=torch.int32, device=dev)
        umode = torch.zeros(nb, dtype=torch.int32, device=dev)
        choose = torch.zeros(nb, dtype=torch.bool, device=dev)
        qyB = torch.zeros((nb, BLK * BLK), dtype=torch.int16, device=dev)
        quB = torch.zeros((nb, CBLK * CBLK), dtype=torch.int16, device=dev)
        qvB = torch.zeros_like(quB)
        # the motion-mode alternatives' flags, skips, tx indices and
        # coefficients, raster order
        iobmc = torch.zeros(nb, dtype=torch.bool, device=dev)
        iimodes = torch.full((nb,), -1, dtype=torch.int32, device=dev)
        osa = torch.zeros(nb, dtype=torch.bool, device=dev)
        txo = torch.zeros(nb, dtype=torch.int32, device=dev)
        qyo, quo, qvo = (torch.zeros_like(a) for a in (qyB, quB, qvB))
        alts = obmc or interintra
        if alts:
            alt_env = _AltEnv(src_y, src_u, src_v, refps, imv, iref_idx,
                              icomp, iwarp, isplit, ismv, cost_tot, qp, lam,
                              rt5, bd, interp, gw, tx_search)
        with _region("p1.pass_b"):
            for ws in _device_schedule(gh, gw, 1, dev):
                bid = ws.bid
                icost, irec = cost_y[bid], irec_y[bid]
                irec_u_b, irec_v_b = irec_u[bid], irec_v[bid]
                if alts:
                    with _region("p1.alts"):
                        ow, iimode, alt = alt_env.wave(
                            ws, ry, ru, rv, choose, obmc, interintra)
                    # alt: (won, skip, cost_y, rec_y, qy, rec_u, qu,
                    # rec_v, qv, tx index)
                    aw, a3 = alt[0], alt[0][:, None, None]
                    icost = torch.where(aw, alt[2], icost)
                    irec = torch.where(a3, alt[3], irec)
                    irec_u_b = torch.where(a3, alt[5], irec_u_b)
                    irec_v_b = torch.where(a3, alt[7], irec_v_b)
                m, q, ry, ch_ = _rd_step(
                    ry, sy, ws.fi, ws.by * BLK, ws.bx * BLK, ws.sel, ws.ha,
                    ws.hl, qp, lam, modes, (cy_t, txbb, modeb, eoby), bd=bd,
                    tr_avail=ws.tr, bl_avail=ws.bl, inter=(icost, irec))
                um, qu_, qv2, ru, rv = _rd_step_chroma(
                    ru, rv, su, sv, ws.fi, ws.by * CBLK, ws.bx * CBLK, ws.sel,
                    ws.ha, ws.hl, qp, lam, (cuv_t, txbb, uvb, eobuv), bd=bd,
                    inter=(ch_, irec_u_b, irec_v_b))
                rid, sel = ws.rid, ws.sel
                ymode[rid] = m[sel].to(torch.int32)
                umode[rid] = um[sel].to(torch.int32)
                choose[rid] = ch_[sel]
                qyB[rid] = q[sel].reshape(-1, BLK * BLK).to(torch.int16)
                quB[rid] = qu_[sel].reshape(-1, CBLK * CBLK).to(torch.int16)
                qvB[rid] = qv2[sel].reshape(-1, CBLK * CBLK).to(torch.int16)
                if alts:
                    iobmc[rid] = (ow & ch_)[sel]
                    iimodes[rid] = torch.where(ch_, iimode, -1)[sel]
                    osa[rid] = alt[1][sel]
                    txo[rid] = alt[9][sel]
                    for acc, a, n_ in ((qyo, alt[4], BLK), (quo, alt[6], CBLK),
                                       (qvo, alt[8], CBLK)):
                        acc[rid] = a[sel].reshape(-1, n_ * n_).to(
                            torch.int16)

        iqy, iqu, iqv = (a.reshape(nb, -1) for a in (iqy, iqu, iqv))
        if alts:
            alt_b = iobmc | (iimodes >= 0)
            o2 = alt_b[:, None]
            iqy = torch.where(o2, qyo.to(torch.int32), iqy)
            iqu = torch.where(o2, quo.to(torch.int32), iqu)
            iqv = torch.where(o2, qvo.to(torch.int32), iqv)
            iskip = torch.where(alt_b, osa, iskip)
            itx = torch.where(alt_b, txo, itx)
        c2 = choose[:, None]
        qy_f = torch.where(c2, iqy.to(torch.int16), qyB)
        qu_f = torch.where(c2, iqu.to(torch.int16), quB)
        qv_f = torch.where(c2, iqv.to(torch.int16), qvB)
        gm_mats = torch.stack([g[0] for g in gms])
        gm_trans = torch.stack([g[1] for g in gms])
        gm_kinds = torch.stack([g[2] for g in gms])
        with _region("p1.merges"):
            merge32, merge64, mergeH, mergeV = _skip_merges(
                choose, iskip, iwarp, iwedge, iref_idx, icomp, imv, imv2, gh,
                gw, h, w, isplit, iobmc, iimodes)
        return (ry[0].to(torch.uint8), ru[0].to(torch.uint8),
                rv[0].to(torch.uint8), ymode.to(torch.uint8),
                umode.to(torch.uint8), choose, iskip & choose,
                imv.to(torch.int16), imv2.to(torch.int16),
                iref_idx.to(torch.uint8), icomp, iwarp & choose,
                iwedge.to(torch.int8), iobmc, iimodes.to(torch.int8), qy_f,
                qu_f, qv_f, gm_mats, gm_trans, gm_kinds, interp, merge32,
                merge64, itx.to(torch.int8), isplit & choose,
                ismv.to(torch.int16), issk, mergeH, mergeV)

    return p1


def _edge_pad_to(plane, hh, ww):
    """Edge-replicate an (H, W) plane to (hh, ww) at the bottom/right."""
    h, w = plane.shape
    if (h, w) == (hh, ww):
        return plane.to(torch.int32)
    dev = plane.device
    rows = torch.arange(hh, device=dev).clamp(max=h - 1)
    cols = torch.arange(ww, device=dev).clamp(max=w - 1)
    return plane.to(torch.int32)[rows[:, None], cols[None, :]]


def _skip_merges(choose, iskip, iwarp, iwedge, iref_idx, icomp, imv, imv2,
                 gh, gw, h, w, isplit, iobmc, iimodes):
    """The partition-level skip merges: 2x2 groups of inter-skip winners
    sharing (ref, mv) — or the same compound pair — without warp or a
    masked compound become one 32x32 skip leaf, 2x2 merged 32s sharing
    them once more a 64x64 leaf, and 2x2 groups whose halves agree
    internally a HORZ/VERT pair of rect skip leaves.  The merged recon is
    bit-identical, so this is a pure rate win (product_coding_loop.c's
    partition decision restricted to the lossless case)."""
    dev = choose.device
    gh2, gw2 = gh // 2, gw // 2
    # wedge, OBMC, inter-intra and split blocks keep their 16x16 leaves
    eligible = (choose & iskip & ~isplit & ~(iwarp & choose) & (iwedge < 0)
                & ~iobmc & (iimodes < 0))

    def grp(a):
        a2 = a.reshape(gh, gw, -1)[:gh2 * 2, :gw2 * 2]
        return a2.reshape(gh2, 2, gw2, 2, a2.shape[-1])

    def clamp_ok(mv, yy, xx, blk, blk_h=None):
        cl = _clamp_cands(mv[:, None], yy, xx, blk, h, w, blk_h=blk_h)[:, 0]
        return (cl == mv).all(dim=-1)

    ref_i = iref_idx[:, None].to(torch.int32)
    comp_i = icomp[:, None].to(torch.int32)
    el4 = grp(eligible[:, None].to(torch.int32))[..., 0]
    ok = el4.to(torch.bool).all(dim=3).all(dim=1)
    for f in (ref_i, comp_i):
        g = grp(f)[..., 0]
        ok &= (g == g[:, :1, :, :1]).all(dim=3).all(dim=1)
    a32 = torch.arange(gh2 * gw2, device=dev)
    ys32 = (a32 // gw2 * 32).to(torch.int32)
    xs32 = (a32 % gw2 * 32).to(torch.int32)
    for mva in (imv, imv2):
        mvg = grp(mva)
        ok &= (mvg == mvg[:, :1, :, :1]).all(dim=4).all(dim=3).all(dim=1)
        mv32 = mvg[:, 0, :, 0].reshape(-1, 2)
        ok &= clamp_ok(mv32, ys32, xs32, 2 * BLK).reshape(gh2, gw2)
    merge32 = ok.reshape(-1)

    gh4, gw4 = gh2 // 2, gw2 // 2
    if gh4 and gw4:
        def grp64(a):
            a2 = a.reshape(gh2, gw2, -1)[:gh4 * 2, :gw4 * 2]
            return a2.reshape(gh4, 2, gw4, 2, a2.shape[-1])

        def grp16_64(a):
            a2 = a.reshape(gh, gw, -1)[:gh4 * 4, :gw4 * 4]
            return a2.reshape(gh4, 4, gw4, 4, a2.shape[-1])

        ok64 = grp64(ok.reshape(gh2, gw2)[..., None])[..., 0].all(
            dim=3).all(dim=1)
        for f in (ref_i, comp_i):
            g = grp16_64(f)[..., 0]
            ok64 &= (g == g[:, :1, :, :1]).all(dim=3).all(dim=1)
        a64 = torch.arange(gh4 * gw4, device=dev)
        ys64 = (a64 // gw4 * 64).to(torch.int32)
        xs64 = (a64 % gw4 * 64).to(torch.int32)
        for mva in (imv, imv2):
            mvg = grp16_64(mva)
            ok64 &= (mvg == mvg[:, :1, :, :1]).all(dim=4).all(dim=3).all(
                dim=1)
            mv64 = mvg[:, 0, :, 0].reshape(-1, 2)
            ok64 &= clamp_ok(mv64, ys64, xs64, 4 * BLK).reshape(gh4, gw4)
        merge64 = ok64.reshape(-1)
    else:
        merge64 = torch.zeros(max(gh4, 1) * max(gw4, 1), dtype=torch.bool,
                              device=dev)

    # rect (HORZ/VERT) merges at the 32 extent: each half agrees
    # internally, the full 2x2 does not
    elig_all = el4.to(torch.bool).all(dim=3).all(dim=1)
    okH = elig_all & ~ok
    okV = elig_all & ~ok
    for f in (ref_i, comp_i, imv, imv2):
        fg = grp(f)
        okH &= (fg == fg[:, :, :, :1]).all(dim=4).all(dim=3).all(dim=1)
        okV &= (fg == fg[:, :1]).all(dim=4).all(dim=1).all(dim=-1)
    for mva in (imv, imv2):
        g = grp(mva)
        top = g[:, 0, :, 0].reshape(-1, 2)
        bot = g[:, 1, :, 0].reshape(-1, 2)
        okH &= (clamp_ok(top, ys32, xs32, 2 * BLK, BLK)
                & clamp_ok(bot, ys32 + BLK, xs32, 2 * BLK, BLK)
                ).reshape(gh2, gw2)
        lef = g[:, 0, :, 0].reshape(-1, 2)
        rig = g[:, 0, :, 1].reshape(-1, 2)
        okV &= (clamp_ok(lef, ys32, xs32, BLK, 2 * BLK)
                & clamp_ok(rig, ys32, xs32 + BLK, BLK, 2 * BLK)
                ).reshape(gh2, gw2)
    if gh4 and gw4:
        cov64 = torch.zeros((gh2, gw2), dtype=torch.bool, device=dev)
        cov64[:gh4 * 2, :gw4 * 2] = _up(merge64.reshape(gh4, gw4), 2)
        okH &= ~cov64
        okV &= ~cov64
    okV &= ~okH
    return merge32, merge64, okH.reshape(-1), okV.reshape(-1)


# --------------------------------------------------------------------------
# P2: DLF level search/apply + CDEF search/pick/apply
# --------------------------------------------------------------------------

def _sse_plane(a, b):
    """Frame SSE, exact (int64)."""
    d = a.to(torch.int64) - b.to(torch.int64)
    return (d * d).sum()


def _dlf_plane_traced(x, step, blimit, limit, thresh, flen, bd, on_v=None,
                      on_h=None):
    """loop_filter_plane_uniform with per-line edge enables: on_v (h, E) /
    on_h (E, w) switch lines off (interior edges of merged blocks and
    both-skip non-PU edges); filter lengths stay uniform, since the
    minimum transform extent is 16 px luma / 8 px chroma on this grid.
    Deltas are added with index_add_ (windows overlap, modified spans do
    not)."""
    h, w = x.shape
    x = x.to(torch.int32, copy=True)
    dev = x.device
    taps = torch.arange(-7, 7, device=dev)
    edges = torch.arange(step, w, step, device=dev)
    if len(edges):
        cols = edges[:, None] + taps[None]
        lines = x[:, cols].permute(1, 0, 2).reshape(-1, 14)
        f = dlf_ops.filter_lines(lines, blimit, limit, thresh, flen, bd)
        if on_v is not None:
            f = torch.where(on_v.T.reshape(-1, 1), f, lines)
        d = (f - lines).reshape(len(edges), h, 14).permute(1, 0, 2)
        x.index_add_(1, cols.reshape(-1), d.reshape(h, -1))
    redges = torch.arange(step, h, step, device=dev)
    if len(redges):
        rows = redges[:, None] + taps[None]
        lines = x[rows, :].permute(0, 2, 1).reshape(-1, 14)
        f = dlf_ops.filter_lines(lines, blimit, limit, thresh, flen, bd)
        if on_h is not None:
            f = torch.where(on_h.reshape(-1, 1), f, lines)
        d = (f - lines).reshape(len(redges), w, 14).permute(0, 2, 1)
        x.index_add_(0, rows.reshape(-1), d.reshape(-1, w))
    return x


def _up(a, k):
    """Repeat a 2-D map k times along both axes."""
    return a.repeat_interleave(k, 0).repeat_interleave(k, 1)


def _dlf_plane_flens(x, step, blimit, limit, thresh, bd, fl_v, fl_h, lens):
    """Plane deblock at ``step``-px edge spacing with per-edge-line filter
    lengths (8x8 leaves: luma edges every 8 px with flen in {0, 8, 14},
    chroma every 4 px with flen in {0, 4, 6})."""
    h, w = x.shape
    epos_v = np.arange(step, w, step)
    if len(epos_v):
        x = dlf_ops._filter_edges_masked(x, epos_v, fl_v, blimit, limit,
                                         thresh, lens, bd)
    epos_h = np.arange(step, h, step)
    if len(epos_h):
        x = dlf_ops._filter_edges_masked(x.T, epos_h, fl_h.T, blimit, limit,
                                         thresh, lens, bd).T
    return x


def _derive_skip8(qy_f, qu_f, qv_f, skip16, split16, gh, gw):
    """(2gh, 2gw) coded-skip map per 8x8 unit: the quadrant's coefficients
    for split blocks, the block's flag elsewhere (the decoder's per-leaf
    skip at 8-px granularity)."""
    nz = lambda q, n: (q.reshape(gh, gw, 2, n, 2, n) != 0).any(dim=5).any(
        dim=3)
    subz = ~(nz(qy_f, 8) | nz(qu_f, 4) | nz(qv_f, 4))      # (gh, gw, 2, 2)
    skip8 = torch.where(split16[:, :, None, None], subz,
                        skip16[:, :, None, None])
    return skip8.permute(0, 2, 1, 3).reshape(2 * gh, 2 * gw)


def _edge_enables(gh, gw, skip16, inter16, merge32, merge64, mergeh,
                  mergev, split16=None, skip8m=None):
    """Per-line DLF enables of the masked P2 (spec 7.14 derivation):
    {"y": (on_v, on_h), "c": (on_v, on_h)}.  With 8x8 leaves (split16,
    skip8m given) the maps are per-line filter lengths at 8-px (luma) /
    4-px (chroma) edge spacing instead."""
    dev = skip16.device
    split8 = split16 is not None
    gh2, gw2 = gh // 2, gw // 2
    gh4, gw4 = gh2 // 2, gw2 // 2
    z = lambda: torch.zeros((gh, gw), dtype=torch.bool, device=dev)
    merged16, rect_h16, rect_v16, merged64_16 = z(), z(), z(), z()
    if gh2 and gw2:
        merged16[:gh2 * 2, :gw2 * 2] = _up(merge32.reshape(gh2, gw2), 2)
        rect_h16[:gh2 * 2, :gw2 * 2] = _up(mergeh.reshape(gh2, gw2), 2)
        rect_v16[:gh2 * 2, :gw2 * 2] = _up(mergev.reshape(gh2, gw2), 2)
    if gh4 and gw4:
        merged64_16[:gh4 * 4, :gw4 * 4] = _up(merge64.reshape(gh4, gw4), 4)

    def szmap(v64, v32, vrh, vrv, dflt, dsplit=None):
        base = torch.where(split16, dsplit, dflt) if split8 else dflt
        return torch.where(
            merged64_16, v64, torch.where(
                merged16, v32, torch.where(
                    rect_h16, vrh, torch.where(rect_v16, vrv, base)))
        ).to(torch.int32)

    if split8:
        # per-direction tx extents in mi units
        txwmi = _up(szmap(16, 8, 8, 4, 4, 2), 4)
        txhmi = _up(szmap(16, 8, 4, 8, 4, 2), 4)
        skdlf = skip8m & _up(inter16, 2)          # at the 8-px grid
        skmi = _up(skdlf, 2)
    else:
        skdlf = skip16 & inter16
        txwmi = _up(szmap(16, 8, 8, 4, 4), 4)
        txhmi = _up(szmap(16, 8, 4, 8, 4), 4)
        skmi = _up(skdlf, 4)
    flv = dlf_ops.edge_flens(txwmi, txwmi, skmi, True)
    flh = dlf_ops.edge_flens(txhmi.T, txhmi.T, skmi.T, True).T
    if split8:
        ctxwmi = _up(szmap(8, 4, 4, 2, 2, 1), 2)
        ctxhmi = _up(szmap(8, 4, 2, 4, 2, 1), 2)
        cskmi = skdlf                    # the chroma mi grid is the 8-px one
        cflv = dlf_ops.edge_flens(ctxwmi, ctxwmi, cskmi, False)
        cflh = dlf_ops.edge_flens(ctxhmi.T, ctxhmi.T, cskmi.T, False).T
        return {"y": (flv[:, 2::2].repeat_interleave(4, 0),
                      flh[2::2, :].repeat_interleave(4, 1)),
                "c": (cflv[:, 1:].repeat_interleave(4, 0),
                      cflh[1:, :].repeat_interleave(4, 1))}
    ons = {"y": (flv[:, 4::4].repeat_interleave(4, 0) > 0,
                 flh[4::4, :].repeat_interleave(4, 1) > 0)}
    ctxwmi = _up(szmap(8, 4, 4, 2, 2), 2)
    ctxhmi = _up(szmap(8, 4, 2, 4, 2), 2)
    cskmi = _up(skdlf, 2)
    cflv = dlf_ops.edge_flens(ctxwmi, ctxwmi, cskmi, False)
    cflh = dlf_ops.edge_flens(ctxhmi.T, ctxhmi.T, cskmi.T, False).T
    ons["c"] = (cflv[:, 2::2].repeat_interleave(4, 0) > 0,
                cflh[2::2, :].repeat_interleave(4, 1) > 0)
    return ons


def p2(src_y, src_u, src_v, rec_y, rec_u, rec_v, skip16, dlf_y, dlf_uv,
       cands, damping: int, bd: int = 8, dlf_on: bool = True,
       cdef_on: bool = True, uniform_apply: bool = True, merge32=None,
       inter16=None, merge64=None, mergeh=None, mergev=None, split16=None,
       skip8m=None):
    """DLF search + apply, CDEF search, pick and apply on the device.

    src_*/rec_*: int32 / uint8 planes; skip16 (gh, gw) bool; dlf_y /
    dlf_uv: (NLVL, 4) numpy [level, blimit, limit, thresh] ladders;
    cands: (ncand, 4) numpy CDEF strength sets; damping: the signaled
    CDEF damping.  With ``merge32`` (and inter16, merge64, mergeh,
    mergev: the P1 merge outputs) the DLF edge enables are mask-aware;
    with ``split16`` and ``skip8m`` (8x8 leaves: the split map and the
    per-8x8 skip map) the deblock runs at 8-px granularity and CDEF reads
    the 8x8 skips.
    Returns (y, u, v) uint8, the DLF levels (3,), the per-SB /
    per-candidate SSE (nsb, ncand) and the picked candidate index — the
    planes are post-DLF only and the index 0 when ``uniform_apply`` is
    off (the key-frame search, whose caller picks the strengths)."""
    h, w = rec_y.shape
    dev = rec_y.device
    gh, gw = h // BLK, w // BLK
    gh8, gw8 = h // 8, w // 8
    nb8 = gh8 * gw8
    sbr, sbc = (h + 63) // 64, (w + 63) // 64
    ncand = len(cands)
    ons = dict(y=(None, None), c=(None, None))
    split8 = split16 is not None
    if merge32 is not None:
        ons = _edge_enables(gh, gw, skip16, inter16, merge32, merge64,
                            mergeh, mergev, split16, skip8m)

    def search_plane(src, rec, step, flen, params, onk):
        rec = rec.to(torch.int32)
        if not dlf_on:
            return rec, torch.zeros((), dtype=torch.int32, device=dev)
        on_v, on_h = ons[onk]
        outs = [rec]
        sses = [_sse_plane(src, rec)]
        for li in range(1, NLVL):
            thr = (int(params[li, 1]), int(params[li, 2]),
                   int(params[li, 3]))
            if split8:
                f = _dlf_plane_flens(rec, step // 2, *thr, bd, on_v, on_h,
                                     (8, 14) if onk == "y" else (4, 6))
            else:
                f = _dlf_plane_traced(rec, step, *thr, flen, bd, on_v, on_h)
            outs.append(f)
            sses.append(_sse_plane(src, f))
        best = torch.stack(sses).argmin()
        return (torch.stack(outs)[best],
                _t(params[:, 0], dev)[best])

    fy, ly = search_plane(src_y, rec_y, BLK, 14, dlf_y, "y")
    fu, lu = search_plane(src_u, rec_u, CBLK, 6, dlf_uv, "c")
    fv, lv = search_plane(src_v, rec_v, CBLK, 6, dlf_uv, "c")
    # chroma levels are coded only when a luma level is nonzero
    coff = ly == 0
    fu = torch.where(coff, rec_u.to(torch.int32), fu)
    fv = torch.where(coff, rec_v.to(torch.int32), fv)
    lu = torch.where(coff, 0, lu)
    lv = torch.where(coff, 0, lv)
    levels = torch.stack([ly, lu, lv])
    if not cdef_on:
        return (fy.to(torch.uint8), fu.to(torch.uint8), fv.to(torch.uint8),
                levels, torch.zeros((sbr * sbc, ncand), dtype=torch.int64,
                                    device=dev),
                torch.zeros((), dtype=torch.int64, device=dev))
    ar8 = torch.arange(nb8, device=dev)
    ys8 = ar8 // gw8 * 8
    xs8 = ar8 % gw8 * 8
    blocks = _blocks_at(fy, ys8, xs8, 8)
    cs = bd - 8
    dirs, var = cdef_ops.cdef_find_dir(blocks, cs)
    skip8 = (skip8m if split8 else _up(skip16, 2)).reshape(-1)
    keep = skip8[:, None, None]
    wy = cdef_stage._windows(cdef_stage._pad_vl(fy), ys8, xs8, 8)
    cys, cxs = ys8 // 2, xs8 // 2
    wu = cdef_stage._windows(cdef_stage._pad_vl(fu), cys, cxs, 4)
    wv = cdef_stage._windows(cdef_stage._pad_vl(fv), cys, cxs, 4)
    src_blk = (_blocks_at(src_y, ys8, xs8, 8), _blocks_at(src_u, cys, cxs, 4),
               _blocks_at(src_v, cys, cxs, 4))
    cur_u = _blocks_at(fu, cys, cxs, 4)
    cur_v = _blocks_at(fv, cys, cxs, 4)
    sb_of = (ys8 // 64) * sbc + (xs8 // 64)
    cands_t = _t(cands, dev)

    def filt(cand):
        """The three planes' filtered 8x8 / 4x4 blocks at one strength
        set (a row of cands_t), skip blocks kept."""
        pri_y = cdef_stage._adjust_strength(cand[0] << cs, var)
        sec_y = ((cand[1] + (cand[1] == 3)) << cs).expand(nb8)
        fb_y = cdef_ops.cdef_filter_block(wy, pri_y, sec_y, dirs,
                                          damping + cs, damping + cs, cs,
                                          bd, n=8)
        pri_c = (cand[2] << cs).expand(nb8)
        sec_c = ((cand[3] + (cand[3] == 3)) << cs).expand(nb8)
        fb_u, fb_v = (cdef_ops.cdef_filter_block(
            wc, pri_c, sec_c, dirs, damping - 1 + cs, damping - 1 + cs, cs,
            bd, n=4) for wc in (wu, wv))
        return (torch.where(keep, blocks, fb_y),
                torch.where(keep, cur_u, fb_u),
                torch.where(keep, cur_v, fb_v))

    sses = []
    for ci in range(ncand):
        per8 = sum(((f - s).to(torch.int64) ** 2).sum(dim=(1, 2))
                   for f, s in zip(filt(cands_t[ci]), src_blk))
        sses.append(torch.zeros(sbr * sbc, dtype=torch.int64,
                                device=dev).index_add_(0, sb_of, per8))
    sse_sb = torch.stack(sses, dim=1)                     # (nsb, ncand)
    if not uniform_apply:
        return (fy.to(torch.uint8), fu.to(torch.uint8), fv.to(torch.uint8),
                levels, sse_sb, torch.zeros((), dtype=torch.int64,
                                            device=dev))
    # frame-uniform pick (cdef_bits = 0) and apply, on the device
    best = sse_sb.sum(dim=0).argmin()
    by, bu, bv = filt(cands_t[best])
    out_y, out_u, out_v = fy.clone(), fu.clone(), fv.clone()
    r8 = torch.arange(8, device=dev)
    out_y[(ys8[:, None, None] + r8[:, None]), (xs8[:, None, None] + r8)] = by
    r4 = r8[:4]
    crow = cys[:, None, None] + r4[:, None]
    ccol = cxs[:, None, None] + r4
    out_u[crow, ccol] = bu
    out_v[crow, ccol] = bv
    return (out_y.to(torch.uint8), out_u.to(torch.uint8),
            out_v.to(torch.uint8), levels, sse_sb, best)


def dlf_ladder_params(qindex: int, chroma: bool) -> np.ndarray:
    """(NLVL, 4) [level, blimit, limit, thresh] ladder of the device DLF
    search (dlf_stage._ladder + loop_filter_thresholds)."""
    d = default_filter_level(qindex)
    if chroma:
        d = max(0, d - 2)
    lvls = ([0] + [l for l in _ladder(d) if l > 0])[:NLVL]
    while len(lvls) < NLVL:
        lvls.append(lvls[-1])
    out = np.zeros((NLVL, 4), np.int32)
    for i, l in enumerate(lvls):
        out[i] = (l,) + tuple(dlf_ops.loop_filter_thresholds(max(l, 1)))
    return out


# --------------------------------------------------------------------------
# batched TPL (a whole lookahead group, one host copy)
# --------------------------------------------------------------------------

def tpl_group(srcs, deps):
    """The TPL dispenser over a lookahead group (the reference's
    _jit_tpl_group program): srcs (n, h, w) uint8 on a device, deps[i] a
    tuple of reference indices into the group (empty: an intra anchor).
    Per dependent frame and reference an HME at the TPL radii, its MVs
    clamped, the inter SATD at them; per block the cheapest reference
    wins (first on equal cost).  Returns (n, nb, 5) int32: intra cost,
    best inter cost (0 for an anchor), MV row / col and the winning
    reference's position in deps[i]."""
    ne, h, w = srcs.shape
    gh, gw = h // BLK, w // BLK
    nb = gh * gw
    h64 = (h + 63) & ~63
    w64 = (w + 63) & ~63
    hme_run = me_pipe.hme_core(h64, w64, 8, 8, 4)
    costs = tpl_mod.tpl_costs_core(h, w)
    dev = srcs.device
    ar = torch.arange(nb, device=dev)
    ys, xs = ar // gw * BLK, ar % gw * BLK
    srcs = srcs.to(torch.int32)
    zero = torch.zeros(nb, dtype=torch.int32, device=dev)
    out = []
    for i, dep in enumerate(deps):
        src = srcs[i]
        ic, _ = costs(src)
        best = (zero, torch.zeros((nb, 2), dtype=torch.int32, device=dev),
                zero)
        if dep:
            src64 = _edge_pad_to(src, h64, w64)
            for ri, j in enumerate(dep):
                ref = srcs[j]
                mvy, mvx, _ = hme_run(src64, _edge_pad_to(ref, h64, w64))
                mvs = torch.stack([mvy[:gh, :gw].reshape(nb) * 8,
                                   mvx[:gh, :gw].reshape(nb) * 8], dim=-1)
                mvs = _clamp_cands(mvs[:, None], ys, xs, BLK, h,
                                   w)[:, 0].to(torch.int32)
                _, ec = costs(src, mc.pad_plane(ref, mc.PAD), mvs,
                              intra=False)
                if ri == 0:
                    best = (ec, mvs, zero)
                else:
                    take = ec < best[0]
                    best = (torch.where(take, ec, best[0]),
                            torch.where(take[:, None], mvs, best[1]),
                            torch.where(take, ri, best[2]))
        out.append(torch.cat([ic[:, None], best[0][:, None], best[1],
                              best[2][:, None]], dim=1).to(torch.int32))
    return torch.stack(out)


def tpl_group_stats(srcs, deps, device=None):
    """TPL dispenser stats of a lookahead group on ``device`` (default:
    the current CUDA device): srcs = [(h, w) uint8 arrays], deps[i] a
    list or None of reference indices.  Returns the per-frame dicts that
    tpl.synthesize takes, brought to the host in one copy.  The costs are
    integer SATDs below 2^24; the reference holds them in float32 and
    returns them as float64, as here."""
    dev = device_mod.resolve(device)
    h, w = srcs[0].shape
    gh, gw = h // BLK, w // BLK
    key = tuple(tuple(d) if d else () for d in deps)
    packed = torch.from_numpy(np.stack([np.asarray(s, np.uint8)
                                        for s in srcs])).to(dev)
    res = tpl_group(packed, key).cpu().numpy()
    out = []
    for i, dep in enumerate(key):
        st = dict(intra=res[i, :, 0].astype(np.float64), gh=gh, gw=gw)
        if not dep:
            st.update(inter=np.full(gh * gw, np.inf),
                      mv=np.zeros((gh * gw, 2), np.int32),
                      ref_sel=np.zeros(gh * gw, np.int32))
        else:
            st.update(inter=res[i, :, 1].astype(np.float64),
                      mv=np.ascontiguousarray(res[i, :, 2:4]),
                      ref_sel=res[i, :, 4].copy())
        out.append(st)
    return out


# --------------------------------------------------------------------------
# host orchestration
# --------------------------------------------------------------------------

class PendingInterFrame:
    """One dispatched inter frame: the P1 and P2 outputs on the device and
    the host copies of what collect_inter_frame reads (issued
    non-blocking at dispatch).  ``recon`` (the post-filter planes) is the
    frame's DPB entry, usable by later frames at once."""

    def __init__(self, outs, p2_outs, ref_enums, h, w, qindex):
        self.outs = outs
        self.p2_outs = p2_outs
        self.ref_enums = ref_enums
        self.h, self.w = h, w
        self.qindex = qindex
        self.recon = dict(y=p2_outs[0], u=p2_outs[1], v=p2_outs[2])
        small = list(outs[3:]) + [p2_outs[3], p2_outs[5]]
        self.host = [t.to("cpu", non_blocking=True) for t in small]


def _src_planes(src_pack_u8, h, w, dev):
    sp = torch.as_tensor(np.ascontiguousarray(src_pack_u8), device=dev)
    return (sp[:h].to(torch.int32), sp[h:, :w // 2].to(torch.int32),
            sp[h:, w // 2:].to(torch.int32))


@functools.lru_cache(maxsize=16)
def _inter_rates(qindex: int, modes: tuple, exact: bool, device):
    return md_rate_args(qindex, modes, UV_MODES, inter_frame=True,
                        exact=exact, device=device)


def run_inter_frame(src_pack_u8: np.ndarray, refs: Dict[int, Dict],
                    qindex: int, h: int, w: int, modes, bd: int = 8,
                    ring: bool = True, rad2: int = 8, rad0: int = 7,
                    cdef_cands=None, dlf_on: bool = True,
                    cdef_on: bool = True, cdf_state=None, hp: bool = False,
                    obmc: bool = False, interintra: bool = False,
                    exact_rates: bool = False, skip_mode: bool = False,
                    tx_search: bool = False, split8: bool = False,
                    device=None) -> PendingInterFrame:
    """Run P1 + P2 of one inter frame on ``device`` (default: the current
    CUDA device).  src_pack_u8: (H + H/2, W) uint8, luma above U|V; refs:
    {ref_enum: dict of y/u/v device planes}, LAST first.  Returns a
    PendingInterFrame; finish it with collect_inter_frame."""
    _check_p1_tools(hp)
    if cdf_state is not None:   # adapted rate tables: not ported, raises
        md_rate_args(qindex, (), (), cdf_state=cdf_state)
    dev = device_mod.resolve(device)
    ref_enums = sorted(refs)
    R = len(ref_enums)
    refs_y, refs_u, refs_v = (torch.stack([refs[e][p].to(dev)
                                           for e in ref_enums])
                              for p in ("y", "u", "v"))
    src = _src_planes(src_pack_u8, h, w, dev)
    qp = quant.params_on(int(qindex), dev, bd)
    lam = torch.tensor(frame_lambda(qindex, bd), device=dev)
    rt = _inter_rates(int(qindex), tuple(modes), bool(exact_rates), dev)
    has_bwd = R >= 2 and ref_enums[-1] == 7   # ALTREF_FRAME present
    p1 = build_p1(h, w, R, tuple(modes), bd, ring, has_bwd, rad2, rad0,
                  hp, obmc, interintra, skip_mode and has_bwd, tx_search,
                  split8)
    outs = p1(*src, refs_y, refs_u, refs_v, qp, lam, rt)
    cands = np.asarray(cdef_cands if cdef_cands is not None
                       else cdef_stage.SEARCH_SET, np.int32)
    qy_f, qu_f, qv_f = outs[15], outs[16], outs[17]
    gh, gw = h // BLK, w // BLK
    skip16 = ((qy_f == 0).all(dim=1) & (qu_f == 0).all(dim=1)
              & (qv_f == 0).all(dim=1)).reshape(gh, gw)
    split16 = skip8 = None
    if split8:
        split16 = outs[25].reshape(gh, gw)
        skip8 = _derive_skip8(qy_f, qu_f, qv_f, skip16, split16, gh, gw)
    with _region("p2"):
        p2_outs = p2(*src, *outs[:3], skip16,
                     dlf_ladder_params(qindex, False),
                     dlf_ladder_params(qindex, True), cands,
                     cdef_stage.cdef_damping(qindex), bd, dlf_on, cdef_on,
                     merge32=outs[22], inter16=outs[5].reshape(gh, gw),
                     merge64=outs[23], mergeh=outs[28], mergev=outs[29],
                     split16=split16, skip8m=skip8)
    pend = PendingInterFrame(outs, p2_outs, ref_enums, h, w, qindex)
    pend.cdef_cands = cands
    pend.cdef_on = cdef_on
    return pend


def run_key_filters(src: Dict[str, np.ndarray],
                    recon: Dict[str, torch.Tensor], skip16: np.ndarray,
                    qindex: int, bd: int = 8, cdef_cands=None,
                    dlf_on: bool = True, cdef_on: bool = True,
                    max_bits: int = 3):
    """Key-frame filter stage of the GOP path: P2 in search mode (DLF
    ladder + per-SB / per-candidate CDEF SSE), one small copy to the host,
    the host subset selection (cdef_stage.select_sb_sets), then the CDEF
    apply on the device.

    Returns (recon_out, deblocked, fp_updates, cdef_idx_map): recon_out
    the final planes and deblocked the post-DLF planes (device tensors),
    fp_updates the frame-header fields to set."""
    dev = recon["y"].device
    srcs = tuple(torch.as_tensor(np.ascontiguousarray(src[p]),
                                 device=dev).to(torch.int32)
                 for p in ("y", "u", "v"))
    cands = np.asarray(cdef_cands if cdef_cands is not None
                       else cdef_stage.SEARCH_SET, np.int32)
    damping = cdef_stage.cdef_damping(qindex)
    fy, fu, fv, levels, sse_sb, _ = p2(
        *srcs, recon["y"], recon["u"], recon["v"],
        torch.as_tensor(np.asarray(skip16, bool), device=dev),
        dlf_ladder_params(qindex, False), dlf_ladder_params(qindex, True),
        cands, damping, bd, dlf_on, cdef_on, uniform_apply=False)
    levels_h, sse_h = levels.cpu().numpy(), sse_sb.cpu().numpy()
    fp_updates = {}
    if dlf_on:
        ly, lu, lv = (int(x) for x in levels_h)
        fp_updates["filter_level"] = (ly, ly)
        fp_updates["filter_level_uv"] = (lu, lv)
    deblocked = dict(y=fy, u=fu, v=fv)
    idx_map = None
    out = deblocked
    if cdef_on:
        coded = cdef_stage.coded_sb_map(np.asarray(skip16))
        qstep = quant.dc_q(qindex, bd=bd) / 8.0
        lam = 0.7 * qstep * qstep
        bits, sets, idx_map = cdef_stage.select_sb_sets(
            np.asarray(sse_h, np.float64), coded, lam,
            [tuple(int(x) for x in c) for c in cands], max_bits)
        if bits:
            raise NotImplementedError(
                "per-SB CDEF strengths (cdef_bits > 0): ROADMAP.md queue A "
                "item 7")
        out = cdef_stage.cdef_apply(deblocked, np.asarray(skip16), sets[0],
                                    damping, bd)
        fp_updates.update(cdef_bits=0, cdef_strengths=sets[0],
                          cdef_strength_list=None, cdef_damping=damping)
        idx_map = None
    return out, deblocked, fp_updates, idx_map


def collect_inter_frame(pend: PendingInterFrame, bd: int = 8):
    """The one bundled device-to-host copy, then the per-block decisions.
    Returns (decisions, recon on the device, header info)."""
    from svt_av1_tpu_torch.codec import mv_pred
    from svt_av1_tpu_torch.codec.syntax import BlockDecision
    from svt_av1_tpu_torch.utils.profiling import stage
    h, w = pend.h, pend.w
    gh, gw = h // BLK, w // BLK
    nb = gh * gw
    with stage("collect_pull"):
        dev = pend.recon["y"].device
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()
        pulled = [t.numpy() for t in pend.host]
    (ymode, umode, choose, iskip, imv, imv2, iref_idx, icomp, iwarp,
     iwedge, iobmc, iimodes, qy_f, qu_f, qv_f, gm_mats, gm_trans, gm_kinds,
     interp, merge32, merge64, itx, isplit, ismv, issk, mergeh, mergev,
     dlf_levels, best_ci) = pulled
    cdef_info = None
    if pend.cdef_on:
        strengths = tuple(int(x) for x in pend.cdef_cands[int(best_ci)])
        cdef_info = dict(bits=0, sets=(strengths,), idx_map=None,
                         best_ci=int(best_ci))
    gm = {}
    for i, e in enumerate(pend.ref_enums):
        k = int(gm_kinds[i])
        if k == 2:
            gm[e] = tuple(int(x) for x in gm_mats[i])
        elif k == 1:
            gm[e] = (int(gm_trans[i][0]), int(gm_trans[i][1]))
    qy_f = qy_f.astype(np.int32).reshape(nb, BLK, BLK)
    qu_f = qu_f.astype(np.int32).reshape(nb, CBLK, CBLK)
    qv_f = qv_f.astype(np.int32).reshape(nb, CBLK, CBLK)
    enums = pend.ref_enums
    gh2, gw2 = gh // 2, gw // 2
    gh4, gw4 = gh2 // 2, gw2 // 2

    def up(m, gr, gc, k):
        out = np.zeros((gh, gw), bool)
        if gr and gc:
            out[:gr * k, :gc * k] = np.repeat(np.repeat(
                np.asarray(m).reshape(gr, gc), k, 0), k, 1)
        return out

    merged16 = up(merge32, gh2, gw2, 2)
    merged64_16 = up(merge64, gh4, gw4, 4)
    recth16 = up(mergeh, gh2, gw2, 2)
    rectv16 = up(mergev, gh2, gw2, 2)

    def inter_leaf(bid, r4, c4, bsize, zy, zc):
        return BlockDecision(
            r4=r4, c4=c4, bsize=bsize, y_mode=cc.DC_PRED,
            uv_mode=cc.DC_PRED, tx_type=cc.DCT_DCT,
            qcoeff_y=np.zeros(zy, np.int32), qcoeff_u=np.zeros(zc, np.int32),
            qcoeff_v=np.zeros(zc, np.int32), is_inter=True,
            mv=(int(imv[bid, 0]), int(imv[bid, 1])),
            ref=int(enums[iref_idx[bid]]),
            ref2=(int(mv_pred.ALTREF_FRAME) if icomp[bid] else 0),
            mv2=((int(imv2[bid, 0]), int(imv2[bid, 1]))
                 if icomp[bid] else (0, 0)))

    decisions = {}
    for bid in range(nb):
        by, bx = bid // gw, bid % gw
        r4, c4 = by * 4, bx * 4
        if merged64_16[by, bx]:
            if not (by % 4 or bx % 4):     # else covered by the 64x64 leaf
                decisions[(r4, c4)] = inter_leaf(
                    bid, r4, c4, cc.BLOCK_64X64, (64, 64), (32, 32))
            continue
        if merged16[by, bx]:
            if not (by % 2 or bx % 2):     # else covered by the 32x32 leaf
                decisions[(r4, c4)] = inter_leaf(
                    bid, r4, c4, cc.BLOCK_32X32, (32, 32), (16, 16))
            continue
        if recth16[by, bx] or rectv16[by, bx]:
            if by % 2 or bx % 2:
                continue                   # covered by the pair's leaves
            horz = bool(recth16[by, bx])
            for half in (0, 1):
                hb = bid + half * (gw if horz else 1)
                decisions[(r4 + (4 * half if horz else 0),
                           c4 + (0 if horz else 4 * half))] = inter_leaf(
                    hb, r4 + (4 * half if horz else 0),
                    c4 + (0 if horz else 4 * half),
                    cc.BLOCK_32X16 if horz else cc.BLOCK_16X32,
                    (16, 32) if horz else (32, 16),
                    (8, 16) if horz else (16, 8))
            continue
        if choose[bid] and isplit[bid]:
            # 8x8 split: four single-reference leaves, each with its own
            # MV, TX_8X8 luma and TX_4X4 chroma quadrant
            ref_e = int(enums[iref_idx[bid]])
            for si, (dy, dx) in enumerate(((0, 0), (0, 8), (8, 0), (8, 8))):
                cy0, cx0 = dy // 2, dx // 2
                key = (r4 + dy // 4, c4 + dx // 4)
                decisions[key] = BlockDecision(
                    r4=key[0], c4=key[1], bsize=cc.BLOCK_8X8,
                    y_mode=cc.DC_PRED, uv_mode=cc.DC_PRED, tx_type=cc.DCT_DCT,
                    qcoeff_y=qy_f[bid][dy:dy + 8, dx:dx + 8].copy(),
                    qcoeff_u=qu_f[bid][cy0:cy0 + 4, cx0:cx0 + 4].copy(),
                    qcoeff_v=qv_f[bid][cy0:cy0 + 4, cx0:cx0 + 4].copy(),
                    is_inter=True,
                    mv=(int(ismv[bid, si, 0]), int(ismv[bid, si, 1])),
                    ref=ref_e)
            continue
        if choose[bid]:
            mcode = int(iwedge[bid]) if icomp[bid] else -1
            if mcode >= 64:      # DIFFWTD (mask_type in the low bit)
                ctyp, widx_, wsgn = 2, 0, mcode - 64
            elif mcode >= 0:     # WEDGE (sign * 16 + index)
                ctyp, widx_, wsgn = 1, mcode & 15, mcode >> 4
            else:
                ctyp = widx_ = wsgn = 0
            decisions[(r4, c4)] = BlockDecision(
                r4=r4, c4=c4, bsize=cc.BLOCK_16X16, y_mode=cc.DC_PRED,
                uv_mode=cc.DC_PRED, tx_type=_ITX_ENUM[int(itx[bid])],
                qcoeff_y=qy_f[bid], qcoeff_u=qu_f[bid], qcoeff_v=qv_f[bid],
                is_inter=True, mv=(int(imv[bid, 0]), int(imv[bid, 1])),
                ref=int(enums[iref_idx[bid]]), use_warp=bool(iwarp[bid]),
                ref2=(int(mv_pred.ALTREF_FRAME) if icomp[bid] else 0),
                mv2=((int(imv2[bid, 0]), int(imv2[bid, 1]))
                     if icomp[bid] else (0, 0)),
                comp_type=ctyp, wedge_idx=widx_, wedge_sign=wsgn,
                motion_mode=int(bool(iobmc[bid])),
                interintra_mode=int(iimodes[bid]))
        else:
            decisions[(r4, c4)] = BlockDecision(
                r4=r4, c4=c4, bsize=cc.BLOCK_16X16, y_mode=int(ymode[bid]),
                uv_mode=int(umode[bid]), tx_type=cc.DCT_DCT,
                qcoeff_y=qy_f[bid], qcoeff_u=qu_f[bid], qcoeff_v=qv_f[bid])
    header = dict(gm=gm, interp=int(interp),
                  dlf_levels=tuple(int(x) for x in dlf_levels),
                  cdef=cdef_info)
    return decisions, pend.recon, header
