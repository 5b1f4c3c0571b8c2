"""Inter frames: the reference's stage-path encoder and the decoder-side
reconstruction, the PyTorch port of svt_av1_tpu/pipeline/inter_encoder.py.

The stage path (``encode_inter_frame``) codes every inter frame that the
fast GOP path (pipeline/gop_fast.py) does not: IPPP, low-delay and S-frame
streams, and hierarchical GOPs at 10 bits, with film grain or with tile
columns.  It runs as the reference's does, in three steps on ``device``:

  pass A: per reference, HME (pipeline/me.hierarchical_me), the
  global-motion fits (host numpy float64, copied verbatim) and one batched
  evaluation of K candidates per 16x16 block (GLOBALMV or the warped
  reference, the HME winner and its quarter-pel ring) through MC,
  forward transform, quantizer and the RD cost; the references merge by
  cost; the COMPOUND_AVERAGE probe competes on B frames;
  pass B: the intra wave loop (pipeline/intra_encoder._rd_step and
  _rd_step_chroma) with the inter winner as a per-block override, so
  that intra blocks predict from the mixed recon; its luma step runs the
  fused transform + quantizer kernel (ops/fused_txq, K1) on every wave.

Pass A and the compound probe transform with fwd_txfm2d + quantize, as in
the reference (no Pallas kernel there).  The recon stays on the device
(uint8, or int16 at 10 bits).

Where the reference's reconstruction departs from the AV1 specification,
this one follows the specification (ROADMAP.md queue C item 4):
  - OBMC and inter-intra blocks invert their residual with the signaled
    tx type (spec 7.13.3 takes the type of every inter block from the
    bitstream; the reference inverts them with DCT_DCT);
  - an OBMC block blends each overlappable neighbour at its own MV, an
    8x8 split neighbour per 8-px segment with the MV of the sub that
    touches the block (spec 7.11.3.10; the reference takes the top-left
    sub's MV, while its encoder leaves such a neighbour out).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from svt_av1_tpu_torch import device as device_mod
from svt_av1_tpu_torch.codec import constants as cc
from svt_av1_tpu_torch.codec import mv_pred
from svt_av1_tpu_torch.codec.rate_est import md_rate_args
from svt_av1_tpu_torch.codec.syntax import (BlockDecision,
                                             _chroma_tx_type_inter)
from svt_av1_tpu_torch.ops import mc, quant, transforms as tf
from svt_av1_tpu_torch.ops import obmc as obmc_ops
from svt_av1_tpu_torch.ops import warp as warp_ops
from svt_av1_tpu_torch.ops import wedge as wedge_ops
from svt_av1_tpu_torch.pipeline import intra_encoder as ie
from svt_av1_tpu_torch.pipeline import me as me_pipe

BLK = 16
CBLK = 8

# candidate MV offsets around the HME winner (1/8 pel): the fullpel
# winner plus its quarter-pel ring
_SUBPEL_RING = np.array(
    [(0, 0), (0, 2), (0, -2), (2, 0), (-2, 0),
     (2, 2), (2, -2), (-2, 2), (-2, -2)], np.int32)
K_CANDS = 1 + len(_SUBPEL_RING)  # GLOBALMV + the HME ring


def _mv_bits(mvs: torch.Tensor) -> torch.Tensor:
    """Rough NEWMV signaling cost in bits (non-normative RD estimate)."""
    a = mvs.to(torch.float32).abs()
    return 4.0 + 1.4 * (torch.log2(1.0 + a[:, 0]) + torch.log2(1.0 + a[:, 1]))


def _signaled_tx_type(d):
    """Luma tx type as a decoder derives it: read only for a non-skip luma
    txb with coefficients, else DCT_DCT (and chroma inherits that)."""
    if not np.any(d.qcoeff_y):
        return cc.DCT_DCT
    return d.tx_type


def _inv_add_mixed(dq, pred, txts, tx_size, bd):
    """Batched inv_txfm2d_add with a per-block tx type: one inverse per
    distinct type present, selected per block."""
    types = sorted(set(int(t) for t in txts))
    out = tf.inv_txfm2d_add(dq, pred, types[0], tx_size, bd=bd)
    sel = np.asarray(txts)
    for t in types[1:]:
        rec_t = tf.inv_txfm2d_add(dq, pred, t, tx_size, bd=bd)
        out = torch.where(torch.as_tensor(sel == t, device=dq.device)
                          [:, None, None], rec_t, out)
    return out


def _put(plane, blocks, ys, xs):
    """Write (B, n, n) blocks into an (H, W) plane in place."""
    n = blocks.shape[-1]
    ar = torch.arange(n, device=plane.device)
    plane[ys[:, None, None] + ar[:, None], xs[:, None, None] + ar] = blocks


def _stack_levels(decs, field, dev):
    return torch.as_tensor(np.stack([getattr(d, field) for d in decs]),
                           device=dev).to(torch.int32)


def _recon_inter_blocks_for_ref(decisions, renum, ref, refp, recon, qp, bd,
                                gm_model=None, interp=0, blk=BLK):
    """Single-reference translational (and GLOBALMV warped) blocks of
    width ``blk`` (16: TX_16X16 luma / TX_8X8 chroma; 8: the 8x8 split
    leaves, TX_8X8 / TX_4X4) predicting from ``renum``, simple motion
    only: one MC batch per plane, then the inverse."""
    keys = [k for k, d in decisions.items()
            if d.is_inter and d.ref == renum and not d.ref2
            and not d.motion_mode and d.interintra_mode < 0
            and int(cc.block_size_wide[d.bsize]) == blk]
    if not keys:
        return
    dev = recon["y"].device
    decs = [decisions[k] for k in keys]
    ys = torch.as_tensor([k[0] * 4 for k in keys], device=dev)
    xs = torch.as_tensor([k[1] * 4 for k in keys], device=dev)
    mvs = torch.as_tensor([d.mv for d in decs], dtype=torch.int32,
                          device=dev)
    wsel = torch.as_tensor([bool(d.use_warp) for d in decs], device=dev)
    wplanes = None
    if any(d.use_warp for d in decs):
        # GLOBALMV + ROTZOOM: the whole-frame warp, sliced per block
        assert gm_model is not None and len(gm_model) == 6
        h, w = recon["y"].shape
        wplanes = dict(
            y=warp_ops.warp_plane(ref["y"].to(torch.int32), gm_model, w, h,
                                  bd=bd),
            u=warp_ops.warp_plane(ref["u"].to(torch.int32), gm_model,
                                  w // 2, h // 2, bd=bd, subsampling=1),
            v=warp_ops.warp_plane(ref["v"].to(torch.int32), gm_model,
                                  w // 2, h // 2, bd=bd, subsampling=1))
    txts_y = [_signaled_tx_type(d) for d in decs]
    for p in ("y", "u", "v"):
        luma = p == "y"
        n = blk if luma else blk // 2
        tx = _TX_OF[n]
        py, px = (ys, xs) if luma else (ys // 2, xs // 2)
        pred = mc.mc_blocks(refp[p], py, px, mvs, n, mc.PAD, 0 if luma else 1,
                            bd, kind=interp)
        if wplanes is not None:
            ar = torch.arange(n, device=dev)
            wsl = wplanes[p][py[:, None, None] + ar[:, None],
                             px[:, None, None] + ar]
            pred = torch.where(wsel[:, None, None], wsl, pred)
        dq = quant.dequantize(_stack_levels(decs, f"qcoeff_{p}", dev), qp, tx)
        txts = (txts_y if luma else
                [_chroma_tx_type_inter(t, tx, False) for t in txts_y])
        _put(recon[p], _inv_add_mixed(dq, pred, txts, tx, bd), py, px)


_TX_OF = {16: cc.TX_16X16, 8: cc.TX_8X8, 4: cc.TX_4X4}


def _mc_by_ref(refps, refs_e, ys, xs, mvs, plane, bd, interp):
    """MC of a batch of 16x16 blocks (8x8 chroma), each from its own
    reference enum ``refs_e``, plane y/u/v."""
    n, ss = (BLK, 0) if plane == "y" else (CBLK, 1)
    if ss:
        ys, xs = ys // 2, xs // 2
    out = None
    for e in dict.fromkeys(refs_e):
        pr = mc.mc_blocks(refps[e][plane], ys, xs, mvs, n, mc.PAD, ss, bd,
                          kind=interp)
        if out is None:
            out = pr
        else:
            sel = torch.as_tensor(np.asarray(refs_e) == e, device=ys.device)
            out = torch.where(sel[:, None, None], pr, out)
    return out


def _leaf_at(work, r4, c4):
    """The leaf covering mi (r4, c4) of a decision map whose merged leaves
    were expanded to 16x16 tiles: a 16x16 tile or an 8x8 split leaf."""
    d = work.get((r4 & ~3, c4 & ~3))
    if d is not None and d.bsize == cc.BLOCK_16X16:
        return d
    return work.get((r4 & ~1, c4 & ~1))


def obmc_segments(work, keys):
    """The overlappable neighbours of OBMC blocks (spec 7.11.3.10 on the
    16x16 grid): for the two 8-px segments of the above edge, then of the
    left edge, the (ref, mv) of the leaf beyond each segment, or None
    where it is intra or outside the frame.  A 16-wide or wider neighbour
    gives both segments one MV; an 8x8 split neighbour one each, from the
    sub that touches the block."""
    out = []
    for r4, c4 in keys:
        segs = []
        for j in (0, 1):
            nd = _leaf_at(work, r4 - 1, c4 + 2 * j + 1) if r4 else None
            segs.append((nd.ref, nd.mv) if nd is not None and nd.is_inter
                        else None)
        for j in (0, 1):
            nd = _leaf_at(work, r4 + 2 * j + 1, c4 - 1) if c4 else None
            segs.append((nd.ref, nd.mv) if nd is not None and nd.is_inter
                        else None)
        out.append(segs)
    return out


def _recon_obmc_blocks(work, refps, recon, qp, bd, interp):
    """OBMC_CAUSAL 16x16 blocks: the block's own prediction blended with
    its above segments' predictions over the top half, then its left
    segments' over the left half (the normative masks, spec 7.11.3.10),
    then the residual at the signaled tx type."""
    keys = [k for k, d in work.items() if d.is_inter and d.motion_mode == 1]
    if not keys:
        return
    dev = recon["y"].device
    decs = [work[k] for k in keys]
    ys = torch.as_tensor([k[0] * 4 for k in keys], device=dev)
    xs = torch.as_tensor([k[1] * 4 for k in keys], device=dev)
    segs = obmc_segments(work, keys)
    own = torch.as_tensor([d.mv for d in decs], dtype=torch.int32,
                          device=dev)
    own_ref = [d.ref for d in decs]
    seg_in = []
    for j in range(4):
        on = [s[j] is not None for s in segs]
        seg_in.append((
            torch.as_tensor(on, device=dev),
            [s[j][0] if s[j] is not None else d.ref
             for s, d in zip(segs, decs)],
            torch.as_tensor([s[j][1] if s[j] is not None else d.mv
                             for s, d in zip(segs, decs)],
                            dtype=torch.int32, device=dev)))
    my = torch.as_tensor(obmc_ops.MASK_Y16, device=dev)
    mc8 = torch.as_tensor(obmc_ops.MASK_C8, device=dev)
    txts_y = [_signaled_tx_type(d) for d in decs]
    for p in ("y", "u", "v"):
        luma = p == "y"
        n, tx = (BLK, cc.TX_16X16) if luma else (CBLK, cc.TX_8X8)
        half = torch.arange(n, device=dev) < n // 2
        pred = _mc_by_ref(refps, own_ref, ys, xs, own, p, bd, interp)
        for first, fn in ((0, obmc_ops.blend_above),
                          (2, obmc_ops.blend_left)):
            (on0, r0, m0), (on1, r1, m1) = seg_in[first], seg_in[first + 1]
            p0 = _mc_by_ref(refps, r0, ys, xs, m0, p, bd, interp)
            p1 = _mc_by_ref(refps, r1, ys, xs, m1, p, bd, interp)
            # the segment of a sample: its column for the above edge, its
            # row for the left edge
            at = (lambda v: v[:, None, :]) if first == 0 else (
                lambda v: v[:, :, None])
            h3 = at(half[None].expand(len(keys), n))
            pn = torch.where(h3, p0, p1)
            on = torch.where(h3, at(on0[:, None].expand(-1, n)),
                             at(on1[:, None].expand(-1, n)))
            pred = torch.where(on, fn(pred, pn, my if luma else mc8), pred)
        dq = quant.dequantize(_stack_levels(decs, f"qcoeff_{p}", dev), qp, tx)
        txts = (txts_y if luma else
                [_chroma_tx_type_inter(t, tx, False) for t in txts_y])
        py, px = (ys, xs) if luma else (ys // 2, xs // 2)
        _put(recon[p], _inv_add_mixed(dq, pred, txts, tx, bd), py, px)


def _recon_compound_blocks(decisions, refps, recon, qp, bd, interp=0):
    """Two-reference blocks: COMPOUND_AVERAGE, wedge and diffwtd."""
    keys = [k for k, d in decisions.items() if d.is_inter and d.ref2]
    if not keys:
        return
    dev = recon["y"].device
    for (r0, r1) in sorted({(decisions[k].ref, decisions[k].ref2)
                            for k in keys}):
        pk = [k for k in keys
              if (decisions[k].ref, decisions[k].ref2) == (r0, r1)]
        decs = [decisions[k] for k in pk]
        ys = torch.as_tensor([k[0] * 4 for k in pk], device=dev)
        xs = torch.as_tensor([k[1] * 4 for k in pk], device=dev)
        mv0 = torch.as_tensor([d.mv for d in decs], dtype=torch.int32,
                              device=dev)
        mv1 = torch.as_tensor([d.mv2 for d in decs], dtype=torch.int32,
                              device=dev)
        wsel_np = np.array([d.comp_type == 1 for d in decs])
        dsel_np = np.array([d.comp_type == 2 for d in decs])
        wsel = torch.as_tensor(wsel_np, device=dev)[:, None, None]
        dsel = torch.as_tensor(dsel_np, device=dev)[:, None, None]
        mask_y = mask_uv = mask_uv_d = None
        if wsel_np.any():
            assert all(d.bsize == cc.BLOCK_16X16 for d in decs
                       if d.comp_type == 1), "wedge masks only for 16x16"
            idx = np.array([d.wedge_idx for d in decs])
            sgn = np.array([d.wedge_sign for d in decs])
            mask_y = torch.as_tensor(wedge_ops.masks_16[sgn, idx].astype(
                np.int32), device=dev)
            mask_uv = torch.as_tensor(wedge_ops.masks_16_uv[sgn, idx].astype(
                np.int32), device=dev)
        p0, p1 = refps[r0], refps[r1]
        comp = lambda p, yy, xx, n, ss, mask=None: mc.mc_blocks_compound(
            p0[p], p1[p], yy, xx, mv0, mv1, n, mc.PAD, ss, bd, kind=interp,
            mask=mask)
        pred_y = comp("y", ys, xs, BLK, 0)
        if wsel_np.any():
            pred_y = torch.where(wsel, comp("y", ys, xs, BLK, 0, mask_y),
                                 pred_y)
        if dsel_np.any():
            inv = torch.as_tensor([d.wedge_sign for d in decs],
                                  dtype=torch.int32, device=dev)
            pred_d, m16 = mc.mc_blocks_compound_diffwtd(
                p0["y"], p1["y"], ys, xs, mv0, mv1, BLK, mc.PAD, inv, bd,
                kind=interp)
            pred_y = torch.where(dsel, pred_d, pred_y)
            mask_uv_d = (m16[:, ::2, ::2] + m16[:, 1::2, ::2]
                         + m16[:, ::2, 1::2] + m16[:, 1::2, 1::2] + 2) >> 2
        dq = quant.dequantize(_stack_levels(decs, "qcoeff_y", dev), qp,
                              cc.TX_16X16)
        _put(recon["y"], tf.inv_txfm2d_add(dq, pred_y, cc.DCT_DCT,
                                           cc.TX_16X16, bd=bd), ys, xs)
        cys, cxs = ys // 2, xs // 2
        for p in ("u", "v"):
            pred_c = comp(p, cys, cxs, CBLK, 1)
            if wsel_np.any():
                pred_c = torch.where(wsel, comp(p, cys, cxs, CBLK, 1,
                                                mask_uv), pred_c)
            if dsel_np.any():
                pred_c = torch.where(dsel, comp(p, cys, cxs, CBLK, 1,
                                                mask_uv_d), pred_c)
            dqc = quant.dequantize(_stack_levels(decs, f"qcoeff_{p}", dev),
                                   qp, cc.TX_8X8)
            _put(recon[p], tf.inv_txfm2d_add(dqc, pred_c, cc.DCT_DCT,
                                             cc.TX_8X8, bd=bd), cys, cxs)


def reconstruct_inter_from_decisions(decisions: Dict, refs, width: int,
                                     height: int, qindex: int, bd: int = 8,
                                     gm=None, interp=0, device=None):
    """Decoder-side reconstruction of an inter frame on ``device``
    (default: the current CUDA device).

    refs: {ref_enum: dict of y/u/v planes} (tensors or numpy).  Simple,
    compound and OBMC inter blocks have no in-frame dependencies and
    reconstruct as batches (merged 32x32 / 64x64 / rect skip leaves as
    16x16 tiles with the shared MV: identical pixels, since the MV passed
    the big block's pad clamp; 8x8 split leaves at their own size); intra
    and inter-intra blocks then run in the 2:1 wave order over the mixed
    recon, an inter-intra block blending its intra prediction with its
    inter prediction.  Returns dict(y, u, v) of uint8 planes on
    ``device``."""
    from svt_av1_tpu_torch.pipeline.intra_encoder import (
        reconstruct_from_decisions)
    dev = device_mod.resolve(device)
    big = (cc.BLOCK_32X32, cc.BLOCK_64X64, cc.BLOCK_32X16, cc.BLOCK_16X32,
           cc.BLOCK_64X32, cc.BLOCK_32X64)
    for d in decisions.values():
        if d.is_inter and d.bsize not in big + (cc.BLOCK_16X16,
                                                cc.BLOCK_8X8):
            raise NotImplementedError(
                f"inter block size {d.bsize}: ROADMAP.md queue A item 7")
        if d.is_inter and d.interintra_mode >= 0 and d.ii_wedge_idx >= 0:
            raise NotImplementedError(
                "wedge inter-intra (the reference's encoder codes the "
                "smooth masks only): ROADMAP.md queue A item 7")
    work = {}
    for k, d in decisions.items():
        if d.is_inter and d.bsize in big:
            assert d.skip, "non-skip merged inter needs big-TX recon"
            w4 = int(cc.block_size_wide[d.bsize]) >> 2
            h4 = int(cc.block_size_high[d.bsize]) >> 2
            for dr in range(0, h4, 4):
                for dc2 in range(0, w4, 4):
                    nk = (k[0] + dr, k[1] + dc2)
                    work[nk] = dataclasses.replace(
                        d, r4=nk[0], c4=nk[1], bsize=cc.BLOCK_16X16,
                        qcoeff_y=np.zeros((BLK, BLK), np.int32),
                        qcoeff_u=np.zeros((CBLK, CBLK), np.int32),
                        qcoeff_v=np.zeros((CBLK, CBLK), np.int32))
        else:
            work[k] = d
    qp = quant.params_on(int(qindex), dev, bd)
    recon = dict(y=torch.zeros((height, width), dtype=torch.int32,
                               device=dev),
                 u=torch.zeros((height // 2, width // 2), dtype=torch.int32,
                               device=dev))
    recon["v"] = torch.zeros_like(recon["u"])
    refs = {e: {p: torch.as_tensor(np.asarray(r[p]) if not isinstance(
        r[p], torch.Tensor) else r[p]).to(dev) for p in ("y", "u", "v")}
        for e, r in refs.items() if r is not None}
    ii_keys = [k for k, d in work.items()
               if d.is_inter and d.interintra_mode >= 0]
    obmc_keys = [k for k, d in work.items()
                 if d.is_inter and d.motion_mode == 1]
    used = {d.ref for d in work.values() if d.is_inter} | {
        d.ref2 for d in work.values() if d.is_inter and d.ref2}
    for segs in obmc_segments(work, obmc_keys):
        used |= {s[0] for s in segs if s is not None}
    refps = {e: dict(y=mc.pad_plane(refs[e]["y"], mc.PAD),
                     u=mc.pad_plane(refs[e]["u"], mc.PAD // 2),
                     v=mc.pad_plane(refs[e]["v"], mc.PAD // 2))
             for e in refs if e in used}
    for renum in refps:
        for blk in (BLK, BLK // 2):
            _recon_inter_blocks_for_ref(work, renum, refs[renum],
                                        refps[renum], recon, qp, bd,
                                        gm_model=(gm or {}).get(renum),
                                        interp=interp, blk=blk)
    _recon_compound_blocks(work, refps, recon, qp, bd, interp)
    _recon_obmc_blocks(work, refps, recon, qp, bd, interp)
    ii = None
    if ii_keys:
        # the inter half of each inter-intra block; the wave loop blends
        # it with the intra half
        gw = width // BLK
        ys = torch.as_tensor([k[0] * 4 for k in ii_keys], device=dev)
        xs = torch.as_tensor([k[1] * 4 for k in ii_keys], device=dev)
        mvs = torch.as_tensor([work[k].mv for k in ii_keys],
                              dtype=torch.int32, device=dev)
        ii = dict(bids=[(k[0] // 4) * gw + k[1] // 4 for k in ii_keys],
                  preds={p: _mc_by_ref(refps, [work[k].ref for k in ii_keys],
                                       ys, xs, mvs, p, bd, interp)
                         for p in ("y", "u", "v")})
    intra = {k: d for k, d in work.items()
             if not d.is_inter or d.interintra_mode >= 0}
    return reconstruct_from_decisions(intra, width, height, qindex, bd=bd,
                                      device=dev, base=recon, inter_intra=ii)


# --------------------------------------------------------------------------
# the stage path's encoder (encode_inter_frame and its passes)
# --------------------------------------------------------------------------

def estimate_global_translation(mv_y: np.ndarray, mv_x: np.ndarray):
    """Translational global-motion estimation from the dense HME field
    (the global_me.c:139 role; FAST-corners + RANSAC collapses to a
    median-consensus fit for the TRANSLATION model): median candidate,
    inlier check, mean-of-inliers refinement.  Returns (row, col) in
    1/8-pel (quarter-pel precision) or None (identity)."""
    my = mv_y.astype(np.float64).reshape(-1)
    mx = mv_x.astype(np.float64).reshape(-1)
    med_y, med_x = float(np.median(my)), float(np.median(mx))
    if abs(med_y) < 1 and abs(med_x) < 1:
        return None
    inl = (np.abs(my - med_y) <= 1.5) & (np.abs(mx - med_x) <= 1.5)
    if inl.mean() < 0.4:
        return None
    r = int(np.clip(round(float(np.mean(my[inl]))) * 8, -504, 504))
    c = int(np.clip(round(float(np.mean(mx[inl]))) * 8, -504, 504))
    r &= ~1
    c &= ~1
    if r == 0 and c == 0:
        return None
    return (r, c)


def estimate_global_rotzoom(mv_y: np.ndarray, mv_x: np.ndarray):
    """ROTZOOM fit from the dense HME field (compute_global_motion /
    ransac.c RotZoom role): least-squares on [a, b, tx, ty] with a
    trimmed refit, quantized to the header's coded precision grid.
    Returns a 6-entry wmmat or None when translation explains the field
    as well (the caller then tries the translation estimator)."""
    gh, gw = mv_y.shape
    ys = (np.arange(gh) * BLK + BLK // 2).astype(np.float64)
    xs = (np.arange(gw) * BLK + BLK // 2).astype(np.float64)
    px = np.tile(xs, gh)
    py = np.repeat(ys, gw)
    dx = mv_x.astype(np.float64).reshape(-1)
    dy = mv_y.astype(np.float64).reshape(-1)

    def fit(sel):
        # dx = a*x + b*y + tx ; dy = -b*x + a*y + ty
        x, y = px[sel], py[sel]
        u, v = dx[sel], dy[sel]
        n = sel.sum()
        A = np.zeros((2 * n, 4))
        A[:n, 0] = x
        A[:n, 1] = y
        A[:n, 2] = 1.0
        A[n:, 0] = y
        A[n:, 1] = -x
        A[n:, 3] = 1.0
        rhs = np.concatenate([u, v])
        sol, *_ = np.linalg.lstsq(A, rhs, rcond=None)
        resid = A @ sol - rhs
        return sol, np.hypot(resid[:n], resid[n:])

    sel = np.ones(len(px), bool)
    if sel.sum() < 8:
        return None
    sol, r = fit(sel)
    keep = r <= max(1.5, np.median(r) * 2.0)
    if keep.sum() >= 8:
        sol, r = fit(keep)
    a, b_, tx, ty = sol
    # meaningful zoom/rotation? (pure translation -> a, b ~ 0)
    span = max(gh, gw) * BLK
    if abs(a) * span < 0.7 and abs(b_) * span < 0.7:
        return None
    # quantize to the coded grids: alphas multiples of 2 within
    # 2^16 +- 2^13, translation multiples of 2^10
    mat2 = int(np.clip(round((1.0 + a) * 65536 / 2) * 2,
                       65536 - 8190, 65536 + 8190))
    mat3 = int(np.clip(round(b_ * 65536 / 2) * 2, -8190, 8190))
    mat0 = int(np.clip(round(tx * 65536 / 1024) * 1024,
                       -(4095 << 10), 4095 << 10))
    mat1 = int(np.clip(round(ty * 65536 / 1024) * 1024,
                       -(4095 << 10), 4095 << 10))
    mat = (mat0, mat1, mat2, mat3, -mat3, mat2)
    if warp_ops.shear_params(mat) is None:
        return None
    if mat2 == 65536 and mat3 == 0:
        return None
    return mat


def _blocks(plane, ys, xs, n):
    """(B, n, n) blocks of an (H, W) plane at per-block offsets."""
    ar = torch.arange(n, device=plane.device)
    return plane[(ys[:, None, None] + ar[:, None]).long(),
                 (xs[:, None, None] + ar).long()]


def _luma_rd(src_y, pred, ys, xs, qp, rt):
    """The 16x16 DCT_DCT RD terms of pass A and of the compound probe:
    fwd_txfm2d + quantize (no Pallas kernel in the reference here), the
    transform-domain distortion and the coefficient bits, in float32.
    Returns (distortion, bits, qcoeff, dqcoeff); the callers add the MV
    bits and lambda in the reference's order of float32 operations."""
    coeffs = tf.fwd_txfm2d(_blocks(src_y, ys, xs, BLK) - pred, cc.DCT_DCT,
                           cc.TX_16X16)
    qc, dq = quant.quantize(coeffs, qp, cc.TX_16X16)
    s2 = float(np.float32(tf.coeff_sse_scale(cc.TX_16X16, cc.DCT_DCT)))
    err = coeffs.to(torch.float32) - dq.to(torch.float32)
    dist = s2 * (err * err).sum(dim=(1, 2))
    bits = ie._txb_bits(qc.abs(), rt[0], rt[2][0], rt[5],
                        ie._scan_pos_on(cc.TX_16X16, src_y.device))
    return dist, bits, qc, dq


def _chroma_rd(src_c, pred_c, ys, xs, qp, bd):
    """Chroma at the chosen prediction: 8x8 DCT_DCT levels and recon."""
    coeffs = tf.fwd_txfm2d(_blocks(src_c, ys, xs, CBLK) - pred_c,
                           cc.DCT_DCT, cc.TX_8X8)
    qc, dq = quant.quantize(coeffs, qp, cc.TX_8X8)
    return qc, tf.inv_txfm2d_add(dq, pred_c, cc.DCT_DCT, cc.TX_8X8, bd=bd)


def _pass_a(src, refp, wref, ys, xs, cand, qp, lam, rt, bd, warp0, interp):
    """_pass_a_fn: every block's K candidates against one reference in one
    batch (MC, forward transform, quantize, RD), the cheapest kept (first
    minimum), its normative recon, and chroma at its MV.  warp0: candidate
    0 is the GLOBAL warped prediction, sliced from the whole-frame warped
    reference ``wref`` (its MV is signaling-only).  Returns (cost, mv, qy,
    rec_y, qu, rec_u, qv, rec_v, is_warp) per block."""
    src_y, src_u, src_v = src
    nb, k = cand.shape[:2]
    ysK, xsK = ys.repeat(k), xs.repeat(k)
    mvsK = cand.permute(1, 0, 2).reshape(nb * k, 2)
    pred = mc.mc_blocks(refp[0], ysK, xsK, mvsK, BLK, mc.PAD, 0, bd,
                        kind=interp)
    if warp0:
        pred = torch.cat([_blocks(wref[0], ys, xs, BLK), pred[nb:]])
    dist, bits, qc, dq = _luma_rd(src_y, pred, ysK, xsK, qp, rt)
    cost = dist + lam * (bits + _mv_bits(mvsK))
    kbest = cost.reshape(k, nb).argmin(dim=0)
    ar = torch.arange(nb, device=ys.device)
    pick = lambda a: a.reshape((k, nb) + a.shape[1:])[kbest, ar]
    best_pred = pick(pred)
    best_mv = pick(mvsK)
    out = [pick(cost), best_mv, pick(qc),
           tf.inv_txfm2d_add(pick(dq), best_pred, cc.DCT_DCT, cc.TX_16X16,
                             bd=bd)]
    is_warp = (kbest == 0) if warp0 else torch.zeros(nb, dtype=torch.bool,
                                                     device=ys.device)
    cys, cxs = ys // 2, xs // 2
    wref = wref or (None,) * 3
    for refp_c, wref_c, src_c in ((refp[1], wref[1], src_u),
                                  (refp[2], wref[2], src_v)):
        pred_c = mc.mc_blocks(refp_c, cys, cxs, best_mv, CBLK, mc.PAD, 1, bd,
                              kind=interp)
        if warp0:
            pred_c = torch.where(is_warp[:, None, None],
                                 _blocks(wref_c, cys, cxs, CBLK), pred_c)
        out += list(_chroma_rd(src_c, pred_c, cys, cxs, qp, bd))
    return out + [is_warp]


def _pass_comp(src, p0, p1, ys, xs, mv0, mv1, qp, lam, rt, bd, interp):
    """_pass_comp_fn: the COMPOUND_AVERAGE candidate, one (mv0, mv1) pair
    per block against the (LAST, ALTREF) pair.  Returns (cost, qy, rec_y,
    qu, rec_u, qv, rec_v)."""
    src_y, src_u, src_v = src
    pred = mc.mc_blocks_compound(p0[0], p1[0], ys, xs, mv0, mv1, BLK,
                                 mc.PAD, 0, bd, kind=interp)
    dist, bits, qc, dq = _luma_rd(src_y, pred, ys, xs, qp, rt)
    cost = dist + lam * (bits + _mv_bits(mv0) + _mv_bits(mv1) + 2.0)
    out = [cost, qc, tf.inv_txfm2d_add(dq, pred, cc.DCT_DCT, cc.TX_16X16,
                                       bd=bd)]
    cys, cxs = ys // 2, xs // 2
    for i, src_c in ((1, src_u), (2, src_v)):
        pred_c = mc.mc_blocks_compound(p0[i], p1[i], cys, cxs, mv0, mv1,
                                       CBLK, mc.PAD, 1, bd, kind=interp)
        out += list(_chroma_rd(src_c, pred_c, cys, cxs, qp, bd))
    return out


def _merge(take, new, old):
    """Per block, the entries of ``new`` where ``take`` (B,) holds, else
    those of ``old`` (sequences of tensors with a leading block axis)."""
    return [torch.where(take.reshape(take.shape + (1,) * (o.dim() - 1)),
                        n, o) for n, o in zip(new, old)]


def _hme_mvs(mv_y, mv_x):
    """(nb, 2) 1/8-pel MVs of an HME field."""
    return np.stack([mv_y.reshape(-1) * 8, mv_x.reshape(-1) * 8],
                    axis=-1).astype(np.int32)


def choose_interp_filter(src_y, refp_y, ys, xs, hme, bd=8):
    """Frame-level interpolation-filter decision (the reference's
    interp-filter search, collapsed to one signaled frame filter): probe
    each filter set's MC SSE at a quarter-pel offset of the HME field and
    keep the best of REGULAR/SMOOTH/SHARP (first on equal SSE).
    src_y: (h, w) int32 tensor; refp_y: the reference padded by mc.PAD;
    ys/xs: (nb,) int32 numpy block offsets; hme: (nb, 2) numpy MVs.  The
    SSEs are exact int64 sums (the reference sums in float32)."""
    h, w = src_y.shape
    dev = src_y.device
    mvs = mc.clamp_mvs_for_pad(hme + 2, ys, xs, BLK, h, w)
    ys_t, xs_t = (torch.as_tensor(a, device=dev) for a in (ys, xs))
    mvs_t = torch.as_tensor(mvs, device=dev)
    srcb = _blocks(src_y, ys_t, xs_t, BLK)
    sses = []
    for kind in (0, 1, 2):
        pred = mc.mc_blocks(refp_y, ys_t, xs_t, mvs_t, BLK, mc.PAD, 0, bd,
                            kind=kind)
        d = (srcb - pred).to(torch.int64)
        sses.append((d * d).sum())
    return int(torch.stack(sses).argmin())


def _ref_planes(ref, dev):
    """A reference's planes (numpy or tensors) as int32 on ``dev``, and
    padded by mc.PAD (chroma by mc.PAD // 2)."""
    planes = [me_pipe.as_plane(ref[p], dev) for p in ("y", "u", "v")]
    return planes, (mc.pad_plane(planes[0], mc.PAD),
                    mc.pad_plane(planes[1], mc.PAD // 2),
                    mc.pad_plane(planes[2], mc.PAD // 2))


def _pass_a_for_ref(planes, refp, hme, src, ys, xs, qp, lam, rt, bd, ring,
                    interp):
    """HME field -> the global-motion model -> pass A against one
    reference.  Candidate 0 is the global-motion prediction: the per-block
    gm vector (translation), or the whole-frame warped reference (ROTZOOM)
    — so a GLOBALMV winner costs no explicit MV signaling.  Then the HME
    winner and its quarter-pel ring, clamped to the padded reference; a
    ring candidate that collides with a block's gm vector under ROTZOOM
    is nudged off it.  Returns (pass A's outputs, gm model or None)."""
    mv_y, mv_x = hme
    h, w = src[0].shape
    gw = w // BLK
    nb = ys.shape[0]
    gm = estimate_global_rotzoom(mv_y, mv_x)
    if gm is None:
        gm = estimate_global_translation(mv_y, mv_x)
    warp0 = gm is not None and len(gm) == 6
    hme_mv = _hme_mvs(mv_y, mv_x)
    cand = np.zeros((nb, 1 + len(ring), 2), np.int32)
    if warp0:
        for bid in range(nb):
            cand[bid, 0] = mv_pred.gm_block_mv(gm, (bid // gw) * 4,
                                               (bid % gw) * 4,
                                               cc.BLOCK_16X16)
    elif gm is not None:
        cand[:, 0] = np.array(gm, np.int32)
    cand[:, 1:] = hme_mv[:, None, :] + ring[None, :, :]
    gm_cand0 = cand[:, 0].copy()
    cand = mc.clamp_mvs_for_pad(cand, ys[:, None], xs[:, None], BLK, h, w)
    wref = None
    if warp0:
        # candidate 0's MV is signaling-only (the prediction is the warped
        # slice): keep the exact block-center projection or the decoder's
        # MV-prediction context diverges
        cand[:, 0] = gm_cand0
        # a ring candidate colliding with the block's gm vector would make
        # the syntax map a translational winner to GLOBALMV (and the
        # decoder would warp it): nudge collisions off the vector
        coll = np.all(cand[:, 1:] == cand[:, :1], axis=2)
        cand[:, 1:, 1] += coll.astype(np.int32) * 2
        wref = (warp_ops.warp_plane(planes[0], gm, w, h, bd=bd),
                warp_ops.warp_plane(planes[1], gm, w // 2, h // 2, bd=bd,
                                    subsampling=1),
                warp_ops.warp_plane(planes[2], gm, w // 2, h // 2, bd=bd,
                                    subsampling=1))
    dev = src[0].device
    t = lambda a: torch.as_tensor(a, device=dev)
    out = _pass_a(src, refp, wref, t(ys), t(xs), t(cand), qp, lam, rt, bd,
                  warp0, interp)
    return out, gm


def _pass_b(src, icost, irec, qp, lam, rt, modes, bd):
    """_inter_frame_program_fn: the intra wave loop of one frame with the
    per-block inter winner (cost, recon) as an override, taken where it
    beats the best intra candidate; its chroma recon follows the luma
    choice.  Returns the recon planes (int32, (1, H, W)) and, in raster
    block order, the luma / chroma modes, the inter choice and the
    levels."""
    sy, su, sv = (p[None] for p in src)
    _, h, w = sy.shape
    gh, gw = h // BLK, w // BLK
    dev = sy.device
    nb = gh * gw
    recon_y = torch.zeros((1, h, w), dtype=torch.int32, device=dev)
    recon_u = torch.zeros((1, h // 2, w // 2), dtype=torch.int32, device=dev)
    recon_v = torch.zeros_like(recon_u)
    ym = torch.zeros(nb, dtype=torch.int32, device=dev)
    um = torch.zeros_like(ym)
    choose_all = torch.zeros(nb, dtype=torch.bool, device=dev)
    qy = torch.zeros((nb, BLK, BLK), dtype=torch.int32, device=dev)
    qu = torch.zeros((nb, CBLK, CBLK), dtype=torch.int32, device=dev)
    qv = torch.zeros_like(qu)
    cy_t, cuv_t, txbb, modeb, uvb, eoby, eobuv = rt[:7]
    for ws in ie._device_schedule(gh, gw, 1, dev):
        m, q, _, choose = ie._rd_step(
            recon_y, sy, ws.fi, ws.by * BLK, ws.bx * BLK, ws.sel, ws.ha,
            ws.hl, qp, lam, modes, (cy_t, txbb, modeb, eoby), bd=bd,
            tr_avail=ws.tr, bl_avail=ws.bl,
            inter=(icost[ws.bid], irec[0][ws.bid]))
        um_w, q_u, q_v, _, _ = ie._rd_step_chroma(
            recon_u, recon_v, su, sv, ws.fi, ws.by * CBLK, ws.bx * CBLK,
            ws.sel, ws.ha, ws.hl, qp, lam, (cuv_t, txbb, uvb, eobuv), bd=bd,
            inter=(choose, irec[1][ws.bid], irec[2][ws.bid]))
        ym[ws.rid] = m[ws.sel]
        um[ws.rid] = um_w[ws.sel]
        choose_all[ws.rid] = choose[ws.sel]
        qy[ws.rid] = q[ws.sel]
        qu[ws.rid] = q_u[ws.sel]
        qv[ws.rid] = q_v[ws.sel]
    return (recon_y, recon_u, recon_v), (ym, um, choose_all, qy, qu, qv)


def encode_inter_frame(src_y: np.ndarray, src_u: np.ndarray,
                       src_v: np.ndarray, ref, qindex: int, modes=ie.ALL_MODES,
                       bd: int = 8, hme_rad2: int = 8, hme_rad0: int = 7,
                       subpel_ring: bool = True, compound: bool = True,
                       exact_rates: bool = False, device=None):
    """Encode one inter frame on ``device`` (default: the current CUDA
    device).

    ref: a single plane dict (LAST only, IPPP) or {ref_enum: plane dict}
    for multi-reference MD: every block evaluates its candidates against
    each reference, the references merge by RD cost, and with LAST and
    ALTREF the COMPOUND_AVERAGE probe competes; the winner's reference is
    signaled per block.  Planes are numpy arrays or tensors (uint8, or
    uint16 / int16 at 10 bits).  With ``subpel_ring`` the frame's
    interpolation filter is picked on the first reference's HME field.
    Returns ({(r4, c4): BlockDecision}, recon dict(y, u, v) of
    pixel_dtype(bd) tensors on ``device``, {ref_enum: gm model}, the
    interpolation filter)."""
    dev = device_mod.resolve(device)
    if "y" in ref:
        refs = {mv_pred.LAST_FRAME: ref}
    else:
        refs = {r: p for r, p in ref.items() if p is not None}
    h, w = src_y.shape
    assert h % BLK == 0 and w % BLK == 0
    ie._check_slice(modes, bd, h, w)
    gh, gw = h // BLK, w // BLK
    nb = gh * gw
    ys = (np.arange(nb) // gw * BLK).astype(np.int32)
    xs = (np.arange(nb) % gw * BLK).astype(np.int32)
    qp = quant.params_on(int(qindex), dev, bd)
    lam = torch.tensor(ie.frame_lambda(qindex, bd), dtype=torch.float32,
                       device=dev)
    src = tuple(me_pipe.as_plane(p, dev) for p in (src_y, src_u, src_v))
    ring = _SUBPEL_RING if subpel_ring else _SUBPEL_RING[:1]
    rt_a = md_rate_args(qindex, (), (), exact=exact_rates, device=dev)

    order = sorted(refs)
    planes, pads, hmes = {}, {}, {}
    for e in order:
        planes[e], pads[e] = _ref_planes(refs[e], dev)
        hmes[e] = me_pipe.hierarchical_me(src[0], planes[e][0],
                                          rad2=hme_rad2, rad0=hme_rad0,
                                          device=dev)[:2]
    # the frame-level interpolation filter (quality presets), probed on
    # the first reference's HME field
    interp = 0
    if subpel_ring:
        interp = choose_interp_filter(src[0], pads[order[0]][0], ys, xs,
                                      _hme_mvs(*hmes[order[0]]), bd=bd)

    # pass A against each reference; elementwise merge by RD cost
    best = iref = None
    gm_by_ref = {}
    for e in order:
        out, gm = _pass_a_for_ref(planes[e], pads[e], hmes[e], src, ys, xs,
                                  qp, lam, rt_a, bd, ring, interp)
        if gm is not None:
            gm_by_ref[e] = gm
        if best is None:
            best = out
            iref = torch.full((nb,), e, dtype=torch.int32, device=dev)
        else:
            take = out[0] < best[0]
            iref = torch.where(take, e, iref)
            best = _merge(take, out, best)
    icost, imv, iqy, irec_y, iqu, irec_u, iqv, irec_v, iwarp = best

    # COMPOUND_AVERAGE probe (LAST + ALTREF pair, B frames only): the
    # per-reference HME winners predict jointly, then the zero pair; RD
    # competes with the merged single-reference winner
    icomp = torch.zeros(nb, dtype=torch.bool, device=dev)
    imv2 = torch.zeros((nb, 2), dtype=torch.int32, device=dev)
    last, alt = mv_pred.LAST_FRAME, mv_pred.ALTREF_FRAME
    if compound and last in refs and alt in refs:
        t = lambda a: torch.as_tensor(a, device=dev)
        mv0 = t(mc.clamp_mvs_for_pad(_hme_mvs(*hmes[last]), ys, xs, BLK, h,
                                     w))
        mv1 = t(mc.clamp_mvs_for_pad(_hme_mvs(*hmes[alt]), ys, xs, BLK, h,
                                     w))
        zero = torch.zeros_like(mv0)
        merged = None
        for m0, m1 in ((mv0, mv1), (zero, zero)):
            outc = _pass_comp(src, pads[last], pads[alt], t(ys), t(xs), m0,
                              m1, qp, lam, rt_a, bd, interp) + [m0, m1]
            merged = (outc if merged is None
                      else _merge(outc[0] < merged[0], outc, merged))
        ccost, cqy, crec_y, cqu, crec_u, cqv, crec_v, cmv0, cmv1 = merged
        icomp = ccost < icost
        (icost, imv, imv2, iqy, irec_y, iqu, irec_u, iqv, irec_v) = _merge(
            icomp, (ccost, cmv0, cmv1, cqy, crec_y, cqu, crec_u, cqv, crec_v),
            (icost, imv, imv2, iqy, irec_y, iqu, irec_u, iqv, irec_v))
        iref = torch.where(icomp, last, iref)
        iwarp = torch.where(icomp, False, iwarp)

    rt_b = ie._rate_args(int(qindex), tuple(modes), bool(exact_rates), dev)
    recon, (ym, um, choose, qy, qu, qv) = _pass_b(
        src, icost, (irec_y, irec_u, irec_v), qp, lam, rt_b, tuple(modes),
        bd)
    # the decisions to the host
    host = [a.cpu().numpy() for a in (ym, um, choose, qy, qu, qv, iqy, iqu,
                                      iqv, imv, iref, iwarp, icomp, imv2)]
    (ym, um, choose, qy, qu, qv, iqy, iqu, iqv, imv, iref, iwarp, icomp,
     imv2) = host
    decisions = {}
    for wave in ie._wave_schedule(gh, gw, ie._natural_maxb(gh, gw)):
        for by, bx in wave:
            r4, c4 = by * 4, bx * 4
            bid = by * gw + bx
            if choose[bid]:
                decisions[(r4, c4)] = BlockDecision(
                    r4=r4, c4=c4, bsize=cc.BLOCK_16X16, y_mode=cc.DC_PRED,
                    uv_mode=cc.DC_PRED, tx_type=cc.DCT_DCT,
                    qcoeff_y=iqy[bid], qcoeff_u=iqu[bid],
                    qcoeff_v=iqv[bid], is_inter=True,
                    mv=(int(imv[bid, 0]), int(imv[bid, 1])),
                    ref=int(iref[bid]), use_warp=bool(iwarp[bid]),
                    ref2=(int(alt) if icomp[bid] else 0),
                    mv2=((int(imv2[bid, 0]), int(imv2[bid, 1]))
                         if icomp[bid] else (0, 0)))
            else:
                decisions[(r4, c4)] = BlockDecision(
                    r4=r4, c4=c4, bsize=cc.BLOCK_16X16,
                    y_mode=int(ym[bid]), uv_mode=int(um[bid]),
                    tx_type=cc.DCT_DCT, qcoeff_y=qy[bid],
                    qcoeff_u=qu[bid], qcoeff_v=qv[bid])
    pdt = ie.pixel_dtype(bd)
    rec = {p: r[0].to(pdt) for p, r in zip(("y", "u", "v"), recon)}
    return decisions, rec, gm_by_ref, interp
