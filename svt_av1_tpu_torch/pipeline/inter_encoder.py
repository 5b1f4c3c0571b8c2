"""Inter frames, decoder side: reconstruction from parsed decisions, the
PyTorch port of the decoder half of svt_av1_tpu/pipeline/inter_encoder.py
(``reconstruct_inter_from_decisions`` and its helpers), plus the two
pieces of its encoder half that the fast GOP path uses (the subpel ring
and the MV rate estimate).

The reference's stage-path encoder (``encode_inter_frame``, ``_pass_a_fn``
and the rest) is not ported: the port runs inter frames through its fast
path (pipeline/gop_fast.py).

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
from svt_av1_tpu_torch.codec.syntax import _chroma_tx_type_inter
from svt_av1_tpu_torch.ops import mc, quant, transforms as tf
from svt_av1_tpu_torch.ops import obmc as obmc_ops
from svt_av1_tpu_torch.ops import warp as warp_ops
from svt_av1_tpu_torch.ops import wedge as wedge_ops

BLK = 16
CBLK = 8

# candidate MV offsets around the HME winner (1/8 pel): the fullpel
# winner plus its quarter-pel ring
_SUBPEL_RING = np.array(
    [(0, 0), (0, 2), (0, -2), (2, 0), (-2, 0),
     (2, 2), (2, -2), (-2, 2), (-2, -2)], np.int32)


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
