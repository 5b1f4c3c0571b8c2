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

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from av1ref import device as device_mod
from av1ref.codec import constants as cc
from av1ref.codec.syntax import MAX_TX, _chroma_tx_type, _chroma_tx_type_inter, max_chroma_tx_size
from av1ref.ops import dlf, intra, quant
from av1ref.ops import interintra as ii_ops
from av1ref.ops import transforms as tf

BLK = 16
CBLK = 8


def pixel_dtype(bd: int) -> torch.dtype:
    """The dtype of recon planes on the device: uint8 at 8 bits, int16 at
    10 (samples up to 1023; torch's uint16 has few kernels).  The host
    copies of 10-bit planes are uint16, as the reference's are."""
    return torch.uint8 if bd == 8 else torch.int16


def host_plane(t: torch.Tensor) -> np.ndarray:
    """A recon plane copied to the host: uint8 at 8 bits, uint16 at 10."""
    a = t.cpu().numpy()
    return a if a.dtype == np.uint8 else a.astype(np.uint16)


def cand_angle(mode: int, delta: int) -> int:
    """Prediction angle of a candidate (0 = non-directional)."""
    if cc.V_PRED <= mode <= cc.D67_PRED:
        return intra.MODE_TO_ANGLE[mode] + 3 * delta
    return 0


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
