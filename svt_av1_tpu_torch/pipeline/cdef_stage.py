"""CDEF frame stage: strength search (encoder) + normative apply, the
PyTorch port of svt_av1_tpu/pipeline/cdef_stage.py.

Behavioral reference: cdef_process.c svt_av1_cdef_frame / cdef_seg_search
and cdef.c svt_cdef_filter_fb.  The whole frame filters as ONE batch of
8x8 (luma) / 4x4 (chroma) blocks (ops/cdef.py) on the recon's device.

Signaling: ``cdef_search`` picks one frame-uniform strength set
(cdef_bits = 0); ``cdef_search_sb`` (presets M0-M4) prices every
candidate per 64x64 superblock and picks cdef_bits (0..3), a subset of
2^cdef_bits sets and each superblock's index (its host subset selection,
``select_sb_sets``, also serves gop_fast.run_key_filters).  Skip rule
(enc_cdef.c:267): an 8x8 block filters iff ANY of its four 4x4 MIs is
non-skip; damping = 3 + (base_q_idx >> 6), chroma damping one less
(cdef.c:filter_fb).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from svt_av1_tpu_torch.ops import cdef as cdef_ops
from svt_av1_tpu_torch.ops import quant
from svt_av1_tpu_torch.pipeline.dlf_stage import _sse

# encoder search candidates: (pri_y, sec_y, pri_uv, sec_uv), header
# domain (sec coded 0..3; coded 3 applies as 4)
SEARCH_SET = ((0, 0, 0, 0), (1, 0, 1, 0), (2, 1, 2, 1), (4, 1, 4, 1),
              (4, 2, 4, 2), (6, 2, 6, 2), (8, 2, 8, 2), (12, 3, 10, 3))


def _adjust_strength(strength, var):
    """adjust_strength (cdef.c:130), vectorized: luma primary strength
    scaled by the 8x8 directional variance."""
    v6 = var >> 6
    i = torch.clamp(cdef_ops._msb(torch.clamp(v6, min=1)), max=12)
    i = torch.where(v6 > 0, i, 0)
    adj = (strength * (4 + i) + 8) >> 4
    return torch.where(var > 0, adj, 0)


def _pad_vl(plane, n=2):
    """Pad with CDEF_VERY_LARGE (== spec unavailable samples)."""
    return torch.nn.functional.pad(plane, (n, n, n, n),
                                   value=cdef_ops.CDEF_VERY_LARGE)


def _windows(padded, ys, xs, n, sid=None):
    """(B, n+4, n+4) windows of a padded plane; with ``sid``, of (S, ...)
    planes, window b from plane sid[b]."""
    offs = torch.arange(n + 4, device=padded.device)
    rows = ys[:, None, None] + offs[None, :, None]
    cols = xs[:, None, None] + offs[None, None, :]
    if sid is not None:
        return padded[sid[:, None, None], rows, cols]
    return padded[rows, cols]


def _apply(rec_y, rec_u, rec_v, skip8, pri_y, sec_y, pri_uv, sec_uv,
           damping: int, bd: int):
    """The apply program (the reference's ``_jit_apply``) on int32 planes.

    skip8: (H/8, W/8) bool; pri_y/sec_y/pri_uv/sec_uv: per-8x8-block (nb,)
    int32 strength tensors.  Returns new (y, u, v) int32 planes."""
    h, w = rec_y.shape
    gw8 = w // 8
    nb = (h // 8) * gw8
    cs = bd - 8
    dev = rec_y.device
    ar = torch.arange(nb, device=dev)
    ys = (ar // gw8 * 8).to(torch.int32)
    xs = (ar % gw8 * 8).to(torch.int32)
    r8 = torch.arange(8, device=dev)
    rows = ys[:, None, None] + r8[None, :, None]
    cols = xs[:, None, None] + r8[None, None, :]
    blocks = rec_y[rows, cols]
    dirs, var = cdef_ops.cdef_find_dir(blocks, cs)
    pri = _adjust_strength(pri_y << cs, var)
    sec = sec_y << cs
    wins = _windows(_pad_vl(rec_y), ys, xs, 8)
    fy = cdef_ops.cdef_filter_block(wins, pri, sec, dirs, damping + cs,
                                    damping + cs, cs, bd, n=8)
    keep = skip8.reshape(nb)[:, None, None]
    fy = torch.where(keep, blocks, fy)
    out_y = rec_y.clone()
    out_y[rows, cols] = fy
    # chroma 4:2:0: 4x4 blocks at the same grid, luma directions,
    # unadjusted strengths, damping - 1
    cys, cxs = ys // 2, xs // 2
    r4 = r8[:4]
    crows = cys[:, None, None] + r4[None, :, None]
    ccols = cxs[:, None, None] + r4[None, None, :]
    pri_c = pri_uv << cs
    sec_c = sec_uv << cs
    outs = []
    for rc in (rec_u, rec_v):
        cwins = _windows(_pad_vl(rc), cys, cxs, 4)
        fc = cdef_ops.cdef_filter_block(cwins, pri_c, sec_c, dirs,
                                        damping - 1 + cs, damping - 1 + cs,
                                        cs, bd, n=4)
        fc = torch.where(keep, rc[crows, ccols], fc)
        oc = rc.clone()
        oc[crows, ccols] = fc
        outs.append(oc)
    return out_y, outs[0], outs[1]


def cdef_damping(base_q_idx: int) -> int:
    return 3 + (base_q_idx >> 6)


def _block_strengths(h, w, strengths, sb_idx=None):
    """Per-8x8-block (nb,) int32 strength arrays (pri_y, sec_y, pri_uv,
    sec_uv) from header-domain strength set(s); a coded secondary
    strength 3 applies as 4.  sb_idx: None for one frame-uniform set, or
    the per-64x64 index map into the sequence ``strengths``; an SB with
    no coded cdef_idx (-1) filters with strength 0."""
    gh8, gw8 = h // 8, w // 8
    if sb_idx is None:
        per = np.broadcast_to(np.asarray(strengths, np.int32),
                              (gh8 * gw8, 4))
    else:
        sets = np.concatenate([np.asarray(strengths, np.int32)
                               .reshape(-1, 4),
                               np.zeros((1, 4), np.int32)])  # -1 -> 0
        idx8 = np.asarray(sb_idx, np.int32)[
            (np.arange(gh8) // 8)[:, None], (np.arange(gw8) // 8)[None]]
        per = sets[idx8.reshape(-1)]
    pri_y, sec_y, pri_uv, sec_uv = (per[:, i] for i in range(4))
    return (pri_y, sec_y + (sec_y == 3), pri_uv, sec_uv + (sec_uv == 3))


def cdef_apply(recon: Dict[str, torch.Tensor], skip16: np.ndarray,
               strengths, damping: int, bd: int = 8, sb_idx=None,
               skip8=None) -> Dict[str, torch.Tensor]:
    """Normative CDEF apply over a post-deblock recon (dict of y/u/v
    tensors, on any device; the result keeps their device and dtype).

    damping: the SIGNALED cdef_damping (3..6) from the frame header.
    skip16: (gh, gw) bool per 16x16 block (the uniform leaf grid); an
    8x8 filters iff its covering block is non-skip (skip8, when given, is
    the per-8x8 map itself).  strengths: one header-domain 4-tuple
    (frame-uniform), or — with sb_idx, the per-64x64 index map (-1: no
    coded index, strength 0) — a sequence of 2^cdef_bits 4-tuples."""
    y0 = recon["y"]
    h, w = y0.shape
    dev = y0.device
    if skip8 is None:
        skip8 = np.repeat(np.repeat(skip16, 2, 0), 2, 1)
    per = [torch.as_tensor(np.ascontiguousarray(a), device=dev)
           for a in _block_strengths(h, w, strengths, sb_idx)]
    y, u, v = _apply(*(recon[p].to(torch.int32) for p in ("y", "u", "v")),
                     torch.as_tensor(np.asarray(skip8, bool), device=dev),
                     *per, damping, bd)
    out = dict(recon)
    out["y"] = y.to(y0.dtype)
    out["u"] = u.to(recon["u"].dtype)
    out["v"] = v.to(recon["v"].dtype)
    return out


def cdef_search(src: Dict[str, torch.Tensor],
                recon: Dict[str, torch.Tensor], skip16: np.ndarray,
                base_q_idx: int, bd: int = 8,
                max_candidates: int = len(SEARCH_SET)
                ) -> Tuple[int, int, int, int]:
    """Frame-uniform strength search: min SSE vs source over SEARCH_SET
    (the first candidate wins a tie).  The SSEs are summed in int64 on
    the recon's device and read back once.  Returns header-domain
    strengths (sec coded 0..3; 3 means 4)."""
    cands = SEARCH_SET[:max_candidates]
    damping = cdef_damping(base_q_idx)
    sses = []
    for cand in cands:
        filt = cdef_apply(recon, skip16, cand, damping, bd)
        sses.append(sum(_sse(filt[p], src[p]) for p in ("y", "u", "v")))
    return cands[int(torch.stack(sses).argmin())]


def coded_sb_map(skip16: np.ndarray) -> np.ndarray:
    """(sb_rows, sb_cols) bool: SBs that code a cdef_idx (>= 1 non-skip
    16x16 block)."""
    gr, gc = (skip16.shape[0] + 3) // 4, (skip16.shape[1] + 3) // 4
    pad = np.ones((gr * 4, gc * 4), bool)
    pad[:skip16.shape[0], :skip16.shape[1]] = skip16
    return ~pad.reshape(gr, 4, gc, 4).all(axis=(1, 3))


def select_sb_sets(sse: np.ndarray, coded: np.ndarray, lam: float,
                   cands, max_bits: int = 3):
    """finish_cdef_search analog: from the per-SB / per-candidate SSE
    matrix, pick cdef_bits (0..max_bits) and the strength subset that
    minimize SSE + lambda * signaling bits.  Returns (cdef_bits,
    strength_list, sb_idx_map)."""
    from itertools import combinations
    ncoded = int(coded.sum())
    best = None
    for bits in range(max_bits + 1):
        n_sets = 1 << bits
        if n_sets > len(cands):
            break
        for sub in combinations(range(len(cands)), n_sets):
            pick = sse[:, list(sub)]
            total = float(pick.min(axis=1).sum())
            cost = total + lam * (ncoded * bits + 12 * n_sets)
            if best is None or cost < best[0]:
                best = (cost, bits, sub, pick.argmin(axis=1).astype(np.int32))
    _, bits, sub, idx = best
    idx_map = np.where(coded, idx.reshape(coded.shape), -1).astype(np.int32)
    return bits, tuple(cands[i] for i in sub), idx_map


def _sb_sse(src: Dict[str, torch.Tensor], filt: Dict[str, torch.Tensor]
            ) -> torch.Tensor:
    """Per-64x64-SB SSE (y + u + v), (sb_rows, sb_cols) int64 on the
    planes' device (exact; the reference sums the same integers in
    float64)."""
    h, w = src["y"].shape
    gr, gc = (h + 63) // 64, (w + 63) // 64
    out = None
    for p, step in (("y", 64), ("u", 32), ("v", 32)):
        d = filt[p].to(torch.int64) - src[p].to(torch.int64)
        d = d * d
        ph, pw = d.shape
        d = torch.nn.functional.pad(d, (0, gc * step - pw, 0, gr * step - ph))
        sb = d.reshape(gr, step, gc, step).sum(dim=(1, 3))
        out = sb if out is None else out + sb
    return out


def cdef_search_sb(src: Dict[str, torch.Tensor],
                   recon: Dict[str, torch.Tensor], skip16: np.ndarray,
                   base_q_idx: int, bd: int = 8,
                   max_candidates: int = len(SEARCH_SET)):
    """Per-SB strength search (cdef_seg_search + finish_cdef_search
    analog): every candidate's per-SB SSE on the device, read back once,
    then the host picks cdef_bits (0..3) and the strength subset that
    minimize SSE + lambda * signaling bits.  Returns (cdef_bits,
    strength_list, sb_idx_map)."""
    cands = SEARCH_SET[:max_candidates]
    damping = cdef_damping(base_q_idx)
    sse = torch.stack([
        _sb_sse(src, cdef_apply(recon, skip16, cand, damping, bd))
        .reshape(-1) for cand in cands], dim=1)          # (nsb, ncand)
    coded = coded_sb_map(skip16)
    qstep = quant.dc_q(base_q_idx, bd=bd) / 8.0
    lam = 0.7 * qstep * qstep
    return select_sb_sets(sse.cpu().numpy().astype(np.float64), coded, lam,
                          cands)
