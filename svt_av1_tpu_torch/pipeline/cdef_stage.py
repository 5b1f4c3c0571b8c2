"""CDEF frame stage: frame-uniform strength search (encoder) + normative
apply, the PyTorch port of svt_av1_tpu/pipeline/cdef_stage.py.

Behavioral reference: cdef_process.c svt_av1_cdef_frame / cdef_seg_search
and cdef.c svt_cdef_filter_fb.  The whole frame filters as ONE batch of
8x8 (luma) / 4x4 (chroma) blocks (ops/cdef.py) on the recon's device.

Signaling: cdef_bits = 0 (one frame-uniform strength set per plane, no
per-SB index bits).  Skip rule (enc_cdef.c:267): an 8x8 block filters iff
ANY of its four 4x4 MIs is non-skip; damping = 3 + (base_q_idx >> 6),
chroma damping one less (cdef.c:filter_fb).  The per-SB search
(``cdef_search_sb``, cdef_bits > 0) serves presets M0-M4 and comes with
them; its host subset selection (``coded_sb_map``, ``select_sb_sets``)
also picks the GOP key frames' frame-uniform set (gop_fast.run_key_filters).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from svt_av1_tpu_torch.ops import cdef as cdef_ops
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


def _windows(padded, ys, xs, n):
    offs = torch.arange(n + 4, device=padded.device)
    rows = ys[:, None, None] + offs[None, :, None]
    cols = xs[:, None, None] + offs[None, None, :]
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


def _block_strengths(h, w, strengths):
    """Per-8x8-block (nb,) int32 strength arrays (pri_y, sec_y, pri_uv,
    sec_uv) from one header-domain strength set (frame-uniform; a coded
    secondary strength 3 applies as 4)."""
    nb = (h // 8) * (w // 8)
    per = np.broadcast_to(np.asarray(strengths, np.int32), (nb, 4))
    pri_y, sec_y, pri_uv, sec_uv = (per[:, i] for i in range(4))
    return (pri_y, sec_y + (sec_y == 3), pri_uv, sec_uv + (sec_uv == 3))


def cdef_apply(recon: Dict[str, torch.Tensor], skip16: np.ndarray,
               strengths, damping: int, bd: int = 8,
               skip8=None) -> Dict[str, torch.Tensor]:
    """Normative CDEF apply over a post-deblock recon (dict of y/u/v
    tensors, on any device; the result keeps their device and dtype).

    damping: the SIGNALED cdef_damping (3..6) from the frame header.
    skip16: (gh, gw) bool per 16x16 block (the uniform leaf grid); an
    8x8 filters iff its covering block is non-skip (skip8, when given, is
    the per-8x8 map itself).  strengths: one header-domain 4-tuple."""
    y0 = recon["y"]
    h, w = y0.shape
    dev = y0.device
    if skip8 is None:
        skip8 = np.repeat(np.repeat(skip16, 2, 0), 2, 1)
    per = [torch.as_tensor(np.ascontiguousarray(a), device=dev)
           for a in _block_strengths(h, w, strengths)]
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
