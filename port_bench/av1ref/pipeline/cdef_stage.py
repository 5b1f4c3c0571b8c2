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

from typing import Dict

import numpy as np
import torch

from av1ref.ops import cdef as cdef_ops


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


