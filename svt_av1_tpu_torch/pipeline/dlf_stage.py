"""DLF stage: per-frame filter level search + apply, the PyTorch port of
svt_av1_tpu/pipeline/dlf_stage.py (uniform 16x16 grid).

Behavioral reference: dlf_process.c:106-131 (full-image distortion eval
per candidate level).  The reference bisects over levels per plane; here
each candidate is ONE whole-frame vectorized filter pass (ops/dlf.py),
so a small candidate ladder around the qindex heuristic is searched
exhaustively and each plane picks its min-SSE level independently
(Y, U, V levels are signaled separately in the frame header).  The SSEs
are summed in int64 on the recon's device and read back once per plane.

The mask-aware half (``maps_from_decisions``, ``flens_from_maps``,
``apply_masked``, ``search_and_apply_masked``) serves mixed block sizes:
the merged skip leaves of inter frames.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from svt_av1_tpu_torch.ops import dlf

BLK = 16
CBLK = 8


def default_filter_level(qindex: int) -> int:
    """qindex -> deblock level heuristic (search refines around it)."""
    return int(np.clip((qindex * 3) // 32, 0, 63)) >> 1


def _ladder(d: int) -> Tuple[int, ...]:
    cands = {0, d // 2, d, d + (d // 2) + 1, min(63, 2 * d + 1)}
    return tuple(sorted(cands))


def _sse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum of squared differences as an int64 tensor (exact)."""
    d = a.to(torch.int64) - b.to(torch.int64)
    return (d * d).sum()


def _search_plane(src: torch.Tensor, rec: torch.Tensor, step: int,
                  levels: Tuple[int, ...], sharpness: int, q_thresh: int,
                  bd: int):
    """Returns (best_level, best_filtered_plane_or_None): the unfiltered
    plane, then each nonzero level in ladder order; the first minimum
    wins."""
    x = rec.to(torch.int32)
    cands = [(0, None)]
    sses = [_sse(src, rec)]
    for lvl in levels:
        if lvl == 0:
            continue
        f = dlf.loop_filter_plane_uniform(x, step, lvl, sharpness,
                                          q_thresh, bd)
        cands.append((lvl, f))
        sses.append(_sse(src, f))
    return cands[int(torch.stack(sses).argmin())]


def search_and_apply(src: Dict[str, torch.Tensor],
                     recon: Dict[str, torch.Tensor], fp,
                     bd: int = 8) -> Dict[str, torch.Tensor]:
    """Search per-plane filter levels (min SSE vs source), record them in
    the frame header fields, and return the filtered recon (y/u/v tensors
    on the recon's device, in its dtype)."""
    qindex = fp.base_q_idx
    d = default_filter_level(qindex)
    out = dict(recon)

    ly, fy = _search_plane(src["y"], recon["y"], BLK, _ladder(d),
                           fp.sharpness, 14, bd)
    fp.filter_level = (ly, ly)
    if fy is not None:
        out["y"] = fy.to(recon["y"].dtype)

    if ly == 0:
        # chroma levels are only coded when a luma level is nonzero
        # (uncompressed-header syntax) — the decoder would read 0
        fp.filter_level_uv = (0, 0)
        return out
    duv = max(0, d - 2)
    luv_levels = _ladder(duv)
    lu, fu = _search_plane(src["u"], recon["u"], CBLK, luv_levels,
                           fp.sharpness, 6, bd)
    lv, fv = _search_plane(src["v"], recon["v"], CBLK, luv_levels,
                           fp.sharpness, 6, bd)
    fp.filter_level_uv = (lu, lv)
    if fu is not None:
        out["u"] = fu.to(recon["u"].dtype)
    if fv is not None:
        out["v"] = fv.to(recon["v"].dtype)
    return out


def maps_from_decisions(decisions, mi_rows: int, mi_cols: int):
    """Per-mi tx/block extent + skip maps of the mask-aware deblocker
    (set_lpf_parameters inputs, deblocking_filter.c:147-157), numpy.

    Luma maps on the 4-px mi grid, chroma maps on the 4-chroma-px grid.
    Tx extents come from the coded coefficient shapes; a skip inter
    block's tx extent is its block extent.  Returns dict(y=(txw, txh, bw,
    bh, skip), uv=(...))."""
    from svt_av1_tpu_torch.codec import constants as cc
    ly = [np.ones((mi_rows, mi_cols), np.int32) for _ in range(4)]
    lsk = np.zeros((mi_rows, mi_cols), bool)
    cr, cc_ = mi_rows // 2, mi_cols // 2
    luv = [np.ones((cr, cc_), np.int32) for _ in range(4)]
    csk = np.zeros((cr, cc_), bool)
    for (r4, c4), d in decisions.items():
        n4 = d.qcoeff_y.shape
        bw4 = int(cc.block_size_wide[d.bsize]) >> 2
        bh4 = int(cc.block_size_high[d.bsize]) >> 2
        skip = bool(d.skip) and bool(d.is_inter)
        sl = (slice(r4, r4 + bh4), slice(c4, c4 + bw4))
        ly[0][sl] = bw4 if skip else max(1, n4[1] // 4)
        ly[1][sl] = bh4 if skip else max(1, n4[0] // 4)
        ly[2][sl] = bw4
        ly[3][sl] = bh4
        lsk[sl] = skip
        cw4, ch4 = bw4 // 2, bh4 // 2
        slc = (slice(r4 // 2, r4 // 2 + ch4), slice(c4 // 2, c4 // 2 + cw4))
        if d.qcoeff_u is not None:
            ctw = cw4 if skip else max(1, d.qcoeff_u.shape[1] // 4)
            cth = ch4 if skip else max(1, d.qcoeff_u.shape[0] // 4)
        else:
            ctw, cth = cw4, ch4
        luv[0][slc] = ctw
        luv[1][slc] = cth
        luv[2][slc] = cw4
        luv[3][slc] = ch4
        csk[slc] = skip
    return dict(y=(ly[0], ly[1], ly[2], ly[3], lsk),
                uv=(luv[0], luv[1], luv[2], luv[3], csk))


def flens_from_maps(maps, device=None):
    """Vertical/horizontal per-mi filter-length maps of both plane groups
    (edge_flens over the direction's extents), int32 tensors on
    ``device`` (default: the CPU)."""
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
    txw, txh, bw, bh, sk = (t(a) for a in maps["y"])
    ctxw, ctxh, cbw, cbh, csk = (t(a) for a in maps["uv"])
    return dict(y_v=dlf.edge_flens(txw, bw, sk, True),
                y_h=dlf.edge_flens(txh.T, bh.T, sk.T, True).T,
                uv_v=dlf.edge_flens(ctxw, cbw, csk, False),
                uv_h=dlf.edge_flens(ctxh.T, cbh.T, csk.T, False).T)


def apply_masked(recon: Dict[str, torch.Tensor], fp, flens,
                 bd: int = 8) -> Dict[str, torch.Tensor]:
    """Mask-aware deblock of all planes at the header's levels (encoder
    and decoder share it); flens on the recon's device."""
    out = dict(recon)
    for p, lvl, keys in (("y", fp.filter_level[0], ("y_v", "y_h")),
                         ("u", fp.filter_level_uv[0], ("uv_v", "uv_h")),
                         ("v", fp.filter_level_uv[1], ("uv_v", "uv_h"))):
        if lvl > 0:
            out[p] = dlf.loop_filter_plane_masked(
                recon[p], flens[keys[0]], flens[keys[1]], lvl, fp.sharpness,
                p == "y", bd).to(recon[p].dtype)
    return out


def search_and_apply_masked(src: Dict[str, torch.Tensor],
                            recon: Dict[str, torch.Tensor], fp, flens,
                            bd: int = 8) -> Dict[str, torch.Tensor]:
    """Per-plane level search with the mask-aware filter (mixed-size
    frames; dlf_process.c:106-131 role); the first minimum wins."""
    d = default_filter_level(fp.base_q_idx)
    out = dict(recon)

    def search(plane, vk, hk, levels, is_luma):
        rec = recon[plane]
        cands = [(0, None)]
        sses = [_sse(src[plane], rec)]
        for lvl in levels:
            if lvl == 0:
                continue
            f = dlf.loop_filter_plane_masked(rec, flens[vk], flens[hk], lvl,
                                             fp.sharpness, is_luma, bd)
            cands.append((lvl, f))
            sses.append(_sse(src[plane], f))
        return cands[int(torch.stack(sses).argmin())]

    ly, fy = search("y", "y_v", "y_h", _ladder(d), True)
    fp.filter_level = (ly, ly)
    if fy is not None:
        out["y"] = fy.to(recon["y"].dtype)
    if ly == 0:
        fp.filter_level_uv = (0, 0)
        return out
    duv = max(0, d - 2)
    lu, fu = search("u", "uv_v", "uv_h", _ladder(duv), False)
    lv, fv = search("v", "uv_v", "uv_h", _ladder(duv), False)
    fp.filter_level_uv = (lu, lv)
    for p, f in (("u", fu), ("v", fv)):
        if f is not None:
            out[p] = f.to(recon[p].dtype)
    return out
