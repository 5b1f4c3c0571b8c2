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
``apply_masked``, ``search_and_apply_masked``) serves mixed block sizes
and comes with the masked filter.
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
