"""Hierarchical motion estimation (open-loop HME/ME), the PyTorch port of
svt_av1_tpu/pipeline/me.py.

Every level is one batched search over all blocks of the frame:

  coarse (1/8 res): 8x8 blocks (64x64 superblocks) over a wide window
  level 2 (1/4 res): dense refinement around the coarse winner
  level 0 (full res): dense refinement around the superblock seeds

Candidate costs are SSD (ops/me.ssd_search); the winner of each search is
the first minimum in raster order of the offsets, as in the reference.
Returns integer MVs per 16x16 block, the input of the inter MD (P1).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from svt_av1_tpu_torch import device as device_mod
from svt_av1_tpu_torch.ops import me as me_ops

BLK = 16


def _block_grid(plane: torch.Tensor, blk: int):
    """(S*gh*gw, blk, blk) blocks of (S, h, w) planes, stream-major."""
    ns, h, w = plane.shape
    gh, gw = h // blk, w // blk
    blocks = plane.reshape(ns, gh, blk, gw, blk).permute(0, 1, 3, 2, 4)
    return blocks.reshape(ns * gh * gw, blk, blk), gh, gw


def _gather_windows(ref: torch.Tensor, sid, cys, cxs, blk: int, rad: int):
    """(B, blk+2*rad, blk+2*rad) windows of the (S, H, W) planes ``ref``
    centered at (cys, cxs) in plane sid, with edge clamping."""
    size = blk + 2 * rad
    offs = torch.arange(size, device=ref.device)
    rows = (cys[:, None] - rad + offs[None]).clamp(0, ref.shape[1] - 1)
    cols = (cxs[:, None] - rad + offs[None]).clamp(0, ref.shape[2] - 1)
    return ref[sid[:, None, None], rows[:, :, None], cols[:, None, :]]


def _search_level(src_blocks, ref, sid, base_y, base_x, blk: int, rad: int):
    """Dense SSD search of radius ``rad`` around (base_y, base_x) block
    positions.  Returns (mv_y, mv_x) relative to the base position."""
    wins = _gather_windows(ref, sid, base_y, base_x, blk, rad)
    cost = me_ops.ssd_search(src_blocks, wins)
    idx = cost.reshape(cost.shape[0], -1).argmin(dim=1)
    span = 2 * rad + 1
    return idx // span - rad, idx % span - rad


def _grid(ns, gh, gw, dev):
    """(stream, block row, block column) of every block of an (S, gh, gw)
    grid, stream-major."""
    ar = torch.arange(ns * gh * gw, device=dev)
    loc = ar % (gh * gw)
    return ar // (gh * gw), loc // gw, loc % gw


def hme_core(h, w, rad2, rad1, rad0):
    """Whole-frame HME: returns run(src, ref) -> (mv_y, mv_x, ssd) over
    the (h//16, w//16) grid for int32 planes; h/w must be multiples of
    64.  src/ref may carry a leading stream axis, (S, h, w): every level
    then searches all S streams' blocks as one batch (each block in its
    own stream's reference) and the outputs are (S, h//16, w//16).  The
    costs are exact integers, so a stream's MVs do not depend on the
    batch."""
    def run(src, ref):
        one = src.dim() == 2
        if one:
            src, ref = src[None], ref[None]
        ns = src.shape[0]
        dev = src.device
        src4 = me_ops.downsample2(me_ops.downsample2(src))
        ref4 = me_ops.downsample2(me_ops.downsample2(ref))
        seed2_y = seed2_x = None
        if rad1 > 0:
            src8 = me_ops.downsample2(src4)
            ref8 = me_ops.downsample2(ref4)
            sb8, g8h, g8w = _block_grid(src8, 8)
            s8, r8, c8 = _grid(ns, g8h, g8w, dev)
            myA, mxA = _search_level(sb8, ref8, s8, r8 * 8, c8 * 8, 8, rad1)
            seed2_y = myA * 2
            seed2_x = mxA * 2
        sb4, g4h, g4w = _block_grid(src4, BLK)
        s4, r4, c4 = _grid(ns, g4h, g4w, dev)
        cy = r4 * BLK
        cx = c4 * BLK
        if seed2_y is not None:
            cy = cy + seed2_y
            cx = cx + seed2_x
        my2, mx2 = _search_level(sb4, ref4, s4, cy, cx, BLK, rad2)
        if seed2_y is not None:
            my2 = my2 + seed2_y
            mx2 = mx2 + seed2_x
        gh, gw = h // BLK, w // BLK
        sid, by, bx = _grid(ns, gh, gw, dev)
        # level 0 around the block's own superblock seed and its four
        # neighbours' (the multi-predictor fullpel search)
        blocks, _, _ = _block_grid(src, BLK)
        best_ssd = mv_y = mv_x = None
        for dy, dx in ((0, 0), (0, -1), (0, 1), (-1, 0), (1, 0)):
            sb_r = (by // 4 + dy).clamp(0, g4h - 1)
            sb_c = (bx // 4 + dx).clamp(0, g4w - 1)
            sb_i = sid * (g4h * g4w) + sb_r * g4w + sb_c
            seed_y = my2[sb_i] * 4
            seed_x = mx2[sb_i] * 4
            my0, mx0 = _search_level(blocks, ref, sid, by * BLK + seed_y,
                                     bx * BLK + seed_x, BLK, rad0)
            cy = seed_y + my0
            cx = seed_x + mx0
            wins = _gather_windows(ref, sid, by * BLK + cy, bx * BLK + cx,
                                   BLK, 0)
            ssd = ((wins - blocks) ** 2).sum(dim=(1, 2), dtype=torch.int32)
            if best_ssd is None:
                best_ssd, mv_y, mv_x = ssd, cy, cx
            else:
                take = ssd < best_ssd
                best_ssd = torch.where(take, ssd, best_ssd)
                mv_y = torch.where(take, cy, mv_y)
                mv_x = torch.where(take, cx, mv_x)
        out = tuple(a.reshape(ns, gh, gw) for a in (mv_y, mv_x, best_ssd))
        return tuple(a[0] for a in out) if one else out
    return run


def as_plane(a, device) -> torch.Tensor:
    """An (h, w) plane (numpy array or tensor) as int32 on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.int32)
    return torch.as_tensor(np.asarray(a, np.int32), device=device)


def edge_pad_to(plane: torch.Tensor, hh: int, ww: int) -> torch.Tensor:
    """Edge-replicate an (..., H, W) plane to (hh, ww) at the
    bottom/right, as int32 (the HME pyramid wants multiples of 64)."""
    h, w = plane.shape[-2:]
    if (h, w) == (hh, ww):
        return plane.to(torch.int32)
    rows = torch.arange(hh, device=plane.device).clamp(max=h - 1)
    cols = torch.arange(ww, device=plane.device).clamp(max=w - 1)
    return plane.to(torch.int32)[..., rows[:, None], cols[None, :]]


def hierarchical_me(src, ref, rad2: int = 8, rad0: int = 7, rad1: int = 8,
                    device=None) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Open-loop ME on ``device`` (default: the current CUDA device):
    per-16x16 integer MVs src -> ref as (gh, gw) numpy arrays (mv_y,
    mv_x, ssd).  src/ref: (h, w) numpy arrays or tensors (8- or 10-bit
    samples).  Dims that are not multiples of 64 are edge-padded for the
    pyramid; the grid is cropped back.  The stage path's inter frames
    (pipeline/inter_encoder.py) and TPL (pipeline/tpl.tpl_frame_stats)
    call it."""
    dev = device_mod.resolve(device)
    src, ref = as_plane(src, dev), as_plane(ref, dev)
    h, w = src.shape
    assert h % BLK == 0 and w % BLK == 0
    h64 = (h + 63) & ~63
    w64 = (w + 63) & ~63
    run = hme_core(h64, w64, rad2, rad1, rad0)
    mv_y, mv_x, ssd = run(edge_pad_to(src, h64, w64),
                          edge_pad_to(ref, h64, w64))
    gh, gw = h // BLK, w // BLK
    return tuple(a[:gh, :gw].cpu().numpy() for a in (mv_y, mv_x, ssd))
