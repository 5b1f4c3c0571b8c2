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
    h, w = plane.shape
    gh, gw = h // blk, w // blk
    blocks = plane.reshape(gh, blk, gw, blk).permute(0, 2, 1, 3)
    return blocks.reshape(gh * gw, blk, blk), gh, gw


def _gather_windows(ref: torch.Tensor, cys, cxs, blk: int, rad: int):
    """(B, blk+2*rad, blk+2*rad) windows centered at (cys, cxs) with edge
    clamping."""
    size = blk + 2 * rad
    offs = torch.arange(size, device=ref.device)
    rows = (cys[:, None] - rad + offs[None]).clamp(0, ref.shape[0] - 1)
    cols = (cxs[:, None] - rad + offs[None]).clamp(0, ref.shape[1] - 1)
    return ref[rows[:, :, None], cols[:, None, :]]


def _search_level(src_blocks, ref, base_y, base_x, blk: int, rad: int):
    """Dense SSD search of radius ``rad`` around (base_y, base_x) block
    positions.  Returns (mv_y, mv_x) relative to the base position."""
    wins = _gather_windows(ref, base_y, base_x, blk, rad)
    cost = me_ops.ssd_search(src_blocks, wins)
    idx = cost.reshape(cost.shape[0], -1).argmin(dim=1)
    span = 2 * rad + 1
    return idx // span - rad, idx % span - rad


def hme_core(h, w, rad2, rad1, rad0):
    """Whole-frame HME: returns run(src, ref) -> (mv_y, mv_x, ssd) over
    the (h//16, w//16) grid for int32 planes; h/w must be multiples of
    64."""
    def run(src, ref):
        dev = src.device
        src4 = me_ops.downsample2(me_ops.downsample2(src))
        ref4 = me_ops.downsample2(me_ops.downsample2(ref))
        seed2_y = seed2_x = None
        if rad1 > 0:
            src8 = me_ops.downsample2(src4)
            ref8 = me_ops.downsample2(ref4)
            sb8, g8h, g8w = _block_grid(src8, 8)
            ar8 = torch.arange(g8h * g8w, device=dev)
            myA, mxA = _search_level(sb8, ref8, (ar8 // g8w) * 8,
                                     (ar8 % g8w) * 8, 8, rad1)
            seed2_y = myA * 2
            seed2_x = mxA * 2
        sb4, g4h, g4w = _block_grid(src4, BLK)
        ar4 = torch.arange(g4h * g4w, device=dev)
        cy = (ar4 // g4w) * BLK
        cx = (ar4 % g4w) * BLK
        if seed2_y is not None:
            cy = cy + seed2_y
            cx = cx + seed2_x
        my2, mx2 = _search_level(sb4, ref4, cy, cx, BLK, rad2)
        if seed2_y is not None:
            my2 = my2 + seed2_y
            mx2 = mx2 + seed2_x
        gh, gw = h // BLK, w // BLK
        ar = torch.arange(gh * gw, device=dev)
        by = ar // gw
        bx = ar % gw
        # level 0 around the block's own superblock seed and its four
        # neighbours' (the multi-predictor fullpel search)
        blocks, _, _ = _block_grid(src, BLK)
        best_ssd = mv_y = mv_x = None
        for dy, dx in ((0, 0), (0, -1), (0, 1), (-1, 0), (1, 0)):
            sb_r = (by // 4 + dy).clamp(0, g4h - 1)
            sb_c = (bx // 4 + dx).clamp(0, g4w - 1)
            sb_i = sb_r * g4w + sb_c
            seed_y = my2[sb_i] * 4
            seed_x = mx2[sb_i] * 4
            my0, mx0 = _search_level(blocks, ref, by * BLK + seed_y,
                                     bx * BLK + seed_x, BLK, rad0)
            cy = seed_y + my0
            cx = seed_x + mx0
            wins = _gather_windows(ref, by * BLK + cy, bx * BLK + cx,
                                   BLK, 0)
            ssd = ((wins - blocks) ** 2).sum(dim=(1, 2), dtype=torch.int32)
            if best_ssd is None:
                best_ssd, mv_y, mv_x = ssd, cy, cx
            else:
                take = ssd < best_ssd
                best_ssd = torch.where(take, ssd, best_ssd)
                mv_y = torch.where(take, cy, mv_y)
                mv_x = torch.where(take, cx, mv_x)
        return (mv_y.reshape(gh, gw), mv_x.reshape(gh, gw),
                best_ssd.reshape(gh, gw))
    return run


def hierarchical_me(src: np.ndarray, ref: np.ndarray, rad2: int = 8,
                    rad0: int = 7, rad1: int = 8, device=None
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Open-loop ME on ``device`` (default: the current CUDA device):
    per-16x16 integer MVs src -> ref as (gh, gw) numpy arrays (mv_y,
    mv_x, ssd).  Dims that are not multiples of 64 are edge-padded for
    the pyramid; the grid is cropped back."""
    dev = device_mod.resolve(device)
    h, w = src.shape
    assert h % BLK == 0 and w % BLK == 0
    h64 = (h + 63) & ~63
    w64 = (w + 63) & ~63
    if (h64, w64) != (h, w):
        pads = ((0, h64 - h), (0, w64 - w))
        src = np.pad(src, pads, mode="edge")
        ref = np.pad(ref, pads, mode="edge")
    run = hme_core(h64, w64, rad2, rad1, rad0)
    t = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)
    mv_y, mv_x, ssd = run(t(src), t(ref))
    gh, gw = h // BLK, w // BLK
    return tuple(a[:gh, :gw].cpu().numpy() for a in (mv_y, mv_x, ssd))
