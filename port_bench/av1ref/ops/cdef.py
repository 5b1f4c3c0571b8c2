"""CDEF: constrained directional enhancement filter, batched (PyTorch port
of svt_av1_tpu/ops/cdef.py).

Normative filter (AV1 spec 7.15; behavioral reference: cdef.c
svt_aom_cdef_find_dir_c / svt_cdef_filter_block_c):

  * direction search: every pixel of an 8x8 block adds into exactly one
    of the 15 partial sums of each of the 8 directions, so the partials
    of a batch are one integer scatter-add (the reference contracts the
    same 0/1 projection tensors in an einsum);
  * the filter is gathers + elementwise ops over a padded (B, n+4, n+4)
    window batch.

Frame assembly (strength search, CDEF_VERY_LARGE borders) lives in
pipeline/cdef_stage.py.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

CDEF_VERY_LARGE = 0x7F7F
# direction offsets (dy, dx) per direction 0..7 and tap k in {0,1}
# (spec Cdef_Directions)
CDEF_DIRECTIONS = np.array([
    [(-1, 1), (-2, 2)],
    [(0, 1), (-1, 2)],
    [(0, 1), (0, 2)],
    [(0, 1), (1, 2)],
    [(1, 1), (2, 2)],
    [(1, 0), (2, 1)],
    [(1, 0), (2, 0)],
    [(1, 0), (2, -1)]], dtype=np.int32)

PRI_TAPS = np.array([[4, 2], [3, 3]], dtype=np.int32)
SEC_TAPS = np.array([[2, 1], [2, 1]], dtype=np.int32)

_DIV_TABLE = np.array([0, 840, 420, 280, 210, 168, 140, 120, 105],
                      dtype=np.int64)


@functools.lru_cache(maxsize=1)
def _partial_projections() -> np.ndarray:
    """(8, 15, 64) 0/1 projection tensors: P[d, p, i*8+j] = 1 iff pixel
    (i, j) contributes to partial[d][p] (spec direction partials)."""
    P = np.zeros((8, 15, 64), dtype=np.float32)
    for i in range(8):
        for j in range(8):
            px = i * 8 + j
            P[0, i + j, px] = 1
            P[1, i + j // 2, px] = 1
            P[2, i, px] = 1
            P[3, 3 + i - j // 2, px] = 1
            P[4, 7 + i - j, px] = 1
            P[5, 3 - i // 2 + j, px] = 1
            P[6, j, px] = 1
            P[7, i // 2 + j, px] = 1
    return P


@functools.lru_cache(maxsize=1)
def _cost_weights() -> np.ndarray:
    """(8, 15) per-partial cost weights (div_table pattern per spec)."""
    W = np.zeros((8, 15), dtype=np.float32)
    for d in (2, 6):
        W[d, :8] = _DIV_TABLE[8]
    for d in (0, 4):
        for i in range(7):
            W[d, i] = _DIV_TABLE[i + 1]
            W[d, 14 - i] = _DIV_TABLE[i + 1]
        W[d, 7] = _DIV_TABLE[8]
    for d in (1, 3, 5, 7):
        for j in range(5):
            W[d, 3 + j] = _DIV_TABLE[8]
        for j in range(3):
            W[d, j] = _DIV_TABLE[2 * j + 2]
            W[d, 10 - j] = _DIV_TABLE[2 * j + 2]
    return W


@functools.lru_cache(maxsize=8)
def _find_dir_consts(device):
    """The projections as scatter targets, (8*64,) flat partial index
    d*15 + p of each (direction, pixel), and the int32 cost weights, on
    ``device``."""
    target = _partial_projections().argmax(axis=1)          # (8, 64)
    flat = target + 15 * np.arange(8)[:, None]
    return (torch.as_tensor(flat.reshape(-1), device=device),
            torch.as_tensor(_cost_weights().astype(np.int32), device=device))


def cdef_find_dir(blocks: torch.Tensor, coeff_shift: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Direction search for a batch of 8x8 blocks.

    blocks: (B, 8, 8) int pixels.  Returns (dir (B,), var (B,)) int32,
    bit-exact with the JAX package's cdef_find_dir: the partials and the
    weighted costs are integers (int32, split into a high and a low 16-bit
    accumulator), the direction is the first argmax of the costs
    recombined in float32, and the variance truncates the float32
    (best - orthogonal) / 1024.  Float32 rounds a cost above 2^24 as the
    reference does; an exact int64 cost would move directions on
    high-contrast blocks."""
    b = blocks.shape[0]
    x = ((blocks.to(torch.int32) >> coeff_shift) - 128).reshape(b, 64)
    flat, wi = _find_dir_consts(blocks.device)
    partials = torch.zeros((b, 8 * 15), dtype=torch.int32,
                           device=blocks.device)
    partials.scatter_add_(1, flat.expand(b, -1), x.repeat(1, 8))
    pi = partials.reshape(b, 8, 15)
    prod = pi * pi * wi[None]                        # <= 2^20 * 840 ~ 2^30
    hi = (prod >> 16).sum(dim=2, dtype=torch.int32)
    lo = (prod & 0xFFFF).sum(dim=2, dtype=torch.int32)   # <= 15*2^16
    cost_hi = hi + (lo >> 16)
    cost_lo = lo & 0xFFFF
    cost_f = (cost_hi.to(torch.float32) * 65536.0
              + cost_lo.to(torch.float32))
    best_dir = torch.argmax(cost_f, dim=1)
    best_cost = cost_f.gather(1, best_dir[:, None])[:, 0]
    ortho = cost_f.gather(1, ((best_dir + 4) & 7)[:, None])[:, 0]
    var = ((best_cost - ortho) / 1024.0).to(torch.int32)
    return best_dir.to(torch.int32), var


def _constrain(diff, threshold, shift):
    """Vectorized spec constrain(); shift precomputed from damping."""
    mag = torch.minimum(diff.abs(),
                        torch.clamp(threshold - (diff.abs() >> shift),
                                    min=0))
    return torch.sign(diff) * mag


def _msb(x):
    """floor(log2(x)) for x >= 1, elementwise, integer-exact."""
    out = torch.zeros_like(x)
    for k in range(1, 16):
        out = torch.where(x >= (1 << k), k, out)
    return out


@functools.lru_cache(maxsize=8)
def _filter_consts(device):
    return tuple(torch.as_tensor(a, dtype=torch.int64, device=device)
                 for a in (CDEF_DIRECTIONS, PRI_TAPS, SEC_TAPS))


def cdef_filter_block(windows: torch.Tensor, pri_strength, sec_strength,
                      direction, pri_damping: int, sec_damping: int,
                      coeff_shift: int = 0, bd: int = 8,
                      n: int = 8) -> torch.Tensor:
    """Filter a batch of n x n blocks (n=8 luma, n=4 chroma 4:2:0).

    windows: (B, n+4, n+4) int32 padded input (block at [2:2+n, 2:2+n];
             out-of-frame samples = CDEF_VERY_LARGE).
    pri_strength/sec_strength/direction: (B,) int32.
    Returns (B, n, n) int32, bit-exact with svt_cdef_filter_block_c."""
    b = windows.shape[0]
    dev = windows.device
    dirs, pri_tab, sec_tab = _filter_consts(dev)
    x = windows[:, 2:2 + n, 2:2 + n]
    tap_sel = ((pri_strength >> coeff_shift) & 1).long()
    pri_taps = pri_tab[tap_sel].to(torch.int32)    # (B, 2)
    sec_taps = sec_tab[tap_sel].to(torch.int32)
    pri_sh = torch.clamp(
        pri_damping - torch.where(pri_strength > 0,
                                  _msb(torch.clamp(pri_strength, min=1)), 0),
        min=0)
    sec_sh = torch.clamp(
        sec_damping - torch.where(sec_strength > 0,
                                  _msb(torch.clamp(sec_strength, min=1)), 0),
        min=0)
    pri_s = pri_strength[:, None, None]
    sec_s = sec_strength[:, None, None]
    pri_sh = pri_sh[:, None, None]
    sec_sh = sec_sh[:, None, None]

    bi = torch.arange(b, device=dev)[:, None, None]
    ar = torch.arange(n, device=dev)
    direction = direction.long()
    sum_ = torch.zeros((b, n, n), dtype=torch.int32, device=dev)
    mx = x
    mn = x

    def shifted(d):
        """(B, n, n) gather at offset d (B, 2) = (dy, dx) per block."""
        rr = ar[None, :, None] + d[:, 0, None, None] + 2
        cols = ar[None, None, :] + d[:, 1, None, None] + 2
        return windows[bi, rr, cols]

    for k in range(2):
        d_pri = dirs[direction, k]                # (B, 2)
        d_sec0 = dirs[(direction + 2) & 7, k]
        d_sec1 = dirs[(direction - 2) & 7, k]
        pt = pri_taps[:, k, None, None]
        st = sec_taps[:, k, None, None]
        for sgn in (1, -1):
            p = shifted(sgn * d_pri)
            large = p == CDEF_VERY_LARGE
            sum_ = sum_ + pt * _constrain(torch.where(large, 0, p - x),
                                          pri_s, pri_sh)
            mx = torch.maximum(mx, torch.where(large, mx, p))
            mn = torch.minimum(mn, p)
            for dsec in (d_sec0, d_sec1):
                s = shifted(sgn * dsec)
                large_s = s == CDEF_VERY_LARGE
                sum_ = sum_ + st * _constrain(torch.where(large_s, 0, s - x),
                                              sec_s, sec_sh)
                mx = torch.maximum(mx, torch.where(large_s, mx, s))
                mn = torch.minimum(mn, s)

    y = x + ((8 + sum_ - (sum_ < 0).to(torch.int32)) >> 4)
    return torch.minimum(torch.maximum(y, mn), mx)
