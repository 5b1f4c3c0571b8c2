"""Motion search primitives, the PyTorch port of svt_av1_tpu/ops/me.py.

Block-matching cost over a dense candidate grid as SSD(c) = ||ref_c||^2
- 2<src, ref_c> + ||src||^2.  The cross term is one batched float32
matmul of each block against the patches of its own window (the
reference runs it as a grouped conv on the MXU).  For 8-bit 16x16 blocks
every partial sum is an integer below 2^24, so the float32 result is
exact in any order of summation, provided the matmul runs in full
float32 (device.resolve turns TF32 off).  A library convolution is
avoided on purpose: cuDNN may pick an FFT algorithm for 16x16 filters,
which is not exact.  The window energy is an exact integer box sum.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def sad(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum of absolute differences over the trailing 2 dims."""
    return (a.to(torch.int32) - b.to(torch.int32)).abs().sum(
        dim=(-2, -1), dtype=torch.int32)


def ssd_search(src_blocks: torch.Tensor, windows: torch.Tensor
               ) -> torch.Tensor:
    """Dense block-matching SSD over all integer offsets.

    src_blocks: (B, h, w) blocks; windows: (B, H, W) search areas.
    Returns (B, H-h+1, W-w+1) float32 SSD cost maps."""
    b, h, w = src_blocks.shape
    _, wh, ww = windows.shape
    oh, ow = wh - h + 1, ww - w + 1
    winf = windows.to(torch.float32)
    filt = src_blocks.to(torch.float32).reshape(b, h * w, 1)
    # (B, oh*ow, h*w) patches: row l is the window at offset l, one
    # strided copy for the whole batch (F.unfold's CUDA im2col launches
    # a kernel per block)
    patches = winf.unfold(1, h, 1).unfold(2, w, 1).reshape(b, oh * ow, h * w)
    cross = torch.bmm(patches, filt).reshape(b, oh, ow)
    ref_sq = _box_sum(windows.to(torch.int32) ** 2, h, w)
    src_sq = (filt * filt).sum(dim=(1, 2))
    return ref_sq.to(torch.float32) - 2.0 * cross + src_sq[:, None, None]


def _box_sum(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Sliding (h, w) window sums over the trailing 2 dims, VALID
    padding; exact (int64 prefix sums), returned as int32."""
    c = F.pad(x.to(torch.int64).cumsum(-2).cumsum(-1), (1, 0, 1, 0))
    s = (c[..., h:, w:] - c[..., :-h, w:] - c[..., h:, :-w]
         + c[..., :-h, :-w])
    return s.to(torch.int32)


def best_mv(cost_map: torch.Tensor, origin_y: int, origin_x: int
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """argmin over a cost map (first minimum) -> (mv_y, mv_x, cost);
    origin is the offset of cost_map[0, 0] from the co-located
    position."""
    b = cost_map.shape[0]
    flat = cost_map.reshape(b, -1)
    idx = flat.argmin(dim=1)
    wy = cost_map.shape[2]
    return (idx // wy + origin_y, idx % wy + origin_x,
            flat.gather(1, idx[:, None])[:, 0])


def downsample2(x: torch.Tensor) -> torch.Tensor:
    """2x decimation by a rounded 2x2 box average (the HME pyramid)."""
    x = x.to(torch.int32)
    return (x[..., 0::2, 0::2] + x[..., 0::2, 1::2] + x[..., 1::2, 0::2]
            + x[..., 1::2, 1::2] + 2) >> 2
