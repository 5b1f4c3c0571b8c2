"""Hadamard transform / SATD cost (PyTorch, batched), the port of
svt_av1_tpu/ops/satd.py.

Behavioral reference: svt_aom_hadamard_8x8_c + satd accumulation, the
cost TPL's dispenser sums per block.  The reference writes each pass as a
product with a fixed 8x8 +/-1 matrix (``_h8``, the butterfly with its
output permutation folded in); here each pass is that butterfly itself,
three stages of int32 adds on one axis, so the result is exact on any
device (CUDA has no int32 matmul).
"""
from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=1)
def _h8() -> np.ndarray:
    """8x8 matrix M with out = M @ in matching hadamard_col8 (including
    its output ordering)."""
    m = np.zeros((8, 8), dtype=np.int32)
    # derive by symbolic evaluation of the butterfly
    for k in range(8):
        x = np.zeros(8, dtype=np.int32)
        x[k] = 1
        b = np.array([x[0] + x[1], x[0] - x[1], x[2] + x[3], x[2] - x[3],
                      x[4] + x[5], x[4] - x[5], x[6] + x[7], x[6] - x[7]])
        c = np.array([b[0] + b[2], b[1] + b[3], b[0] - b[2], b[1] - b[3],
                      b[4] + b[6], b[5] + b[7], b[4] - b[6], b[5] - b[7]])
        out = np.zeros(8, dtype=np.int32)
        out[0] = c[0] + c[4]
        out[7] = c[1] + c[5]
        out[3] = c[2] + c[6]
        out[4] = c[3] + c[7]
        out[2] = c[0] - c[4]
        out[6] = c[1] - c[5]
        out[1] = c[2] - c[6]
        out[5] = c[3] - c[7]
        m[:, k] = out
    return m


def _col8(x: torch.Tensor) -> torch.Tensor:
    """hadamard_col8 along dim 1 of (B, 8, 8): out[:, o] = sum_k
    _h8()[o, k] * x[:, k]."""
    x = x.unbind(1)
    b = (x[0] + x[1], x[0] - x[1], x[2] + x[3], x[2] - x[3],
         x[4] + x[5], x[4] - x[5], x[6] + x[7], x[6] - x[7])
    c = (b[0] + b[2], b[1] + b[3], b[0] - b[2], b[1] - b[3],
         b[4] + b[6], b[5] + b[7], b[4] - b[6], b[5] - b[7])
    return torch.stack((c[0] + c[4], c[2] - c[6], c[0] - c[4], c[2] + c[6],
                        c[3] + c[7], c[3] - c[7], c[1] - c[5], c[1] + c[5]),
                       dim=1)


def hadamard_8x8(diff: torch.Tensor) -> torch.Tensor:
    """(B, 8, 8) int residuals -> (B, 8, 8) int32 Hadamard coefficients,
    bit-exact with svt_aom_hadamard_8x8_c (column pass then row pass,
    output stored row-major per the reference's buffer2 layout)."""
    x = diff.to(torch.int32)
    # pass 1 (columns): buffer[j, o] = (M @ x[:, j])[o]
    t = _col8(x).transpose(1, 2)
    # pass 2: buffer2[i, o] = (M @ buffer[:, i])[o]
    return _col8(t).transpose(1, 2)


def satd(diff: torch.Tensor) -> torch.Tensor:
    """Sum of absolute Hadamard-transformed differences over (B, 8, 8)
    residual blocks -> (B,) int32."""
    return hadamard_8x8(diff).abs().sum(dim=(1, 2), dtype=torch.int32)
