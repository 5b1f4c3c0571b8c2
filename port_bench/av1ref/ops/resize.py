"""Super-resolution upscale, the PyTorch port of svt_av1_tpu/ops/resize.py.

Normative horizontal super-res upscale (AV1 spec 7.16; behavioral
reference: super_res.c av1_convolve_horiz_rs_c / upscale_normative_rect):
the output-column sampling grid (source index + subpel phase) is static
per geometry, so it is planned once on the host (numpy, as in the
reference) and the upscale is one gather of 8 source columns per output
column and an 8-tap integer sum, batched over rows and planes, on the
tensor's device.  Exact in int32.
"""
from __future__ import annotations

import functools
import os
from typing import Tuple

import numpy as np
import torch

RS_SCALE_SUBPEL_BITS = 14
RS_SUBPEL_BITS = 6
RS_SCALE_EXTRA_BITS = RS_SCALE_SUBPEL_BITS - RS_SUBPEL_BITS
RS_SCALE_EXTRA_OFF = 1 << (RS_SCALE_EXTRA_BITS - 1)
RS_SCALE_SUBPEL_MASK = (1 << RS_SCALE_SUBPEL_BITS) - 1
UPSCALE_TAPS = 8
FILTER_BITS = 7

_DATA = os.path.join(os.path.dirname(__file__), "..", "codec", "data",
                     "av1_resize_filters.npz")


@functools.lru_cache(maxsize=1)
def _filters() -> np.ndarray:
    return np.load(_DATA)["resize_filter_normative"].astype(np.int32)


def upscale_step_x0(in_w: int, out_w: int) -> Tuple[int, int]:
    step = ((in_w << RS_SCALE_SUBPEL_BITS) + out_w // 2) // out_w
    err = out_w * step - (in_w << RS_SCALE_SUBPEL_BITS)
    x0 = (-((out_w - in_w) << (RS_SCALE_SUBPEL_BITS - 1)) + out_w // 2) \
        // out_w + RS_SCALE_EXTRA_OFF - err // 2
    return step, x0 & RS_SCALE_SUBPEL_MASK


@functools.lru_cache(maxsize=None)
def _upscale_plan(in_w: int, out_w: int):
    """(base_idx (out_w,), taps (out_w, 8)) with border replication folded
    into clamped indices."""
    step, x0 = upscale_step_x0(in_w, out_w)
    filt = _filters()
    xs = x0 + step * np.arange(out_w)
    # src pointer starts at input - 1 - (taps/2 - 1) = input - 4
    base = (xs >> RS_SCALE_SUBPEL_BITS) - 4
    phase = (xs & RS_SCALE_SUBPEL_MASK) >> RS_SCALE_EXTRA_BITS
    taps = filt[phase]                                  # (out_w, 8)
    idx = base[:, None] + np.arange(UPSCALE_TAPS)[None]  # (out_w, 8)
    idx = np.clip(idx, 0, in_w - 1)                      # border replicate
    return idx.astype(np.int32), taps.astype(np.int32)


@functools.lru_cache(maxsize=None)
def _plan_on(in_w: int, out_w: int, device: torch.device):
    """The plan as (long indices, int32 taps) on ``device``."""
    idx, taps = _upscale_plan(in_w, out_w)
    return (torch.from_numpy(idx.astype(np.int64)).to(device),
            torch.from_numpy(taps).to(device))


def superres_upscale(plane: torch.Tensor, out_w: int, bd: int = 8
                     ) -> torch.Tensor:
    """Normative horizontal upscale: (..., H, in_w) -> (..., H, out_w)
    int32, bit-exact with upscale_normative_rect (frame-wide, borders
    replicated)."""
    idx, taps = _plan_on(plane.shape[-1], out_w, plane.device)
    g = plane.to(torch.int32)[..., idx]                 # (..., H, out_w, 8)
    s = (g * taps).sum(-1, dtype=torch.int32)
    out = (s + (1 << (FILTER_BITS - 1))) >> FILTER_BITS
    return torch.clamp(out, 0, (1 << bd) - 1)


def upscale_frame(recon, out_w: int, bd: int = 8):
    """The normative upscale of a frame's three planes (luma to ``out_w``,
    4:2:0 chroma to ``out_w >> 1``), each kept in its dtype and on its
    device."""
    out = dict(recon)
    for p, w in (("y", out_w), ("u", out_w >> 1), ("v", out_w >> 1)):
        out[p] = superres_upscale(recon[p], w, bd).to(recon[p].dtype)
    return out
