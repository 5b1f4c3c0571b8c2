"""Temporal filtering (alt-ref / MCTF) core, the PyTorch port of
svt_av1_tpu/ops/tf.py.

The reference's planewise non-local-mean filter (temporal_filtering.c
svt_av1_apply_temporal_filter_planewise_medium_c): each 32x32 block of the
filtered frame is a per-pixel weighted average of the co-located
motion-compensated blocks of the neighbouring frames, with weights that
decay with the subblock matching error, the MV length and a
noise-adaptive decay factor.  An encoder-side denoiser (not normative),
in float32 as in the reference.

Float parts: the window mean is exact (a sum of 256 squares of 8-bit
differences stays under 2^24), sqrt and the divisions are correctly
rounded (every divisor that is not a power of two is a tensor on the
data's device, so that CUDA divides instead of multiplying by a rounded
reciprocal), but exp is not correctly rounded and the weighted sum over
the F neighbours runs in the device's order.  So a filtered pixel may
differ from the reference's by 1 where the exact value of accum / count
lies next to a half-integer; ``dtype`` / ``raw`` give that value.
"""
from __future__ import annotations

import torch

TF_WEIGHT_SCALE = 1000
TF_WINDOW_BLOCK_BALANCE_WEIGHT = 5
BLK = 32
SUB = 16


def _const(x, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=like.dtype, device=like.device)


def subblock_weights(center, preds, block_errors, mvs, decay_factor,
                     mv_dist_th, dtype=torch.float32) -> torch.Tensor:
    """Per-subblock filter weights.

    center: (B, 32, 32) source block; preds: (B, F, 32, 32) MC predictions
    from F alt frames; block_errors: (B, F, 4) subblock ME errors (fp8
    domain like the reference, i.e. SSE>>shift); mvs: (B, F, 4, 2).
    Returns weights (B, F, 4) in [0, TF_WEIGHT_SCALE], in ``dtype``."""
    c = center.to(dtype)[:, None]
    p = preds.to(dtype)
    # window error per 16x16 quadrant (mean squared diff * 256)
    d2 = (c - p) ** 2
    quads = [d2[..., :SUB, :SUB], d2[..., :SUB, SUB:],
             d2[..., SUB:, :SUB], d2[..., SUB:, SUB:]]
    win_err = torch.stack([q.mean(dim=(-2, -1)) * 256.0 for q in quads],
                          dim=-1)                     # (B, F, 4)
    combined = ((win_err * TF_WINDOW_BLOCK_BALANCE_WEIGHT
                 + block_errors.to(dtype))
                / _const(TF_WINDOW_BLOCK_BALANCE_WEIGHT + 1, win_err))
    dist = torch.sqrt((mvs.to(dtype) ** 2).sum(-1))
    d_factor = torch.clamp(dist / _const(max(mv_dist_th / 10.0, 1.0), dist),
                           min=1.0)
    scaled = torch.clamp(combined / 256.0 * d_factor
                         / _const(max(decay_factor, 1e-6), combined),
                         max=7.0)
    return torch.exp(-scaled) * TF_WEIGHT_SCALE


def blend(center, preds, w, sub, center_weight: int = TF_WEIGHT_SCALE,
          raw: bool = False) -> torch.Tensor:
    """The weighted average of (B, n, n) center blocks and their (B, F,
    n, n) predictions, each prediction's 2x2 subblock weights w (B, F, 4)
    spread over sub x sub pixels: (B, n, n) int32, rounded half to even
    and clipped to [0, 255], or with ``raw`` the unrounded accum / count
    in w's dtype."""
    b, f, _ = w.shape
    wpix = (w.reshape(b, f, 2, 2).repeat_interleave(sub, dim=2)
            .repeat_interleave(sub, dim=3))
    accum = (center.to(w.dtype) * center_weight
             + (preds.to(w.dtype) * wpix).sum(dim=1))
    count = center_weight + wpix.sum(dim=1)
    val = accum / count
    if raw:
        return val
    return torch.clamp(torch.round(val), 0, 255).to(torch.int32)


def temporal_filter(center, preds, block_errors, mvs, decay_factor=1.0,
                    mv_dist_th=16.0, center_weight: int = TF_WEIGHT_SCALE,
                    dtype=torch.float32, raw: bool = False) -> torch.Tensor:
    """Filter a batch of 32x32 blocks against F MC predictions: the
    filtered blocks (B, 32, 32) int32 (the rounded weighted average with
    the center frame at full weight, svt_aom_apply_filtering_central
    semantics), or with ``raw`` the unrounded values."""
    w = subblock_weights(center, preds, block_errors, mvs, decay_factor,
                         mv_dist_th, dtype)
    return blend(center, preds, w, SUB, center_weight, raw)
