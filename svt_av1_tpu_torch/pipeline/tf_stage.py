"""Motion-compensated temporal filtering (MCTF) stage, the PyTorch port of
svt_av1_tpu/pipeline/tf_stage.py.

An encoder-side denoiser applied to key-frame sources and mini-GoP bases
before they are encoded (reference: temporal_filtering.c through the
picture-decision process).  The whole filter runs as one function of
eager PyTorch ops on the device: per neighbour a full-pel HME
(pipeline/me.hme_core) and the luma and chroma MC of every 16x16 block
at its MV (ops/mc.mc_blocks; chroma takes the luma MVs, halved by the
subsampling, so odd luma MVs land on chroma half-pel positions), the
32x32 tile assembly, the subblock weights (ops/tf.py) and the weighted
average of the three planes.  The planes are edge-padded to a multiple
of 32 (then of 64 for the HME pyramid) and cropped back; one host copy
brings the three filtered planes back.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from svt_av1_tpu_torch import device as device_mod
from svt_av1_tpu_torch.ops import mc, tf as tf_ops
from svt_av1_tpu_torch.pipeline import me as me_pipe
from svt_av1_tpu_torch.pipeline.gop_fast import _edge_pad_to


def _tile16_to_32(a16, g32h, g32w):
    """(nb16, 16, 16) quadrant blocks -> (nb32, 32, 32) tiles."""
    g16h, g16w = g32h * 2, g32w * 2
    a = a16.reshape(g16h, g16w, 16, 16)
    a = a.reshape(g32h, 2, g32w, 2, 16, 16).permute(0, 2, 1, 4, 3, 5)
    return a.reshape(g32h * g32w, 32, 32)


def _quad16(a16, g32h, g32w):
    """(nb16, ...) per-16-block values -> (nb32, 4, ...) quadrants in
    (0,0),(0,1),(1,0),(1,1) order."""
    rest = tuple(a16.shape[1:])
    a = a16.reshape((g32h, 2, g32w, 2) + rest)
    a = torch.movedim(a, 2, 1)                 # (g32h, g32w, 2, 2, ...)
    return a.reshape((g32h * g32w, 4) + rest)


def _tile16_to_16(a8, g32h, g32w):
    """(nb16, 8, 8) chroma quadrant blocks -> (nb32, 16, 16) tiles."""
    g16h, g16w = g32h * 2, g32w * 2
    a = a8.reshape(g16h, g16w, 8, 8)
    a = a.reshape(g32h, 2, g32w, 2, 8, 8).permute(0, 2, 1, 4, 3, 5)
    return a.reshape(g32h * g32w, 16, 16)


def _clamp_mvs_traced(mvs, ys, xs, blk, h, w, pad=mc.PAD):
    """Clamp (nb, 2) 1/8-pel MVs so that the window of a block at ys/xs
    stays inside a pad-extended plane, with the margin of 8 the chroma
    window needs; low bit cleared."""
    r = torch.clamp(mvs[..., 0], (-(ys + pad - 8)) * 8,
                    (h + pad - 8 - (ys + blk)) * 8)
    c = torch.clamp(mvs[..., 1], (-(xs + pad - 8)) * 8,
                    (w + pad - 8 - (xs + blk)) * 8)
    return torch.stack([r & ~1, c & ~1], dim=-1).to(torch.int32)


def _to_blocks(plane, g32h, g32w, n):
    """(g32h*n, g32w*n) plane -> (nb32, n, n) tiles in raster order."""
    t = plane.reshape(g32h, n, g32w, n).permute(0, 2, 1, 3)
    return t.reshape(g32h * g32w, n, n)


def _from_blocks(tiles, g32h, g32w, n):
    return tiles.reshape(g32h, g32w, n, n).permute(0, 2, 1, 3).reshape(
        g32h * n, g32w * n)


def run(cy, cu, cv, ny, nu, nv, decay: float, dtype=torch.float32,
        raw: bool = False):
    """The filter (the reference's _jit_tf program) on 32-aligned planes:
    center cy (h32, w32), cu/cv (h32/2, w32/2) and the F neighbours
    stacked (F, ...), int32 tensors on one device.  Returns the filtered
    (y, u, v) int32 planes, or with ``raw`` the unrounded values in
    ``dtype``."""
    dev = cy.device
    h32, w32 = cy.shape
    F = ny.shape[0]
    g16h, g16w = h32 // 16, w32 // 16
    nb16 = g16h * g16w
    g32h, g32w = h32 // 32, w32 // 32
    ar = torch.arange(nb16, device=dev)
    ys16 = (ar // g16w * 16).to(torch.int32)
    xs16 = (ar % g16w * 16).to(torch.int32)
    h64 = (h32 + 63) & ~63
    w64 = (w32 + 63) & ~63
    hme = me_pipe.hme_core(h64, w64, 8, 8, 7)
    src64 = _edge_pad_to(cy, h64, w64)
    preds, errs, mvss = [], [], []
    cpreds = {"u": [], "v": []}
    for f in range(F):
        mvy, mvx, ssd = hme(src64, _edge_pad_to(ny[f], h64, w64))
        mvy = mvy[:g16h, :g16w].reshape(nb16)
        mvx = mvx[:g16h, :g16w].reshape(nb16)
        mvs = _clamp_mvs_traced(torch.stack([mvy * 8, mvx * 8], dim=-1),
                                ys16, xs16, 16, h32, w32)
        preds.append(mc.mc_blocks(mc.pad_plane(ny[f], mc.PAD), ys16, xs16,
                                  mvs, 16, mc.PAD, 0))
        errs.append(ssd[:g16h, :g16w].reshape(nb16))
        mvss.append(mvs)
        for plane, nc in (("u", nu), ("v", nv)):
            cpreds[plane].append(mc.mc_blocks(
                mc.pad_plane(nc[f], mc.PAD // 2), ys16 // 2, xs16 // 2, mvs,
                8, mc.PAD, 1))
    centers = _to_blocks(cy, g32h, g32w, 32)
    preds32 = torch.stack([_tile16_to_32(p, g32h, g32w) for p in preds],
                          dim=1)                      # (nb32, F, 32, 32)
    berr = torch.stack([_quad16(e, g32h, g32w) for e in errs],
                       dim=1).to(torch.float32) / 256.0
    bmvs = torch.stack([_quad16(m, g32h, g32w) for m in mvss],
                       dim=1).to(torch.float32) / 8.0
    wsub = tf_ops.subblock_weights(centers, preds32, berr, bmvs, decay,
                                   16.0, dtype)       # (nb32, F, 4)
    out = [_from_blocks(tf_ops.blend(centers, preds32, wsub, tf_ops.SUB,
                                     raw=raw), g32h, g32w, 32)]
    # chroma: the luma MVs (halved by the MC subsampling) and the luma
    # subblock weights
    for plane, cp in (("u", cu), ("v", cv)):
        cpred = torch.stack([_tile16_to_16(p, g32h, g32w)
                             for p in cpreds[plane]], dim=1)
        out.append(_from_blocks(tf_ops.blend(_to_blocks(cp, g32h, g32w, 16),
                                             cpred, wsub, 8, raw=raw),
                                g32h, g32w, 16))
    return tuple(out)


def mctf_filter_frame(center: Tuple[np.ndarray, np.ndarray, np.ndarray],
                      neighbors: List[Tuple[np.ndarray, ...]],
                      decay: float = 80.0, device=None,
                      dtype=torch.float32, raw: bool = False):
    """Filter ``center`` (y, u, v) against motion-compensated
    ``neighbors`` (a list of (y, u, v) source frames) on ``device``
    (default: the current CUDA device).  Returns the filtered (y, u, v)
    uint8 planes; with ``raw`` the unrounded float planes (the tie rule's
    reference values).

    decay ~ 2*(5.5 + noise_sigma)^2 in the reference's error domain
    (temporal_filtering.c tf_decay_factor); 80 suits moderate noise."""
    cy, cu, cv = center
    if not neighbors:
        return center
    dev = device_mod.resolve(device)
    h, w = cy.shape
    h32 = (h + 31) & ~31
    w32 = (w + 31) & ~31
    pad = ((0, h32 - h), (0, w32 - w))
    ch, cw = cu.shape
    cpadc = ((0, h32 // 2 - ch), (0, w32 // 2 - cw))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)
    planes = [t(np.pad(cy, pad, mode="edge")),
              t(np.pad(cu, cpadc, mode="edge")),
              t(np.pad(cv, cpadc, mode="edge"))]
    planes += [t(np.stack([np.pad(n[0], pad, mode="edge")
                           for n in neighbors]))]
    planes += [t(np.stack([np.pad(n[i], cpadc, mode="edge")
                           for n in neighbors])) for i in (1, 2)]
    fy, fu, fv = run(*planes, float(decay), dtype, raw)
    if raw:
        return (fy[:h, :w].cpu().numpy(), fu[:ch, :cw].cpu().numpy(),
                fv[:ch, :cw].cpu().numpy())
    # one host copy of the three planes
    packed = torch.cat([fy.reshape(-1), fu.reshape(-1), fv.reshape(-1)])
    packed = packed.to(torch.uint8).cpu().numpy()
    ny_, nc_ = h32 * w32, (h32 // 2) * (w32 // 2)
    fy = packed[:ny_].reshape(h32, w32)
    fu = packed[ny_:ny_ + nc_].reshape(h32 // 2, w32 // 2)
    fv = packed[ny_ + nc_:].reshape(h32 // 2, w32 // 2)
    return (fy[:h, :w].astype(cy.dtype), fu[:ch, :cw].astype(cu.dtype),
            fv[:ch, :cw].astype(cv.dtype))
