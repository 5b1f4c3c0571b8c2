"""Deblocking (loop) filter, AV1 spec 7.14: svt_av1_tpu/ops/dlf.py in
PyTorch.

Behavioral reference: deblocking_common.c (filter4/6/8/14 + masks) and
deblocking_filter.c (level/threshold derivation).  As in the reference,
all edges of a plane are filtered as one batched gather -> mask/filter ->
scatter pass (vertical edges, then horizontal), which is exact because
AV1 edge spacing (>= 8 px for the filters' reach) makes same-direction
edges independent.  The ops run on the plane's device; nothing loops over
edges or blocks in Python.

The mask-aware filter for mixed block sizes (``edge_flens``,
``loop_filter_plane_masked``) serves the merged 32x32 / 64x64 / rect skip
leaves of inter frames.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def loop_filter_thresholds(level: int, sharpness: int = 0
                           ) -> Tuple[int, int, int]:
    """(blimit, limit, hev_thresh) per spec threshold derivation."""
    lim = level >> ((sharpness > 0) + (sharpness > 4))
    if sharpness > 0:
        lim = min(lim, 9 - sharpness)
    lim = max(lim, 1)
    return 2 * (level + 2) + lim, lim, level >> 4


def _sc(x, shift=0):
    """signed char clamp, scaled for high bit depth (bd-8 shift)."""
    return torch.clamp(x, -128 << shift, (128 << shift) - 1)


def _r3(x):
    return (x + 4) >> 3


def _r4(x):
    return (x + 8) >> 4


def filter_lines(lines: torch.Tensor, blimit: int, limit: int, thresh: int,
                 filter_len: int, bd: int = 8) -> torch.Tensor:
    """Filter a batch of edge-perpendicular pixel lines.

    lines: (L, 14) int32, samples p6..p0 (cols 0..6) then q0..q6
           (cols 7..13); the edge sits between cols 6 and 7.
    filter_len in {4, 6, 8, 14}.  The thresholds are ints, or (L,)
    tensors with one value per line (a stream batch's lines, each at its
    stream's level).  Returns filtered (L, 14) int32.
    Bit-exact with svt_aom_lpf_*_{4,6,8,14}_c and the highbd variants
    (thresholds/clamps scaled by bd-8)."""
    sh = bd - 8
    blimit = blimit << sh
    limit = limit << sh
    thresh = thresh << sh
    flat_th = 1 << sh
    x = lines.to(torch.int32)
    p = {i: x[:, 6 - i] for i in range(7)}
    q = {i: x[:, 7 + i] for i in range(7)}
    ad = lambda a, b: (a - b).abs()

    # ---- masks ----
    hev = (ad(p[1], p[0]) > thresh) | (ad(q[1], q[0]) > thresh)
    outer = ad(p[0], q[0]) * 2 + ad(p[1], q[1]) // 2 > blimit
    if filter_len == 4:
        mask = ~((ad(p[1], p[0]) > limit) | (ad(q[1], q[0]) > limit)
                 | outer)
    elif filter_len == 6:
        mask = ~((ad(p[2], p[1]) > limit) | (ad(p[1], p[0]) > limit)
                 | (ad(q[1], q[0]) > limit) | (ad(q[2], q[1]) > limit)
                 | outer)
    else:
        mask = ~((ad(p[3], p[2]) > limit) | (ad(p[2], p[1]) > limit)
                 | (ad(p[1], p[0]) > limit) | (ad(q[1], q[0]) > limit)
                 | (ad(q[2], q[1]) > limit) | (ad(q[3], q[2]) > limit)
                 | outer)

    # ---- filter4 (always computed; used where not flat) ----
    off = 128 << sh
    ps1, ps0 = p[1] - off, p[0] - off
    qs0, qs1 = q[0] - off, q[1] - off
    f = torch.where(hev, _sc(ps1 - qs1, sh), 0)
    f = torch.where(mask, _sc(f + 3 * (qs0 - ps0), sh), 0)
    f1 = _sc(f + 4, sh) >> 3
    f2 = _sc(f + 3, sh) >> 3
    fo = torch.where(hev, 0, (f1 + 1) >> 1)
    # out[c] is column c of the result (p6..p0 at 0..6, q0..q6 at 7..13)
    out = [x[:, c] for c in range(14)]
    out[5] = _sc(ps1 + fo, sh) + off
    out[6] = _sc(ps0 + f2, sh) + off
    out[7] = _sc(qs0 - f1, sh) + off
    out[8] = _sc(qs1 - fo, sh) + off
    if filter_len == 4:
        return torch.stack(out, dim=1)

    def put(c, wide, val):
        out[c] = torch.where(wide, val, out[c])

    if filter_len == 6:
        flat = ~((ad(p[1], p[0]) > flat_th) | (ad(q[1], q[0]) > flat_th)
                 | (ad(p[2], p[0]) > flat_th) | (ad(q[2], q[0]) > flat_th))
        wide = flat & mask
        put(5, wide, _r3(p[2] * 3 + p[1] * 2 + p[0] * 2 + q[0]))
        put(6, wide, _r3(p[2] + p[1] * 2 + p[0] * 2 + q[0] * 2 + q[1]))
        put(7, wide, _r3(p[1] + p[0] * 2 + q[0] * 2 + q[1] * 2 + q[2]))
        put(8, wide, _r3(p[0] + q[0] * 2 + q[1] * 2 + q[2] * 3))
        return torch.stack(out, dim=1)

    flat = ~((ad(p[1], p[0]) > flat_th) | (ad(q[1], q[0]) > flat_th)
             | (ad(p[2], p[0]) > flat_th) | (ad(q[2], q[0]) > flat_th)
             | (ad(p[3], p[0]) > flat_th) | (ad(q[3], q[0]) > flat_th))
    wide = flat & mask
    put(4, wide, _r3(p[3] * 3 + 2 * p[2] + p[1] + p[0] + q[0]))
    put(5, wide, _r3(p[3] * 2 + p[2] + 2 * p[1] + p[0] + q[0] + q[1]))
    put(6, wide, _r3(p[3] + p[2] + p[1] + 2 * p[0] + q[0] + q[1] + q[2]))
    put(7, wide, _r3(p[2] + p[1] + p[0] + 2 * q[0] + q[1] + q[2] + q[3]))
    put(8, wide, _r3(p[1] + p[0] + q[0] + 2 * q[1] + q[2] + q[3] * 2))
    put(9, wide, _r3(p[0] + q[0] + q[1] + 2 * q[2] + q[3] * 3))
    if filter_len == 8:
        return torch.stack(out, dim=1)

    # filter14: second flatness test over the wide support
    flat2 = ~((ad(p[4], p[0]) > flat_th) | (ad(q[4], q[0]) > flat_th)
              | (ad(p[5], p[0]) > flat_th) | (ad(q[5], q[0]) > flat_th)
              | (ad(p[6], p[0]) > flat_th) | (ad(q[6], q[0]) > flat_th))
    vwide = flat2 & flat & mask
    o = {}
    o[5] = _r4(p[6] * 7 + p[5] * 2 + p[4] * 2 + p[3] + p[2] + p[1] + p[0]
               + q[0])
    o[4] = _r4(p[6] * 5 + p[5] * 2 + p[4] * 2 + p[3] * 2 + p[2] + p[1]
               + p[0] + q[0] + q[1])
    o[3] = _r4(p[6] * 4 + p[5] + p[4] * 2 + p[3] * 2 + p[2] * 2 + p[1]
               + p[0] + q[0] + q[1] + q[2])
    o[2] = _r4(p[6] * 3 + p[5] + p[4] + p[3] * 2 + p[2] * 2 + p[1] * 2
               + p[0] + q[0] + q[1] + q[2] + q[3])
    o[1] = _r4(p[6] * 2 + p[5] + p[4] + p[3] + p[2] * 2 + p[1] * 2
               + p[0] * 2 + q[0] + q[1] + q[2] + q[3] + q[4])
    o[0] = _r4(p[6] + p[5] + p[4] + p[3] + p[2] + p[1] * 2 + p[0] * 2
               + q[0] * 2 + q[1] + q[2] + q[3] + q[4] + q[5])
    oq = {}
    oq[0] = _r4(p[5] + p[4] + p[3] + p[2] + p[1] + p[0] * 2 + q[0] * 2
                + q[1] * 2 + q[2] + q[3] + q[4] + q[5] + q[6])
    oq[1] = _r4(p[4] + p[3] + p[2] + p[1] + p[0] + q[0] * 2 + q[1] * 2
                + q[2] * 2 + q[3] + q[4] + q[5] + q[6] * 2)
    oq[2] = _r4(p[3] + p[2] + p[1] + p[0] + q[0] + q[1] * 2 + q[2] * 2
                + q[3] * 2 + q[4] + q[5] + q[6] * 3)
    oq[3] = _r4(p[2] + p[1] + p[0] + q[0] + q[1] + q[2] * 2 + q[3] * 2
                + q[4] * 2 + q[5] + q[6] * 4)
    oq[4] = _r4(p[1] + p[0] + q[0] + q[1] + q[2] + q[3] * 2 + q[4] * 2
                + q[5] * 2 + q[6] * 5)
    oq[5] = _r4(p[0] + q[0] + q[1] + q[2] + q[3] + q[4] * 2 + q[5] * 2
                + q[6] * 7)
    for i in range(6):
        put(6 - i, vwide, o[i])
        put(7 + i, vwide, oq[i])
    return torch.stack(out, dim=1)


def loop_filter_plane_uniform(plane: torch.Tensor, step: int, level: int,
                              sharpness: int, filter_len: int, bd: int = 8
                              ) -> torch.Tensor:
    """Filter a plane whose tx/block grid is uniform with pitch ``step``
    (luma step 16 / len 14, chroma step 8 / len 6).  Returns a new int32
    plane on the plane's device (the input is not modified); level 0
    returns the input.

    Vertical edges first (spec order), then horizontal."""
    if level == 0:
        return plane
    blimit, limit, thresh = loop_filter_thresholds(level, sharpness)
    h, w = plane.shape
    x = plane.to(torch.int32, copy=True)
    taps = torch.arange(-7, 7, device=x.device)

    # vertical edges at columns step, 2*step, ...  Writes add deltas with
    # index_add_ (an accumulating scatter): gather windows are 14 wide
    # while chroma edges sit 8 apart, so neighbouring windows overlap and
    # an indexed assignment would write one window's stale copy over its
    # neighbour's filtered pixels (and which write wins is unordered on
    # CUDA).  The spec's flen <= spacing rule keeps the modified spans
    # disjoint, so at most one edge adds a nonzero delta to a pixel.
    edges = torch.arange(step, w, step, device=x.device)
    if len(edges):
        cols = edges[:, None] + taps[None]                  # (E, 14)
        lines = x[:, cols].permute(1, 0, 2).reshape(-1, 14)
        f = filter_lines(lines, blimit, limit, thresh, filter_len, bd)
        d = (f - lines).reshape(len(edges), h, 14).permute(1, 0, 2)
        x.index_add_(1, cols.reshape(-1), d.reshape(h, -1))

    # horizontal edges at rows step, 2*step, ..., gathered after the
    # vertical pass has landed
    redges = torch.arange(step, h, step, device=x.device)
    if len(redges):
        rows = redges[:, None] + taps[None]
        lines = x[rows, :].permute(0, 2, 1).reshape(-1, 14)
        f = filter_lines(lines, blimit, limit, thresh, filter_len, bd)
        d = (f - lines).reshape(len(redges), w, 14).permute(0, 2, 1)
        x.index_add_(0, rows.reshape(-1), d.reshape(-1, w))
    return x


# --------------------------------------------------------------------------
# mask-aware (mixed tx/block size) plane filtering
# --------------------------------------------------------------------------

def edge_flens(tx_ext, blk_ext, skip, is_luma: bool) -> torch.Tensor:
    """Per-mi filter length of the edge at each mi's leading (left for
    vertical / top for horizontal) boundary along one direction
    (set_lpf_parameters, deblocking_filter.c:160-280, with a uniform
    nonzero level).

    tx_ext / blk_ext: (..., n_r, n_c) transform / prediction-block
    extents along the direction in mi units (pass transposed maps, and
    transpose the result, for horizontal edges); skip: coded skip AND
    inter.  Leading axes (a stream batch) are independent maps.
    Returns (..., n_r, n_c) int32 in {0, 4, 6, 8, 14}; column 0 (the
    frame edge) is 0."""
    tx_ext = torch.as_tensor(tx_ext).to(torch.int32)
    blk_ext = torch.as_tensor(blk_ext, device=tx_ext.device).to(torch.int32)
    skip = torch.as_tensor(skip, device=tx_ext.device).to(torch.bool)
    c = torch.arange(tx_ext.shape[-1], dtype=torch.int32,
                     device=tx_ext.device)
    tx_edge = (c % tx_ext) == 0
    pu_edge = (c % blk_ext) == 0
    prev_tx = torch.cat([tx_ext[..., :1], tx_ext[..., :-1]], dim=-1)
    prev_skip = torch.cat([skip[..., :1], skip[..., :-1]], dim=-1)
    # both-skip (inter) edges filter only on a prediction-block boundary
    on = tx_edge & (~(skip & prev_skip) | pu_edge) & (c > 0)
    min_t = torch.minimum(tx_ext, prev_tx)
    if is_luma:
        flen = torch.where(min_t <= 1, 4, torch.where(min_t == 2, 8, 14))
    else:
        flen = torch.where(min_t <= 1, 4, 6)
    return torch.where(on, flen, 0).to(torch.int32)


def _filter_edges_masked(x, epos, flen_line, blimit, limit, thresh, lens,
                         bd):
    """Filter the vertical edges at column positions ``epos`` of an (h, w)
    plane, or of (S, h, w) planes, with per-line filter lengths (0 = off;
    flen_line (h, nE), or (S, h, nE)).  The thresholds are ints, or per
    line tensors (stream-major, see filter_lines).  Exact under overlap:
    only the span a filter modifies adds a nonzero delta, and the spec's
    flen <= min(tx extents) rule keeps modified spans of adjacent edges
    disjoint."""
    h, w = x.shape[-2:]
    dev = x.device
    cols = (torch.as_tensor(np.asarray(epos), device=dev)[None, :, None]
            + torch.arange(-7, 7, device=dev)[None, None, :]).clamp(0, w - 1)
    rows = torch.arange(h, device=dev)[:, None, None]
    ci = cols.expand(h, -1, -1)
    ri = rows.expand_as(ci)
    idx = (ri, ci)
    if x.dim() == 3:
        si = torch.arange(x.shape[0], device=dev)[:, None, None, None]
        idx = (si.expand((x.shape[0],) + ci.shape), ri.expand(
            (x.shape[0],) + ci.shape), ci.expand((x.shape[0],) + ci.shape))
    lines = x[idx]                             # (..., h, nE, 14)
    flat = lines.reshape(-1, 14)
    sel = flen_line.reshape(-1, 1)
    out = flat
    for fl in lens:
        out = torch.where(sel == fl, filter_lines(flat, blimit, limit,
                                                  thresh, fl, bd), out)
    delta = (out - flat).reshape(lines.shape)
    x = x.clone()
    x.index_put_(idx, delta, accumulate=True)
    return x


def loop_filter_plane_masked(plane, flen_v, flen_h, level: int,
                             sharpness: int, is_luma: bool, bd: int = 8,
                             mi: int = 4) -> torch.Tensor:
    """Mask-aware plane deblock for mixed tx/block sizes.

    flen_v / flen_h: (h//mi, w//mi) per-mi filter lengths of the vertical
    edge at each mi's left boundary / the horizontal edge at its top
    (edge_flens), on the plane's device.  Vertical edges first over the
    whole plane, then horizontal (spec order).  Returns a new int32
    plane; level 0 returns the input."""
    if level == 0:
        return plane
    blimit, limit, thresh = loop_filter_thresholds(level, sharpness)
    lens = (4, 8, 14) if is_luma else (4, 6)
    x = plane.to(torch.int32)
    n_r, n_c = flen_v.shape
    epos_v = np.arange(1, n_c) * mi
    if len(epos_v):
        fl = flen_v[:, 1:].repeat_interleave(mi, 0)
        x = _filter_edges_masked(x, epos_v, fl, blimit, limit, thresh, lens,
                                 bd)
    epos_h = np.arange(1, n_r) * mi
    if len(epos_h):
        fl = flen_h[1:, :].repeat_interleave(mi, 1).T
        x = _filter_edges_masked(x.T.contiguous(), epos_h, fl, blimit,
                                 limit, thresh, lens, bd).T.contiguous()
    return x
