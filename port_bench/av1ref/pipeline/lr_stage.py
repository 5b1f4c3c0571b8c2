"""Loop-restoration frame stage, the PyTorch port of
svt_av1_tpu/pipeline/lr_stage.py: the stripe-based normative apply and the
encoder's per-unit search (RESTORE_NONE, self-guided with each parameter
set, Wiener).  Single tile.

Behavioral reference: restoration.c (svt_av1_loop_restoration_filter_
frame, setup_processing_stripe_boundary, save_tile_row_boundary_lines)
and restoration_pick.c (get_proj_subspace / encode_xq).

The frame splits into 64-row processing stripes offset by 8 (chroma:
32/4); each stripe's 3 rows of vertical context come from the DEBLOCKED
frame (2 saved rows, outer one duplicated), while the frame top/bottom
use edge replication of the CDEF output.  Horizontal context is edge
replication of the CDEF frame rows themselves.

The host geometry (save_boundaries, _stripe_chunks, _unit_ranges,
_v_ranges) and the Wiener tap solve (_wiener_stats, _solve_wiener) are
the reference's numpy code, copied by name.  The planes stay on the
device: each chunk's window is one gather from the CDEF plane stacked on
the deblocked plane, through row and column index maps built once per
frame geometry on the host (save_boundaries run over planes that hold
their own row numbers gives the substituted rows), and the filters run
batched over every chunk of a plane (ops/restoration.py).
"""
from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import numpy as np
import torch

from av1ref.codec import lr as lr_mod
from av1ref.ops import restoration as rst

STRIPE = 64
OFFSET = 8
CTX_VERT = 2
BORDER = 3


def save_boundaries(deblocked: Dict[str, np.ndarray]) -> Dict:
    """Per-plane saved stripe-boundary rows from the deblocked frame."""
    out = {}
    for plane, ss in (("y", 0), ("u", 1), ("v", 1)):
        p = np.asarray(deblocked[plane]).astype(np.int32)
        H = p.shape[0]
        sh = STRIPE >> ss
        off = OFFSET >> ss
        above = {}
        below = {}
        k = 0
        while True:
            y0 = max(0, k * sh - off)
            if y0 >= H:
                break
            y1 = min((k + 1) * sh - off, H)
            if k > 0:
                above[k] = p[y0 - CTX_VERT:y0].copy()
            if y1 < H:
                below[k] = p[y1:y1 + CTX_VERT].copy()
            k += 1
        out[plane] = (above, below)
    return out

def _stripe_chunks(v_start: int, v_end: int, H: int, ss: int):
    """Chunks of a restoration unit aligned to processing stripes:
    yields (y, h, copy_above, copy_below, stripe_index)."""
    sh = STRIPE >> ss
    off = OFFSET >> ss
    y = v_start
    while y < v_end:
        stripe = (y + off) // sh
        nominal = sh - (off if stripe == 0 else 0)
        h = min(nominal, v_end - y)
        copy_above = y != 0
        copy_below = (y + nominal) < H
        yield y, h, copy_above, copy_below, stripe
        y += h

def _unit_ranges(length: int, unit: int) -> List[Tuple[int, int]]:
    """RU spans along one axis (last unit absorbs < unit/2 remainder)."""
    out = []
    x = 0
    while x < length:
        rem = length - x
        w = rem if rem < unit * 3 // 2 else unit
        out.append((x, w))
        x += w
    return out

def _v_ranges(length: int, unit: int, ss: int) -> List[Tuple[int, int]]:
    """Vertical RU spans, shifted up by the stripe offset."""
    off = OFFSET >> ss
    spans = _unit_ranges(length, unit)
    out = []
    for i, (y, h) in enumerate(spans):
        v0 = max(0, y - off)
        v1 = y + h - (off if (y + h) < length else 0)
        out.append((v0, v1 - v0))
    return out


# -- the device side: windows by index maps, batched filters ---------------

def _boundary_index(heights: Tuple[int, int, int]):
    """Per plane (above, below): the deblocked-plane row of every saved
    stripe-boundary row, from save_boundaries over planes that hold their
    own row numbers."""
    rows = {p: np.arange(h)[:, None] for p, h in zip("yuv", heights)}
    bounds = save_boundaries(rows)
    return {p: ({k: v[:, 0] for k, v in above.items()},
                {k: v[:, 0] for k, v in below.items()})
            for p, (above, below) in bounds.items()}


class _Plan:
    """The restoration chunks of one plane (per unit, the unit's pieces in
    separate processing stripes) with their window index maps, padded to
    the plane's largest chunk (hm, wm):

      rows (B, hm+6): rows of cat(cdef plane, deblocked plane) that form
        each window (the stripe-boundary rows substituted, as _window in
        the reference does, the frame's top and bottom edge-replicated);
      cols (B, wm+7): the edge-replicated columns (the Wiener window reads
        one more than the self-guided one);
      crow (B, hm), ccol (B, wm): the chunk's own samples; valid (B, hm,
        wm) marks them; unit (B,): the chunk's unit, ur * cols + uc."""

    def __init__(self, H: int, W: int, unit_size: int, ss: int, bidx):
        above, below = bidx
        chunks = []
        self.units = []
        for ur, (v0, uh) in enumerate(_v_ranges(H, unit_size, ss)):
            for uc, (x, w) in enumerate(_unit_ranges(W, unit_size)):
                self.units.append((ur, uc, v0, uh, x, w))
                for (y, h, ca, cb, stripe) in _stripe_chunks(v0, v0 + uh, H,
                                                             ss):
                    chunks.append((len(self.units) - 1, y, h, x, w, ca, cb,
                                   stripe))
        hm = max(c[2] for c in chunks)
        wm = max(c[4] for c in chunks)
        n = len(chunks)
        rows = np.zeros((n, hm + 2 * BORDER), np.int64)
        cols = np.zeros((n, wm + 2 * BORDER + 1), np.int64)
        valid = np.zeros((n, hm, wm), bool)
        for b, (_, y, h, x, w, ca, cb, stripe) in enumerate(chunks):
            for i in range(-BORDER, hm + BORDER):
                ii = min(i, h + BORDER - 1)     # padding repeats the last
                if ii < 0 and ca:
                    r = H + above[stripe][max(ii + CTX_VERT, 0)]
                elif ii >= h and cb:
                    r = H + below[stripe][min(ii - h, CTX_VERT - 1)]
                else:
                    r = min(max(y + ii, 0), H - 1)
                rows[b, i + BORDER] = r
            cols[b] = np.clip(np.arange(x - BORDER, x + wm + BORDER + 1),
                              0, W - 1)
            valid[b, :h, :w] = True
        self.n, self.hm, self.wm = n, hm, wm
        self.unit = np.array([c[0] for c in chunks], np.int64)
        self.rows, self.cols, self.valid = rows, cols, valid
        self.crow = np.minimum(
            np.array([c[1] for c in chunks])[:, None] + np.arange(hm), H - 1)
        self.ccol = np.minimum(
            np.array([c[3] for c in chunks])[:, None] + np.arange(wm), W - 1)

    def on(self, device):
        """(rows, cols, crow, ccol, valid) as tensors on ``device``."""
        t = lambda a: torch.from_numpy(a).to(device)
        return (t(self.rows), t(self.cols), t(self.crow), t(self.ccol),
                t(self.valid))


@functools.lru_cache(maxsize=None)
def _plan(H: int, W: int, unit_size: int, ss: int, heights) -> _Plan:
    return _Plan(H, W, unit_size, ss,
                 _boundary_index(heights)["yuv"[min(ss, 1)]])


@functools.lru_cache(maxsize=None)
def _plan_on(H: int, W: int, unit_size: int, ss: int, heights, device):
    return _plan(H, W, unit_size, ss, heights).on(device)


def _heights(frame) -> Tuple[int, int, int]:
    return tuple(int(frame[p].shape[0]) for p in "yuv")


def _windows(plane, deb, rows, cols, sel=None):
    """(B, hm+6, wm+7) int32 windows of the chunks ``sel`` (all when
    None): one gather from the CDEF plane stacked on the deblocked one."""
    if sel is not None:
        rows, cols = rows[sel], cols[sel]
    ext = torch.cat([plane, deb], dim=0).to(torch.int32)
    return ext[rows[:, :, None], cols[:, None, :]]


def _wiener_taps(units) -> np.ndarray:
    """(B, 2, 8) int32 kernel taps (horizontal, vertical) per unit."""
    return np.array([[u.wiener.taps8(horiz=True), u.wiener.taps8(horiz=False)]
                     for u in units], np.int32).reshape(-1, 2, 8)


def apply_lr(cdef_recon: Dict[str, torch.Tensor],
             deblocked: Dict[str, torch.Tensor],
             lr_info: List[lr_mod.PlaneLrInfo], bd: int = 8
             ) -> Dict[str, torch.Tensor]:
    """The normative stripe-based restoration of every unit whose type is
    not RESTORE_NONE: windows from the CDEF planes with the deblocked
    planes' stripe-boundary rows, the Wiener chunks in one batch, the
    self-guided ones in one batch per parameter set, scattered into a
    copy of the plane.  Planes stay on their device and keep their
    dtype."""
    out_frame = dict(cdef_recon)
    heights = _heights(cdef_recon)
    for plane_idx, name in enumerate(("y", "u", "v")):
        info = lr_info[plane_idx]
        if info.frame_type == lr_mod.RESTORE_NONE:
            continue
        plane, deb = cdef_recon[name], deblocked[name]
        H, W = plane.shape
        ss = 1 if plane_idx else 0
        pl = _plan(H, W, info.unit_size, ss, heights)
        rows, cols, crow, ccol, valid = _plan_on(H, W, info.unit_size, ss,
                                                 heights, plane.device)
        units = [info.units[ur][uc] for (ur, uc, *_) in pl.units]
        kind = [units[u].rtype for u in pl.unit]
        groups = []
        sel = [b for b in range(pl.n) if kind[b] == lr_mod.RESTORE_WIENER]
        if sel:
            groups.append((sel, None))
        for eps in sorted({units[pl.unit[b]].sgrproj.ep for b in range(pl.n)
                           if kind[b] == lr_mod.RESTORE_SGRPROJ}):
            groups.append(([b for b in range(pl.n)
                            if kind[b] == lr_mod.RESTORE_SGRPROJ
                            and units[pl.unit[b]].sgrproj.ep == eps], eps))
        if not groups:
            continue
        out = plane.to(torch.int32).clone()
        flat = out.view(-1)
        for sel, eps in groups:
            idx = torch.as_tensor(sel, device=plane.device)
            win = _windows(plane, deb, rows, cols, idx)
            if eps is None:
                taps = torch.from_numpy(_wiener_taps(
                    [units[pl.unit[b]] for b in sel])).to(plane.device)
                res = rst.wiener_filter(win, taps[:, 0], taps[:, 1], pl.wm,
                                        pl.hm, bd)
            else:
                xqd = torch.tensor([units[pl.unit[b]].sgrproj.xqd
                                    for b in sel], dtype=torch.int32,
                                   device=plane.device)
                res = rst.apply_selfguided(win[:, :, :pl.wm + 2 * BORDER],
                                           eps, xqd[:, 0], xqd[:, 1], pl.hm,
                                           pl.wm, bd)
            v = valid[idx]
            pos = crow[idx][:, :, None] * W + ccol[idx][:, None, :]
            flat[pos[v]] = res[v]
        out_frame[name] = out.to(plane.dtype)
    return out_frame


