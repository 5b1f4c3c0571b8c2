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

from svt_av1_tpu_torch.codec import lr as lr_mod
from svt_av1_tpu_torch.ops import restoration as rst

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


def _wiener_stats(dgd: np.ndarray, src: np.ndarray, y0: int, x0: int,
                  h: int, w: int, win: int):
    """Exact auto/cross-correlation stats for the separable Wiener solve
    (restoration_pick.c svt_av1_compute_stats semantics: means removed,
    windows read the edge-extended degraded frame).  Returns
    (H (win²,win²), M (win²,)) as one BLAS Gram product."""
    half = win // 2
    pad = np.pad(dgd, half, mode="edge").astype(np.float64)
    avg = dgd[y0:y0 + h, x0:x0 + w].astype(np.float64).mean()
    s = (src[y0:y0 + h, x0:x0 + w].astype(np.float64) - avg).reshape(-1)
    cols = []
    for k in range(win):
        for l in range(win):
            cols.append((pad[y0 + k:y0 + k + h, x0 + l:x0 + l + w]
                         - avg).reshape(-1))
    Y = np.stack(cols, axis=1)            # (h*w, win*win)
    return Y.T @ Y, Y.T @ s

def _solve_wiener(dgd: np.ndarray, src: np.ndarray, y0: int, x0: int,
                  h: int, w: int, chroma: bool):
    """Alternating separable Wiener solve with symmetric, sum-one taps;
    returns quantized (vfilter3, hfilter3) or None if degenerate."""
    win = 5 if chroma else 7
    half = win // 2
    Hm, Mv = _wiener_stats(dgd, src, y0, x0, h, w, win)
    H4 = Hm.reshape(win, win, win, win)   # [k, l, k2, l2]
    M2 = Mv.reshape(win, win)             # [k, l]

    a = np.zeros(win)
    b = np.zeros(win)
    a[:] = 1.0 / win
    b[:] = 1.0 / win

    def solve_half(other, vert: bool):
        """LS for symmetric taps u0..u_{half-1}, center = 1 - 2*sum(u)."""
        if vert:
            # unknown over k: G[k,k2] = sum_{l,l2} b_l b_l2 H[k,l,k2,l2]
            G = np.einsum("l,m,klxm->kx", other, other, H4)
            cvec = M2 @ other
        else:
            G = np.einsum("l,m,lkmx->kx", other, other, H4)
            cvec = other @ M2
        nh = half
        A = np.zeros((nh, nh))
        rhs = np.zeros(nh)
        # basis vectors: e_i = delta_i + delta_{win-1-i} - 2*delta_half
        # around the base point a0 = delta_half (center tap 1)
        base_vec = np.zeros(win)
        base_vec[half] = 1.0
        basis = []
        for i in range(nh):
            e = np.zeros(win)
            e[i] = 1.0
            e[win - 1 - i] = 1.0
            e[half] = -2.0
            basis.append(e)
        for i in range(nh):
            rhs[i] = basis[i] @ (cvec - G @ base_vec)
            for j in range(nh):
                A[i, j] = basis[i] @ G @ basis[j]
        try:
            u = np.linalg.solve(A, rhs)
        except np.linalg.LinAlgError:
            return None
        return base_vec + sum(u[i] * basis[i] for i in range(nh))

    for _ in range(10):
        nb = solve_half(a, vert=False)
        if nb is None:
            return None
        b = nb
        na = solve_half(b, vert=True)
        if na is None:
            return None
        a = na

    def quantize(t, chroma_):
        taps = []
        full = np.zeros(3)
        if chroma_:
            full[0] = 0.0
            full[1] = t[0]
            full[2] = t[1]
        else:
            full[:] = t[:3]
        for i in range(3):
            minv, maxv, _, _ = lr_mod.WIENER_TAPS[i]
            q = int(np.clip(round(full[i] * 128), minv, maxv))
            taps.append(q)
        if chroma_:
            taps[0] = 0
        return tuple(taps)

    vf = quantize(a[:3] if not chroma else a[:2], chroma)
    hf = quantize(b[:3] if not chroma else b[:2], chroma)
    return vf, hf


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


def _masked_sse(a, b, valid):
    d = (a - b) * valid
    return (d * d).sum((1, 2), dtype=torch.int64)


def _per_unit(per_chunk: np.ndarray, unit: np.ndarray, n_units: int):
    """Sums over each unit's chunks (exact int64) of (..., B) values."""
    out = np.zeros(per_chunk.shape[:-1] + (n_units,), np.int64)
    for b, u in enumerate(unit):
        out[..., u] += per_chunk[..., b]
    return out


def _xq_from_sums(sums, r0: int, r1: int) -> Tuple[int, int]:
    """_solve_xq of the reference (restoration_pick.c get_proj_subspace +
    encode_xq) from its five dot products (h00, h11, h01, c0, c1).  They
    are sums of integer products each under 2^26 (2^30 at 10 bits) over
    at most ~2^18 samples, so the int64 sums made on the device equal the
    reference's float64 ones exactly, whatever the order; the solve and round (half
    even) then run on the host as the reference's do."""
    h00, h11, h01, c0, c1 = (float(v) for v in sums)
    x0 = x1 = 0.0
    if r0 and r1:
        det = h00 * h11 - h01 * h01
        if abs(det) > 1e-8:
            x0 = (h11 * c0 - h01 * c1) / det
            x1 = (h00 * c1 - h01 * c0) / det
    elif r0:
        if h00 > 1e-8:
            x0 = c0 / h00
    elif r1:
        if h11 > 1e-8:
            x1 = c1 / h11
    q = 1 << 7  # SGRPROJ_PRJ_BITS
    xq0 = int(round(x0 * q))
    xq1 = int(round(x1 * q))
    if not r0:
        xqd0 = 0
        xqd1 = int(np.clip(q - xq1, lr_mod.SGRPROJ_PRJ_MIN1,
                           lr_mod.SGRPROJ_PRJ_MAX1))
    elif not r1:
        xqd0 = int(np.clip(xq0, lr_mod.SGRPROJ_PRJ_MIN0,
                           lr_mod.SGRPROJ_PRJ_MAX0))
        xqd1 = int(np.clip(q - xqd0, lr_mod.SGRPROJ_PRJ_MIN1,
                           lr_mod.SGRPROJ_PRJ_MAX1))
    else:
        xqd0 = int(np.clip(xq0, lr_mod.SGRPROJ_PRJ_MIN0,
                           lr_mod.SGRPROJ_PRJ_MAX0))
        xqd1 = int(np.clip(q - xqd0 - xq1, lr_mod.SGRPROJ_PRJ_MIN1,
                           lr_mod.SGRPROJ_PRJ_MAX1))
    return xqd0, xqd1


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


def search_lr(src: Dict[str, np.ndarray],
              cdef_recon: Dict[str, torch.Tensor],
              deblocked: Dict[str, torch.Tensor],
              lr_info: List[lr_mod.PlaneLrInfo], bd: int = 8,
              eps_set=tuple(range(16))) -> None:
    """Fill lr_info's units: per restoration unit the candidate of least
    SSE against ``src`` (host planes) among RESTORE_NONE, self-guided
    with each parameter set of ``eps_set`` (its projection solved by
    least squares) and Wiener (taps from the reference's alternating
    solve), in that order, the first minimum winning (the reference's
    strict ``<``).

    Per plane, the filters of every parameter set run on all the plane's
    chunks in one batch each; one copy brings the projection sums to the
    host, one the candidates' SSEs.  The Wiener solve is the reference's
    float64 numpy code on a host copy of the CDEF plane (its mean removal
    and alternating solves depend on the order of float sums, so it runs
    where and as the reference runs it).  Every SSE is an exact int64
    sum, so the choice does not depend on the batch."""
    heights = _heights(cdef_recon)
    for plane_idx, name in enumerate(("y", "u", "v")):
        info = lr_info[plane_idx]
        if info.frame_type == lr_mod.RESTORE_NONE:
            continue
        plane, deb = cdef_recon[name], deblocked[name]
        dev = plane.device
        H, W = plane.shape
        ss = 1 if plane_idx else 0
        pl = _plan(H, W, info.unit_size, ss, heights)
        rows, cols, crow, ccol, valid = _plan_on(H, W, info.unit_size, ss,
                                                 heights, dev)
        sp = np.asarray(src[name]).astype(np.int32)
        src_t = torch.from_numpy(sp).to(dev)
        win = _windows(plane, deb, rows, cols)
        hm, wm = pl.hm, pl.wm
        dat = win[:, BORDER:BORDER + hm, BORDER:BORDER + wm]
        src_c = src_t[crow[:, :, None], ccol[:, None, :]]
        vmask = valid.to(torch.int32)
        u = dat << rst.SGRPROJ_RST_BITS
        d = ((src_c << rst.SGRPROJ_RST_BITS) - u) * vmask
        filt = []
        sums = []
        for eps in eps_set:
            f0, f1 = rst.selfguided_restoration(
                win[:, :, :wm + 2 * BORDER], eps, hm, wm, bd)
            f0d = (f0 - u) * vmask
            f1d = (f1 - u) * vmask
            sums.append(torch.stack(
                [(a * b).sum((1, 2), dtype=torch.int64)
                 for a, b in ((f0d, f0d), (f1d, f1d), (f0d, f1d), (f0d, d),
                              (f1d, d))], dim=-1))
            filt.append((f0, f1))
        # the projection sums per unit, then the host solve
        unit_sums = _per_unit(
            torch.stack(sums).transpose(1, 2).cpu().numpy(), pl.unit,
            len(pl.units))                      # (eps, 5, units)
        xqd = {}
        sse = []
        for k, eps in enumerate(eps_set):
            r0, r1 = rst.sgr_params(eps)[:2]
            xqd[eps] = [_xq_from_sums(unit_sums[k, :, j], r0, r1)
                        for j in range(len(pl.units))]
            q = torch.tensor([xqd[eps][j] for j in pl.unit],
                             dtype=torch.int32, device=dev)
            xq0, xq1 = rst.decode_xq(eps, q[:, 0], q[:, 1])
            res = rst.project(dat, *filt[k], eps, xq0, xq1, bd)
            sse.append(_masked_sse(res, src_c, vmask))
        del filt
        # Wiener: the reference's solve on host copies of the planes
        plane_h = plane.to(torch.int32).cpu().numpy()
        wf = [_solve_wiener(plane_h, sp, v0, x, uh, w, chroma=plane_idx > 0)
              for (_, _, v0, uh, x, w) in pl.units]
        wiener_units = [lr_mod.RestUnitInfo(
            rtype=lr_mod.RESTORE_WIENER, wiener=lr_mod.WienerInfo(f[0], f[1]))
            if f is not None else None for f in wf]
        has_w = [u is not None for u in wiener_units]
        sse_w = torch.zeros(pl.n, dtype=torch.int64, device=dev)
        if any(has_w):
            taps = torch.from_numpy(_wiener_taps(
                [wiener_units[j] or lr_mod.RestUnitInfo(
                    wiener=lr_mod.WienerInfo()) for j in pl.unit])).to(dev)
            res = rst.wiener_filter(win, taps[:, 0], taps[:, 1], wm, hm, bd)
            sse_w = _masked_sse(res, src_c, vmask)
        all_sse = _per_unit(torch.stack(
            [_masked_sse(dat, src_c, vmask)] + sse + [sse_w]).cpu().numpy(),
            pl.unit, len(pl.units))             # (1 + eps + 1, units)
        for j, (ur, uc, *_) in enumerate(pl.units):
            best = (all_sse[0, j], lr_mod.RestUnitInfo())
            for k, eps in enumerate(eps_set):
                if all_sse[1 + k, j] < best[0]:
                    best = (all_sse[1 + k, j], lr_mod.RestUnitInfo(
                        rtype=lr_mod.RESTORE_SGRPROJ,
                        sgrproj=lr_mod.SgrprojInfo(eps, xqd[eps][j])))
            if has_w[j] and all_sse[-1, j] < best[0]:
                best = (all_sse[-1, j], wiener_units[j])
            info.units[ur][uc] = best[1]
