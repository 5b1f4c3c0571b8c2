"""Loop restoration filters, the PyTorch port of
svt_av1_tpu/ops/restoration.py: the Wiener filter (AV1 spec 7.17.4) and
the self-guided filter with its projection (7.17.3), batched over
restoration windows.

Behavioral reference: convolve.c svt_av1_wiener_convolve_add_src_c and
restoration.c svt_av1_selfguided_restoration_c /
svt_apply_selfguided_restoration_c.  Normative, so exact: every step is
int32 arithmetic as in the reference (``>>`` is arithmetic on negative
values in torch as in jnp), the table lookups index with long tensors,
and the one product that can pass 2^31 (``p * s`` in ``_sgr_ab``) is
split at 12 bits as the reference splits it.

Each window of a batch is filtered on its own: the self-guided r0
filter's even / odd rows count from the window's first row, so windows
of different restoration chunks must never be stacked along rows.  A
batch may pad its windows to a common (h, w) at the bottom and right: an
output sample reads only the window rows and columns within 3 of it
(the Wiener filter's 8th tap, which reads one more, is 0), so the first
h x w outputs of a padded window equal the unpadded window's.
"""
from __future__ import annotations

import functools
import os

import numpy as np
import torch

FILTER_BITS = 7
WIENER_ROUND0 = 3
WIENER_ROUND1 = 2 * FILTER_BITS - WIENER_ROUND0

SGRPROJ_SGR = 256
SGRPROJ_RST_BITS = 4
SGRPROJ_PRJ_BITS = 7
SGRPROJ_SGR_BITS = 8
SGRPROJ_RECIP_BITS = 12
SGRPROJ_MTABLE_BITS = 20

_SGR_DATA = os.path.join(os.path.dirname(__file__), "..", "codec", "data",
                         "av1_sgr_tables.npz")


@functools.lru_cache(maxsize=1)
def _sgr_tables():
    return dict(np.load(_SGR_DATA))


@functools.lru_cache(maxsize=None)
def _x_by_xplus1_on(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(
        _sgr_tables()["x_by_xplus1"].astype(np.int32)).to(device)


def sgr_params(eps: int):
    """(r0, r1, s0, s1) of self-guided parameter set ``eps``."""
    return tuple(int(v) for v in _sgr_tables()["sgr_params"][eps])


def _rp2(x, n):
    return (x + (1 << (n - 1))) >> n


def wiener_filter(windows: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor,
                  w: int, h: int, bd: int = 8) -> torch.Tensor:
    """Apply the Wiener filter to a batch of restoration windows.

    windows: (B, h+6, w+7) source samples; output block origin maps to
             windows[:, 3, 3] (8 taps are read per position even though
             tap [7] is zero).
    fx, fy:  (B, 8) int32 filter taps (tap [3] is the center; [7] == 0).
    Returns (B, h, w) int32, bit-exact with
    svt_av1_wiener_convolve_add_src_c."""
    x = windows.to(torch.int32)
    fx = fx.to(torch.int32)
    fy = fy.to(torch.int32)
    b = x.shape[0]
    im_h = h + 6
    # horizontal: sum_k fx[k]*src[c+k] + (center << 7) + (1 << 14)
    acc = torch.zeros((b, im_h, w), dtype=torch.int32, device=x.device)
    for k in range(8):
        acc = acc + fx[:, k, None, None] * x[:, :im_h, k:k + w]
    acc = (acc + (x[:, :im_h, 3:3 + w] << FILTER_BITS)
           + (1 << (bd + FILTER_BITS - 1)))
    clamp_hi = (1 << (bd + FILTER_BITS - WIENER_ROUND0 + 1)) - 1
    im = torch.clamp(_rp2(acc, WIENER_ROUND0), 0, clamp_hi)
    # one zero pad row: the 8th (zero) tap still indexes a row
    im = torch.cat([im, torch.zeros((b, 1, w), dtype=torch.int32,
                                    device=x.device)], dim=1)
    # vertical: sum_k fy[k]*im[r+k] + (center << 7) - (1 << (8 + r1 - 1))
    acc2 = torch.zeros((b, h, w), dtype=torch.int32, device=x.device)
    for k in range(8):
        acc2 = acc2 + fy[:, k, None, None] * im[:, k:k + h, :]
    acc2 = (acc2 + (im[:, 3:3 + h, :] << FILTER_BITS)
            - (1 << (bd + WIENER_ROUND1 - 1)))
    return torch.clamp(_rp2(acc2, WIENER_ROUND1), 0, (1 << bd) - 1)


def _box_sum_full(x: torch.Tensor, r: int) -> torch.Tensor:
    """Full-window (2r+1)^2 sums over the trailing 2 dims, VALID region:
    (B, H, W) -> (B, H-2r, W-2r), exact int32 shifted adds."""
    n = 2 * r + 1
    acc = None
    for dy in range(n):
        row = x[:, dy:dy + x.shape[1] - 2 * r, :]
        acc = row if acc is None else acc + row
    out = None
    for dx in range(n):
        col = acc[:, :, dx:dx + x.shape[2] - 2 * r]
        out = col if out is None else out + col
    return out


def _sgr_ab(x: torch.Tensor, r: int, s: int, h: int, w: int, bd: int = 8):
    """A (blend factor) and B on the (h+2) x (w+2) grid around the unit
    (positions -1..h, -1..w) from the int32 3-pixel-border extended input
    (selfguided_restoration_internal's A/B stage)."""
    n = (2 * r + 1) * (2 * r + 1)
    sums = _box_sum_full(x, r)
    sq = _box_sum_full(x * x, r)
    # center (-1,-1) is at ext coords (2,2) => box grid (2-r, 2-r)
    o = 2 - r
    bsum = sums[:, o:o + h + 2, o:o + w + 2]
    asum = sq[:, o:o + h + 2, o:o + w + 2]
    a = (asum + ((1 << (2 * (bd - 8))) >> 1)) >> (2 * (bd - 8)) \
        if bd > 8 else asum
    b = (bsum + ((1 << (bd - 8)) >> 1)) >> (bd - 8) if bd > 8 else bsum
    p = torch.clamp(a * n - b * b, min=0)
    # z = round_pow2(p * s, 20) exactly, with p*s possibly > 2^31:
    # split p at 12 bits
    th = p >> 12
    tl = p & 0xFFF
    hh = th * s
    ll = tl * s + (1 << (SGRPROJ_MTABLE_BITS - 1))
    z = (hh >> 8) + ((((hh & 255) << 12) + ll) >> SGRPROJ_MTABLE_BITS)
    A = _x_by_xplus1_on(x.device)[torch.clamp(z, max=255).long()]
    one_by_x = int(_sgr_tables()["one_by_x"][n - 1])
    B = (((SGRPROJ_SGR - A) * bsum * one_by_x)
         + (1 << (SGRPROJ_RECIP_BITS - 1))) >> SGRPROJ_RECIP_BITS
    return A, B


def selfguided_restoration(dgd_ext: torch.Tensor, eps: int, h: int, w: int,
                           bd: int = 8):
    """Self-guided filters flt0 (r0, "fast" half-rate rows) and flt1 (r1)
    for a batch of restoration windows.

    dgd_ext: (B, h+6, w+6) (3-pixel border each side; origin at
    [:, 3, 3]).  Returns (flt0, flt1) each (B, h, w) int32 (zeros where
    the radius is 0).  Bit-exact with svt_av1_selfguided_restoration_c."""
    r0, r1, s0, s1 = sgr_params(eps)
    dgd = dgd_ext.to(torch.int32)
    center = dgd[:, 3:3 + h, 3:3 + w]
    flt0 = torch.zeros_like(center)
    flt1 = torch.zeros_like(center)

    if r0 > 0:
        A, B = _sgr_ab(dgd, r0, s0, h, w, bd)   # grid rows -1..h

        def cross(g, rows):
            # columns of g are grid cols -1..w; center j = col j+1
            g = g[:, rows]
            return g[:, :, 1:w + 1], g[:, :, 0:w] + g[:, :, 2:w + 2]

        def even(g):
            # even output rows i read grid rows i and i+2 (image rows i-1
            # and i+1)
            mu, su = cross(g, slice(0, h))
            md, sd = cross(g, slice(2, h + 2))
            return (mu + md) * 6 + (su + sd) * 5

        def odd(g):
            # odd rows read their own row (grid i+1)
            m, s = cross(g, slice(1, h + 1))
            return m * 6 + s * 5

        sh_e = SGRPROJ_SGR_BITS + 5 - SGRPROJ_RST_BITS
        sh_o = SGRPROJ_SGR_BITS + 4 - SGRPROJ_RST_BITS
        f_e = _rp2(even(A) * center + even(B), sh_e)
        f_o = _rp2(odd(A) * center + odd(B), sh_o)
        # rows count from the window's first row
        evm = (torch.arange(h, device=dgd.device) % 2 == 0)[None, :, None]
        flt0 = torch.where(evm, f_e, f_o)

    if r1 > 0:
        A, B = _sgr_ab(dgd, r1, s1, h, w, bd)

        def nine(g):
            c = g[:, 1:h + 1, 1:w + 1]
            u = g[:, 0:h, 1:w + 1]
            d = g[:, 2:h + 2, 1:w + 1]
            l = g[:, 1:h + 1, 0:w]
            r_ = g[:, 1:h + 1, 2:w + 2]
            ul = g[:, 0:h, 0:w]
            ur = g[:, 0:h, 2:w + 2]
            dl = g[:, 2:h + 2, 0:w]
            dr = g[:, 2:h + 2, 2:w + 2]
            return (c + u + d + l + r_) * 4 + (ul + ur + dl + dr) * 3

        sh = SGRPROJ_SGR_BITS + 5 - SGRPROJ_RST_BITS
        flt1 = _rp2(nine(A) * center + nine(B), sh)

    return flt0, flt1


def decode_xq(eps: int, xqd0: torch.Tensor, xqd1: torch.Tensor):
    """The projection weights (xq0, xq1) from the signaled (xqd0, xqd1)
    (spec decode_xq), each shaped like its input."""
    r0, r1 = sgr_params(eps)[:2]
    if r0 == 0:
        return torch.zeros_like(xqd0), (1 << SGRPROJ_PRJ_BITS) - xqd1
    if r1 == 0:
        return xqd0, torch.zeros_like(xqd1)
    return xqd0, (1 << SGRPROJ_PRJ_BITS) - xqd0 - xqd1


def project(dat: torch.Tensor, flt0: torch.Tensor, flt1: torch.Tensor,
            eps: int, xq0: torch.Tensor, xq1: torch.Tensor,
            bd: int = 8) -> torch.Tensor:
    """The self-guided projection of (B, h, w) samples ``dat`` with the
    filters' outputs and per-window weights xq0 / xq1 (B,)."""
    r0, r1 = sgr_params(eps)[:2]
    u = dat.to(torch.int32) << SGRPROJ_RST_BITS
    v = u << SGRPROJ_PRJ_BITS
    if r0 > 0:
        v = v + xq0.to(torch.int32)[:, None, None] * (flt0 - u)
    if r1 > 0:
        v = v + xq1.to(torch.int32)[:, None, None] * (flt1 - u)
    wv = _rp2(v, SGRPROJ_PRJ_BITS + SGRPROJ_RST_BITS)
    return torch.clamp(wv, 0, (1 << bd) - 1)


def apply_selfguided(dat_ext: torch.Tensor, eps: int, xqd0, xqd1,
                     h: int, w: int, bd: int = 8) -> torch.Tensor:
    """Full SGR restoration: filters + projection (spec 7.17.3;
    svt_apply_selfguided_restoration_c).  xqd0 / xqd1: (B,) int32 signaled
    projection parameters."""
    flt0, flt1 = selfguided_restoration(dat_ext, eps, h, w, bd)
    xq0, xq1 = decode_xq(eps, torch.as_tensor(xqd0, device=dat_ext.device),
                         torch.as_tensor(xqd1, device=dat_ext.device))
    return project(dat_ext[:, 3:3 + h, 3:3 + w], flt0, flt1, eps, xq0, xq1,
                   bd)
