"""Film-grain noise-model estimation from source frames.

Behavioral reference: noise_model.c ``svt_aom_denoise_and_model_run``
(:2279): flat-block detection -> FFT-wiener denoise -> AR-coefficient
least-squares fit -> per-intensity scaling points.  TPU redesign: all
blocks of the frame are processed as ONE batch — plane fits are a
closed-form (fixed design matrix) einsum, the denoiser is a batched
``jnp.fft`` wiener shrinkage, and the AR normal equations accumulate
over every flat-block pixel in one pass.

The estimated FilmGrainParams feed the existing synthesis/signaling
path (codec/film_grain.py); optionally the denoised source replaces the
encoder input (the reference's film-grain-denoise=1 behavior).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from svt_av1_tpu_torch.codec.film_grain import (FilmGrainParams,
                                          _pred_positions,
                                          generate_grain_y)

BLK = 32          # flat-block / denoise tile size


def _blocks(plane: np.ndarray, n: int) -> np.ndarray:
    h, w = plane.shape
    gh, gw = h // n, w // n
    return (plane[:gh * n, :gw * n]
            .reshape(gh, n, gw, n).transpose(0, 2, 1, 3)
            .reshape(gh * gw, n, n))


def _plane_fit_residual(blocks: np.ndarray) -> Tuple[np.ndarray,
                                                     np.ndarray]:
    """LS plane fit per block; returns (residuals, gradient energy)."""
    n = blocks.shape[-1]
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float64)
    ones = np.ones((n, n))
    A = np.stack([ones.ravel(), xx.ravel(), yy.ravel()], axis=1)
    pinv = np.linalg.pinv(A)                       # (3, n*n)
    b = blocks.reshape(len(blocks), -1).astype(np.float64)
    coef = b @ pinv.T                              # (nb, 3)
    fit = coef @ A.T
    resid = (b - fit).reshape(blocks.shape)
    gx = np.abs(np.diff(blocks.astype(np.int32), axis=-1)).mean((1, 2))
    gy = np.abs(np.diff(blocks.astype(np.int32), axis=-2)).mean((1, 2))
    return resid, gx + gy


def find_flat_blocks(y: np.ndarray, n: int = BLK,
                     max_frac: float = 0.5) -> np.ndarray:
    """Flat-block mask (aom_flat_block_finder_run role): low plane-fit
    residual and low gradient; keeps at most max_frac of blocks."""
    blocks = _blocks(y, n)
    resid, grad = _plane_fit_residual(blocks)
    rvar = (resid ** 2).mean((1, 2))
    # gradient dominated by structure (edges) disqualifies; noise has
    # gradient ~ sigma but structure has much more
    score = rvar + 4.0 * grad ** 2
    k = max(1, int(len(blocks) * max_frac))
    thresh = np.partition(score, k - 1)[k - 1]
    flat = score <= thresh
    # absolute guard: blocks with huge residual are never "flat"
    flat &= rvar <= max(4.0 * np.median(rvar), 1e-3)
    return flat


def fft_denoise_blocks(blocks: np.ndarray) -> np.ndarray:
    """Batched FFT wiener shrinkage (denoise_and_model fft path): the
    noise floor is the median high-frequency magnitude; coefficients
    shrink by max(0, 1 - sigma2/|X|^2).

    Host numpy FFT by design: this analysis runs once per key frame on
    ~100 blocks — an XLA FFT pays a multi-second compile per batch
    shape for microseconds of work (the reference's fft_avx2 is the
    same host-side call)."""
    x = blocks.astype(np.float64)
    X = np.fft.fft2(x)
    mag2 = np.abs(X) ** 2
    n = blocks.shape[-1]
    # high-frequency quadrant estimates the white-noise PSD
    hf = mag2[:, n // 4: 3 * n // 4, n // 4: 3 * n // 4]
    sigma2 = np.median(hf.reshape(len(blocks), -1), axis=1)
    shrink = np.maximum(0.0, 1.0 - sigma2[:, None, None]
                        / np.maximum(mag2, 1e-6))
    return np.real(np.fft.ifft2(X * shrink))


def _ar_fit(noise_blocks: np.ndarray, lag: int) -> Tuple[np.ndarray,
                                                         float]:
    """Least-squares AR fit over flat-block noise; returns (float
    coeffs in _pred_positions order, innovation std)."""
    pos = _pred_positions(lag)
    npos = len(pos)
    n = noise_blocks.shape[-1]
    m = lag
    cols = []
    for (dy, dx) in pos:
        cols.append(noise_blocks[:, m + dy:n - m + dy,
                                 m + dx:n - m + dx].ravel())
    X = np.stack(cols, axis=1)                    # (ns, npos)
    t = noise_blocks[:, m:n - m, m:n - m].ravel()
    XtX = X.T @ X + 1e-6 * np.eye(npos)
    coef = np.linalg.solve(XtX, X.T @ t)
    resid = t - X @ coef
    return coef, float(resid.std())


def estimate_grain_params(y: np.ndarray, u: Optional[np.ndarray],
                          v: Optional[np.ndarray], bd: int = 8,
                          lag: int = 2,
                          denoise: bool = False
                          ) -> Tuple[Optional[FilmGrainParams],
                                     Optional[Dict[str, np.ndarray]]]:
    """Estimate AV1 film-grain parameters from one source frame.

    Returns (params, denoised) — params is None when the frame has no
    usable noise (estimation failed / clean source); denoised is the
    denoised source dict when denoise=True."""
    hi = (1 << bd) - 1
    ys = y.astype(np.float64)
    blocks = _blocks(ys, BLK)
    flat = find_flat_blocks(y, BLK)
    if not flat.any():
        return None, None
    den_blocks = fft_denoise_blocks(blocks[flat])
    noise = blocks[flat] - den_blocks
    sigma = float(noise.std())
    if sigma < 0.4:          # effectively clean content
        return None, None

    coef, _ = _ar_fit(noise, lag)
    shift = 6
    ar_y = np.clip(np.round(coef * (1 << shift)), -128, 127).astype(int)

    # per-intensity scaling: bin flat pixels by denoised intensity
    nbins = 8
    step = (hi + 1) // nbins
    intens = den_blocks.ravel()
    nz = noise.ravel()
    # grain process std per unit scaling: synthesize once with the
    # fitted AR coefficients and unit scaling to measure the gain
    p0 = FilmGrainParams(ar_coeff_lag=lag,
                         ar_coeffs_y=list(ar_y), ar_coeff_shift=shift,
                         scaling_points_y=[(0, 64), (255, 64)],
                         bit_depth=bd)
    g = generate_grain_y(p0).astype(np.float64)
    g_std = float(g.std())
    if g_std < 1e-3:
        return None, None
    pts = []
    for b in range(nbins):
        lo_v, hi_v = b * step, (b + 1) * step
        sel = (intens >= lo_v) & (intens < hi_v)
        if sel.sum() < 64:
            continue
        s_bin = float(nz[sel].std())
        # apply path: noise = grain * scaling(x) >> scaling_shift
        scale = int(np.clip(round(s_bin * (1 << 8) / g_std), 0, 255))
        pts.append((min(255, (lo_v + hi_v) // 2 >> (bd - 8)), scale))
    if len(pts) < 2:
        pts = [(0, int(np.clip(round(sigma * 256 / g_std), 0, 255)))] \
            + pts + [(255, int(np.clip(round(sigma * 256 / g_std),
                                       0, 255)))]
        pts = sorted(set(pts))[:2]
        if len(pts) < 2:
            pts = [(0, pts[0][1]), (255, pts[0][1])]

    # chroma: flat-region high-pass std (no AR structure estimated)
    def _chroma_pts(c):
        if c is None:
            return []
        cb = _blocks(c.astype(np.float64), BLK // 2)
        if not len(cb):
            return []
        s_c = float((cb - fft_denoise_blocks(cb)).std())
        sc = int(np.clip(round(s_c * 256 / g_std), 0, 255))
        return [(0, sc), (255, sc)] if sc > 1 else []

    params = FilmGrainParams(
        ar_coeff_lag=lag, ar_coeffs_y=list(ar_y), ar_coeff_shift=shift,
        scaling_points_y=pts,
        scaling_points_cb=_chroma_pts(u),
        scaling_points_cr=_chroma_pts(v),
        ar_coeffs_cb=[0] * (len(_pred_positions(lag)) + 1),
        ar_coeffs_cr=[0] * (len(_pred_positions(lag)) + 1),
        scaling_shift=8, bit_depth=bd)

    denoised = None
    if denoise:
        gh, gw = ys.shape[0] // BLK, ys.shape[1] // BLK
        all_den = np.asarray(fft_denoise_blocks(blocks))
        dy = (all_den.reshape(gh, gw, BLK, BLK).transpose(0, 2, 1, 3)
              .reshape(gh * BLK, gw * BLK))
        out_y = ys.copy()
        out_y[:gh * BLK, :gw * BLK] = dy
        dt = np.uint8 if bd == 8 else np.uint16
        denoised = dict(y=np.clip(np.round(out_y), 0, hi).astype(dt),
                        u=u, v=v)
    return params, denoised
