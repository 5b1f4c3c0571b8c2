"""Quality metrics: PSNR + SSIM (behavioral reference: svt_psnr.c,
packetization_process.c svt_aom_ssim_calculations / aom_ssim2 — 8x8
windows sampled on a 4-pel grid, integer-derived constants)."""
from __future__ import annotations

import numpy as np

_CC1 = 26634.0   # (64^2*(.01*255)^2)
_CC2 = 239708.0  # (64^2*(.03*255)^2)
_CC1_10 = 428658.0
_CC2_10 = 3857925.0


def psnr(a: np.ndarray, b: np.ndarray, bd: int = 8) -> float:
    peak = float((1 << bd) - 1)
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    if mse <= 0:
        return 99.0
    return float(10.0 * np.log10(peak * peak / mse))


def _windows(x: np.ndarray) -> np.ndarray:
    """All 8x8 windows on a 4-pel grid: (n, 64) float64."""
    h, w = x.shape
    ys = np.arange(0, h - 7, 4)
    xs = np.arange(0, w - 7, 4)
    out = np.empty((len(ys) * len(xs), 64), np.float64)
    i = 0
    for dy in ys:
        rows = x[dy:dy + 8]
        for dx in xs:
            out[i] = rows[:, dx:dx + 8].reshape(-1)
            i += 1
    return out


def ssim(a: np.ndarray, b: np.ndarray, bd: int = 8) -> float:
    """aom_ssim2-equivalent mean SSIM over 8x8 windows, 4-pel stride."""
    count = 64.0
    if bd == 8:
        c1 = _CC1 * count * count / 4096.0
        c2 = _CC2 * count * count / 4096.0
    else:
        c1 = _CC1_10 * count * count / 4096.0
        c2 = _CC2_10 * count * count / 4096.0
    s = _windows(a.astype(np.float64))
    r = _windows(b.astype(np.float64))
    sum_s = s.sum(axis=1)
    sum_r = r.sum(axis=1)
    sum_sq_s = (s * s).sum(axis=1)
    sum_sq_r = (r * r).sum(axis=1)
    sum_sxr = (s * r).sum(axis=1)
    n = ((2 * sum_s * sum_r + c1)
         * (2 * count * sum_sxr - 2 * sum_s * sum_r + c2))
    d = ((sum_s ** 2 + sum_r ** 2 + c1)
         * (count * sum_sq_s - sum_s ** 2
            + count * sum_sq_r - sum_r ** 2 + c2))
    return float(np.mean(n / d))


def frame_stats(src, recon, bd: int = 8) -> dict:
    """Per-frame stat report (the --enable-stat-report analog)."""
    out = {}
    for p in ("y", "u", "v"):
        if p in src and p in recon:
            h = min(src[p].shape[0], recon[p].shape[0])
            w = min(src[p].shape[1], recon[p].shape[1])
            out[f"psnr_{p}"] = psnr(src[p][:h, :w], recon[p][:h, :w], bd)
    out["ssim_y"] = ssim(src["y"][:recon["y"].shape[0],
                                  :recon["y"].shape[1]],
                         recon["y"], bd)
    return out
