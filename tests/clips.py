"""Synthetic test pictures for the port's tests and chip_smoke.py, made
from a seed with numpy only (so they also exist where JAX is not
installed).

``natural_clip`` is the bench's clip shape: moving sinusoids plus noise.
``screen_frame`` is screen content: flat colored rectangles and text-like
two-color bars, so that many 16x16 blocks hold 2-8 distinct luma values
and the palette candidates exist.
"""
import numpy as np


def natural_clip(n, w, h, seed=0, chroma_noise=True):
    """n frames [(y, u, v)] uint8 4:2:0 of smooth moving pattern + noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for t in range(n):
        y = (96 + 60 * np.sin(xx / 17.0 + t * 0.13)
             + 50 * np.cos(yy / 23.0 + t * 0.02)
             + rng.integers(-5, 6, (h, w)))
        u = 128 + 40 * np.sin(xx[::2, ::2] / 31.0 + t * 0.05)
        if chroma_noise:
            u = u + rng.integers(-3, 4, (h // 2, w // 2))
        v = 128 + 40 * np.cos(yy[::2, ::2] / 29.0)
        out.append(tuple(np.clip(p, 0, 255).astype(np.uint8)
                         for p in (y, u, v)))
    return out


def screen_frame(w, h, seed=0):
    """One (y, u, v) uint8 4:2:0 screen-content picture: a flat
    background, flat rectangles on even coordinates (each with its own
    luma and chroma), and bands of text-like bars (two luma values,
    glyph-sized runs)."""
    rng = np.random.default_rng(seed)
    y = np.full((h, w), 235, np.uint8)
    u = np.full((h // 2, w // 2), 128, np.uint8)
    v = np.full((h // 2, w // 2), 128, np.uint8)
    for _ in range(max(3, (w * h) // 2048)):
        x0 = 2 * int(rng.integers(0, w // 2 - 4))
        y0 = 2 * int(rng.integers(0, h // 2 - 4))
        x1 = min(w, x0 + 2 * int(rng.integers(4, max(5, w // 4))))
        y1 = min(h, y0 + 2 * int(rng.integers(4, max(5, h // 4))))
        y[y0:y1, x0:x1] = rng.integers(16, 236)
        u[y0 // 2:y1 // 2, x0 // 2:x1 // 2] = rng.integers(64, 192)
        v[y0 // 2:y1 // 2, x0 // 2:x1 // 2] = rng.integers(64, 192)
    # text: rows of glyphs, each a random 5x7 dot pattern in the ink color
    for ty in range(4, h - 10, 22):
        ink = int(rng.integers(0, 60))
        for tx in range(3, w - 7, 7):
            if rng.random() < 0.15:
                continue                    # a space
            glyph = rng.random((7, 5)) < 0.55
            blk = y[ty:ty + 7, tx:tx + 5]
            blk[glyph] = ink
    return y, u, v
