"""Synthetic test pictures for the port's tests and chip_smoke.py, made
from a seed with numpy only (so they also exist where JAX is not
installed).

``natural_clip`` is the bench's clip shape: moving sinusoids plus noise.
``screen_frame`` is screen content: flat colored rectangles and text-like
two-color bars, so that many 16x16 blocks hold 2-8 distinct luma values
and the palette candidates exist.  ``TOOL_CLIPS`` are the GOP clips that
code one compound or warp tool each; ``split_motion_clip`` is the
lookahead's clip (its key frames code delta-q).
"""
import contextlib

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


def _smooth(a):
    a = np.pad(a, 1, mode="edge")
    return ((a[:-2, :-2] + a[:-2, 1:-1] + a[:-2, 2:] + a[1:-1, :-2]
             + a[1:-1, 1:-1] + a[1:-1, 2:] + a[2:, :-2] + a[2:, 1:-1]
             + a[2:, 2:]) / 9)


def _two_scenes(h, w):
    rng = np.random.default_rng(5)
    return tuple(_smooth(rng.integers(0, 255, (h, w)).astype(np.float32))
                 .astype(np.uint8) for _ in range(2))


def wipe_clip(n=5, h=64, w=64):
    """The wedge clip of tests/test_wedge.py: scene B wipes over scene A
    from the left, 13 px a frame; flat chroma."""
    a, b = _two_scenes(h, w)
    out = []
    for t in range(n):
        y = a.copy()
        cut = min(w, 13 * t)
        y[:, :cut] = b[:, :cut]
        out.append((y, np.full((h // 2, w // 2), 120, np.uint8),
                    np.full((h // 2, w // 2), 135, np.uint8)))
    return out


def iris_clip(n=5, h=80, w=80):
    """The diffwtd clip of tests/test_wedge.py: scene B opens as a disc of
    radius 14 t px over scene A; flat chroma."""
    a, b = _two_scenes(h, w)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for t in range(n):
        y = a.copy()
        m = (yy - 40) ** 2 + (xx - 40) ** 2 <= (14 * t) ** 2
        y[m] = b[m]
        out.append((y, np.full((h // 2, w // 2), 120, np.uint8),
                    np.full((h // 2, w // 2), 135, np.uint8)))
    return out


def rotzoom_clip(n=5, h=96, w=128):
    """The zoom + rotate content of tests/test_warp.py as a clip: frame t
    is the smooth pattern seen through a zoom of 0.99^t and a rotation of
    0.004 t rad about the centre; flat chroma.  The global-motion fit
    finds a rotation-zoom model and codes warped blocks."""
    yy, xx = np.mgrid[0:h, 0:w]
    cy, cx = h / 2, w / 2
    out = []
    for t in range(n):
        s, th = 0.99 ** t, 0.004 * t
        ys = cy + (yy - cy) * s * np.cos(th) - (xx - cx) * s * np.sin(th)
        xs = cx + (yy - cy) * s * np.sin(th) + (xx - cx) * s * np.cos(th)
        y = (110 + 70 * np.sin(xs / 13.0) + 50 * np.cos(ys / 17.0)
             + 20 * np.sin((xs + ys) / 7.0))
        out.append((np.clip(np.rint(y), 0, 255).astype(np.uint8),
                    np.full((h // 2, w // 2), 120, np.uint8),
                    np.full((h // 2, w // 2), 135, np.uint8)))
    return out


def split_motion_clip(n=5, h=96, w=128, seed=1):
    """The natural clip with its left half held still: a fixed sinusoid
    plus noise there, the moving pattern on the right.  TPL finds the
    still superblocks far more referenced than the moving ones, so a key
    frame gets a non-uniform qindex map (delta-q); a frame of one 64x64
    superblock, or a uniformly moving one, gets a uniform map."""
    rng = np.random.default_rng(seed + 100)
    xx = np.mgrid[0:h, 0:w][1]
    still = np.clip(120 + 40 * np.sin(xx / 9.0)
                    + rng.integers(-3, 4, (h, w)), 0, 255).astype(np.uint8)
    out = []
    for y, u, v in natural_clip(n, w, h, seed=seed):
        y = y.copy()
        y[:, :w // 2] = still[:, :w // 2]
        out.append((y, u, v))
    return out


# the GOP clips that code one compound or warp tool each at M10
# (hierarchical_levels 2): name -> (frames, config fields, the tool)
TOOL_CLIPS = {
    "wipe": (wipe_clip, dict(qp=45, intra_period_length=31), "wedge"),
    "iris": (iris_clip, dict(qp=45, intra_period_length=31), "diffwtd"),
    "rotzoom": (rotzoom_clip, dict(qp=35, intra_period_length=4), "warp"),
}


@contextlib.contextmanager
def tool_setting(name, enc, gop_fast):
    """The setting of the reference's test for the clip ``name`` on the
    encoder ``enc`` (either package's) and its ``gop_fast`` module: the
    iris clip turns order hints off, so that skip mode does not out-RD
    the diffwtd blocks, and prices wedge out; the other clips change
    nothing."""
    old = gop_fast._WEDGE_EXTRA_BITS
    if name == "iris":
        enc.sp.enable_order_hint = False
        gop_fast._WEDGE_EXTRA_BITS = 1e7
    try:
        yield enc
    finally:
        gop_fast._WEDGE_EXTRA_BITS = old
