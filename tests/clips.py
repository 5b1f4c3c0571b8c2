"""Synthetic test pictures for the port's tests and chip_smoke.py, made
from a seed with numpy only (so they also exist where JAX is not
installed).

``natural_clip`` is the bench's clip shape: moving sinusoids plus noise.
``fault_clip``, ``seam_clip``, ``gradient_wipe_clip`` and ``boundary_clip``
are the M5-M9 GOP clips: the reference's round-trip fault, OBMC,
inter-intra and the 8x8 split.
``screen_frame`` is screen content: flat colored rectangles and text-like
two-color bars, so that many 16x16 blocks hold 2-8 distinct luma values
and the palette candidates exist.  ``TOOL_CLIPS`` are the GOP clips that
code one compound or warp tool each; ``split_motion_clip`` is the
lookahead's clip (its key frames code delta-q).  ``varpart_frame`` is
the 128x96 picture of the reference's variable-partition tests (a smooth
field with a textured corner: 64x64, 32x32 and 16x16 leaves at M0-M4).
``grain_frame`` is a smooth picture under spatially correlated noise (the
film-grain estimator fits it); ``lr_planes`` are source, deblocked and
CDEF planes on which the loop-restoration search picks Wiener for luma
and self-guided filters for chroma.
"""
import contextlib
import dataclasses

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


def varpart_frame(h=96, w=128, seed=2):
    """One (y, u, v) uint8 picture: a smooth luma field with a random
    48x48 textured corner and flat chroma (tests/test_varpart.py's
    content)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    y = (100 + 50 * np.sin(xx / 40.0) + 30 * np.cos(yy / 33.0)).astype(
        np.int32)
    y[:48, :48] = rng.integers(0, 256, (48, 48))
    y = np.clip(y, 0, 255).astype(np.uint8)
    u = np.full((h // 2, w // 2), 100, np.uint8)
    v = np.full((h // 2, w // 2), 140, np.uint8)
    return y, u, v


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


def fault_clip(n=6, h=64, w=64, seed=3):
    """The clip on which the reference's M6 stream fails its round trip
    with DLF or CDEF on (ROADMAP.md queue C item 4): the natural clip's
    luma without its chroma pattern, uniform noise in [-5, 5], a 16x16
    patch of 230 at rows 8-23 moving 3 px a frame; flat chroma 120 / 135."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for t in range(n):
        y = (96 + 60 * np.sin(xx / 17.0 + 0.13 * t)
             + 50 * np.cos(yy / 23.0 + 0.02 * t)
             + rng.integers(-5, 6, (h, w)))
        x0 = 8 + 3 * t
        y[8:24, x0:x0 + 16] = 230
        out.append((np.clip(y, 0, 255).astype(np.uint8),
                    np.full((h // 2, w // 2), 120, np.uint8),
                    np.full((h // 2, w // 2), 135, np.uint8)))
    return out


def seam_clip(n=5, h=64, w=64, back=False):
    """The OBMC clip of tests/test_obmc.py: a smoothed texture whose rows
    shift by 8 + 6 sin(row / 10) px over the clip, so that adjacent
    block rows move differently; flat chroma.  ``back``: the rows shift
    that far by the middle frame and back again, so that the last frame
    repeats the first (a base two mini-GoPs after the key frame finds it
    in its GOLDEN reference)."""
    rng = np.random.default_rng(11)
    tex = _smooth(rng.integers(0, 255, (h, w + 48)).astype(np.float32))
    yy = np.mgrid[0:h, 0:w][0]
    out = []
    for t in range(n):
        f = (min(t, n - 1 - t) / ((n - 1) / 2) if back else t / (n - 1))
        shift = ((8 + 6 * np.sin(yy[:, 0] / 10.0)) * f
                 if t else np.zeros(h))
        y = np.stack([tex[r, int(round(shift[r])):int(round(shift[r])) + w]
                      for r in range(h)]).astype(np.uint8)
        out.append((y, np.full((h // 2, w // 2), 120, np.uint8),
                    np.full((h // 2, w // 2), 135, np.uint8)))
    return out


def gradient_wipe_clip(n=5, h=64, w=64):
    """The inter-intra clip of tests/test_interintra.py: a texture panning
    4 px a frame under a diagonal gradient wipe; flat chroma."""
    rng = np.random.default_rng(21)
    tex = _smooth(rng.integers(0, 255, (h, w + 32)).astype(np.float32))
    yy, xx = np.mgrid[0:h, 0:w]
    grad = np.clip(60 + yy * 2, 0, 255)
    out = []
    for t in range(n):
        y = tex[:, 4 * t:4 * t + w].copy()
        m = (yy + xx) < min(2 * h, 20 * t)
        y[m] = grad[m]
        out.append((y.astype(np.uint8),
                    np.full((h // 2, w // 2), 120, np.uint8),
                    np.full((h // 2, w // 2), 135, np.uint8)))
    return out


def boundary_clip(n=5, h=96, w=128):
    """The 8x8-split clip of tests/test_part8.py: a blocky texture whose
    left 56 columns move 8 px a frame while the rest stands still, so
    that the boundary crosses 16x16 blocks; flat chroma."""
    rng = np.random.default_rng(5)
    base = np.kron(rng.integers(30, 220, (h // 4, (w + 8 * n + 64) // 4))
                   .astype(np.uint8), np.ones((4, 4), np.uint8))
    out = []
    for t in range(n):
        y = base[:, :w].copy()
        y[:, :56] = base[:, 8 * t:8 * t + 56]
        out.append((y, np.full((h // 2, w // 2), 110, np.uint8),
                    np.full((h // 2, w // 2), 135, np.uint8)))
    return out


def blend_b_clip():
    """The compound clip of tests/test_compound.py: 128x96 x3, the middle
    frame the average of its neighbours; flat chroma."""
    h, w = 96, 128
    yy, xx = np.mgrid[0:h, 0:w]
    base = 110 + 60 * np.sin(xx / 17.0) + 40 * np.cos(yy / 13.0)
    f0 = np.clip(base, 0, 255).astype(np.uint8)
    f2 = np.clip(base + 30 * np.sin((xx + yy) / 9.0), 0, 255).astype(
        np.uint8)
    f1 = ((f0.astype(np.int32) + f2.astype(np.int32) + 1) // 2).astype(
        np.uint8)
    u = np.full((h // 2, w // 2), 120, np.uint8)
    v = np.full((h // 2, w // 2), 135, np.uint8)
    return [(f, u, v) for f in (f0, f1, f2)]


def square_clip(n=6):
    """The 32x32-merge clip of tests/test_gop_hierarchical.py: a static
    64x64 texture with an 8x8 square moving 2 px a frame."""
    rng = np.random.default_rng(9)
    base = rng.integers(30, 220, (64, 64)).astype(np.uint8)
    u0 = rng.integers(60, 190, (32, 32)).astype(np.uint8)
    out = []
    for t in range(n):
        y = base.copy()
        y[4:12, 2 * t:2 * t + 8] = 235
        out.append((y, u0.copy(), u0.copy()))
    return out


def two_motion_clip(horz, n=5, h=96, w=96, seed=7):
    """The rect-partition clip of tests/test_rect_partition.py: a
    low-passed random texture whose two halves (split at row or column 48)
    roll 2 px a frame in opposite directions."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 250, (h, w)).astype(np.int32)
    base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)
            + np.roll(base, (1, 1), (0, 1))) // 4
    u0 = rng.integers(60, 200, (h // 2, w // 2)).astype(np.uint8)
    out = []
    for t in range(n):
        y = np.empty((h, w), np.int32)
        if horz:
            y[:48] = np.roll(base[:48], 2 * t, axis=1)
            y[48:] = np.roll(base[48:], -2 * t, axis=1)
        else:
            y[:, :48] = np.roll(base[:, :48], 2 * t, axis=0)
            y[:, 48:] = np.roll(base[:, 48:], -2 * t, axis=0)
        out.append((y.astype(np.uint8), u0, u0))
    return out


# the GOP clips that code one compound or warp tool each at M10
# (hierarchical_levels 2): name -> (frames, config fields, the tool)
TOOL_CLIPS = {
    "wipe": (wipe_clip, dict(qp=45, intra_period_length=31), "wedge"),
    "iris": (iris_clip, dict(qp=45, intra_period_length=31), "diffwtd"),
    "rotzoom": (rotzoom_clip, dict(qp=35, intra_period_length=4), "warp"),
}


# preset features pinned by the reference's tool-isolation tests
# (tests/test_obmc.py, tests/test_interintra.py): part8 and the tx search
# out-RD OBMC and inter-intra on their synthetic clips
PINNED_FEATURES = {
    "obmc_m6": dict(part8=False, tx_search=False),
    "ii_m6": dict(part8=False, tx_search=False),
    # the reference's OBMC-next-to-a-split fault shows without the search
    "m6_fault_notx": dict(tx_search=False),
}


@contextlib.contextmanager
def tool_setting(name, enc, gop_fast):
    """The setting of the reference's test for the clip ``name`` on the
    encoder ``enc`` (either package's, made but not yet fed) and its
    ``gop_fast`` module: the iris clip turns order hints off, so that
    skip mode does not out-RD the diffwtd blocks, and prices wedge out;
    the clips of PINNED_FEATURES replace those preset features (and the
    sequence flags the encoder derives from them) as the reference's
    tests do with a patched ``features_for``; the other clips change
    nothing."""
    old = gop_fast._WEDGE_EXTRA_BITS
    if name == "iris":
        enc.sp.enable_order_hint = False
        gop_fast._WEDGE_EXTRA_BITS = 1e7
    if name in PINNED_FEATURES:
        enc._feat = dataclasses.replace(enc._feat, **PINNED_FEATURES[name])
        enc.sp.enable_interintra_compound = enc._feat.interintra
        enc.sp.enable_ref_frame_mvs = bool(enc._feat.tmvp)
    try:
        yield enc
    finally:
        gop_fast._WEDGE_EXTRA_BITS = old


def grain_frame(h=64, w=64, seed=0):
    """A smooth luma field under AR-correlated gaussian noise (sigma about
    7) and lightly noisy flat chroma: the film-grain noise model finds
    flat blocks and fits their noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    clean = np.clip(100 + 60 * np.sin(xx / 33.0), 0, 255)
    white = rng.normal(0, 6, (h + 4, w + 4))
    noise = (white[2:-2, 2:-2] + 0.5 * white[1:-3, 2:-2]
             + 0.3 * white[2:-2, 1:-3])
    y = np.clip(clean + noise, 0, 255).astype(np.uint8)
    u = np.clip(120 + rng.normal(0, 3, (h // 2, w // 2)), 0,
                255).astype(np.uint8)
    v = np.clip(130 + rng.normal(0, 3, (h // 2, w // 2)), 0,
                255).astype(np.uint8)
    return y, u, v


def lr_planes(h=96, w=128, seed=9, exact=False):
    """(source, deblocked, cdef) dicts of uint8 planes for the restoration
    search: a sinusoid luma under gaussian noise (Wiener pays), rings
    (u) and a diagonal step (v) under noise (the self-guided filters pay).
    ``exact``: the planes equal the source (RESTORE_NONE wins)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    cy, cx = np.mgrid[0:h // 2, 0:w // 2]
    src = dict(
        y=np.clip(100 + 60 * np.sin(xx / 7.0) + 40 * np.cos(yy / 5.0), 0,
                  255),
        u=128 + 100 * np.sign(np.sin(np.hypot(cx - w // 4, cy - h // 4)
                                     / 3.0)),
        v=np.where(cx + cy > (h + w) // 5, 200, 60))
    src = {k: np.clip(v, 0, 255).astype(np.uint8) for k, v in src.items()}
    if exact:
        return src, dict(src), dict(src)

    def noisy(a, sigma):
        return np.clip(a + np.rint(rng.normal(0, sigma, a.shape)), 0,
                       255).astype(np.uint8)

    deb = dict(y=noisy(src["y"], 6), u=noisy(src["u"], 5),
               v=noisy(src["v"], 2))
    cdef = dict(y=noisy(deb["y"], 2), u=deb["u"].copy(), v=deb["v"].copy())
    return src, deb, cdef
