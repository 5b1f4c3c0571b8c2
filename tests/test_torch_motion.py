"""The port's motion modules against the JAX package on the CPU: ME (SSD
search, HME), subpel convolve and MC (single, compound average, wedge,
diffwtd), warp, the device global-motion fit and the interp-filter pick,
and the mask-aware deblocking filter of the merged inter leaves.

Integer parts are held exact.  Two float parts are held to tie rules:
- the GM fit (float32 least squares): the integer mat / trans / kind are
  identical, or differ only where the float64 value lies within 1e-3 of a
  rounding boundary;
- the interp pick: identical, or the two best SSEs lie within 1e-6
  relative (the reference sums the frame SSE in float32, the port in
  exact int64);
- the wedge pick (float32 prediction-SSE algebra over the 32 options):
  identical, or the float64 SSEs of the two picks lie within 1e-6
  relative.
Every tie is counted and printed (pytest -s).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svt_av1_tpu.ops import convolve as jconv
from svt_av1_tpu.ops import dlf as jdlf
from svt_av1_tpu.ops import mc as jmc
from svt_av1_tpu.ops import me as jme
from svt_av1_tpu.ops import warp as jwarp
from svt_av1_tpu.pipeline import gop_fast as jgf
from svt_av1_tpu.pipeline import me as jme_pipe
from svt_av1_tpu_torch.ops import convolve as tconv
from svt_av1_tpu_torch.ops import dlf as tdlf
from svt_av1_tpu_torch.ops import mc as tmc
from svt_av1_tpu_torch.ops import me as tme
from svt_av1_tpu_torch.ops import warp as twarp
from svt_av1_tpu_torch.pipeline import gop_fast as tgf
from svt_av1_tpu_torch.pipeline import me as tme_pipe

import clips

torch.set_num_threads(2)
CPU = torch.device("cpu")
WM = 1 << 16


def T(a, dtype=torch.int32):
    return torch.as_tensor(np.array(a), dtype=dtype)


def N(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _moved(seed, h, w, dy, dx):
    """A natural frame and the same content moved by (dy, dx) px, with
    fresh noise: (src, ref) uint8 luma."""
    y = clips.natural_clip(1, w + 32, h + 32, seed=seed)[0][0]
    rng = np.random.default_rng(seed + 1)
    src = y[16:16 + h, 16:16 + w].astype(np.int32)
    ref = y[16 + dy:16 + dy + h, 16 + dx:16 + dx + w].astype(np.int32)
    ref = np.clip(ref + rng.integers(-2, 3, ref.shape), 0, 255)
    return src.astype(np.uint8), ref.astype(np.uint8)


# ---------------------------------------------------------------- ME ----

@pytest.mark.parametrize("blk,win", [(16, 24), (8, 24), (16, 32)])
def test_ssd_search_exact(blk, win):
    rng = np.random.default_rng(blk + win)
    src = rng.integers(0, 256, (40, blk, blk)).astype(np.int32)
    wins = rng.integers(0, 256, (40, win, win)).astype(np.int32)
    ref = np.asarray(jme.ssd_search(jnp.asarray(src), jnp.asarray(wins)))
    got = N(tme.ssd_search(T(src), T(wins)))
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    # the exact integer SSD, independently
    i, oy, ox = 3, 5, 2
    d = wins[i, oy:oy + blk, ox:ox + blk] - src[i]
    assert got[i, oy, ox] == float((d * d).sum())


def test_me_primitives_exact():
    rng = np.random.default_rng(7)
    x = rng.integers(0, 256, (3, 20, 18)).astype(np.int32)
    np.testing.assert_array_equal(N(tme._box_sum(T(x), 5, 7)),
                                  np.asarray(jme._box_sum(jnp.asarray(x),
                                                          5, 7)))
    np.testing.assert_array_equal(N(tme.downsample2(T(x))),
                                  np.asarray(jme.downsample2(jnp.asarray(x))))
    a, b = x[0], x[1]
    assert int(tme.sad(T(a), T(b))) == int(jme.sad(jnp.asarray(a),
                                                  jnp.asarray(b)))
    cost = rng.integers(0, 9, (6, 5, 5)).astype(np.float32)
    for g, r in zip(tme.best_mv(T(cost, torch.float32), -2, -2),
                    jme.best_mv(jnp.asarray(cost), -2, -2)):
        np.testing.assert_array_equal(N(g), np.asarray(r))


@functools.lru_cache(maxsize=None)
def _jax_hme(h, w, rad2, rad1, rad0):
    return jax.jit(jme_pipe.hme_core(h, w, rad2, rad1, rad0))


@pytest.mark.parametrize("shift,rads", [((3, -5), (6, 8, 4)),
                                        ((-9, 14), (4, 8, 3))])
def test_hme_core_mv_field(shift, rads):
    """HME on 64x128 frames moved by a known shift, at the M10 and M12
    radii: the MV fields equal the reference's (argmin ties resolve to the
    first offset in both)."""
    h, w = 64, 128
    src, ref = _moved(sum(shift) + 40, h, w, *shift)
    run_j = _jax_hme(h, w, *rads)
    my_j, mx_j, ssd_j = (np.asarray(a) for a in run_j(
        jnp.asarray(src.astype(np.int32)), jnp.asarray(ref.astype(np.int32))))
    my_t, mx_t, ssd_t = (N(a) for a in tme_pipe.hme_core(h, w, *rads)(
        T(src), T(ref)))
    np.testing.assert_array_equal(my_t, my_j)
    np.testing.assert_array_equal(mx_t, mx_j)
    np.testing.assert_array_equal(ssd_t, ssd_j)
    # most blocks find the true motion (the reference block lies at
    # -shift: a sanity check of the data)
    assert np.mean((my_t == -shift[0]) & (mx_t == -shift[1])) > 0.5
    ties = int(np.sum(ssd_t == 0))
    print(f"hme {shift}: {my_t.size} MVs equal, {ties} zero-SSD blocks")


def test_hierarchical_me_pads_and_crops():
    src, ref = _moved(3, 48, 80, 2, -3)
    got = tme_pipe.hierarchical_me(src, ref, rad2=6, rad0=4, device="cpu")
    want = jme_pipe.hierarchical_me(src, ref, rad2=6, rad0=4)
    for g, r in zip(got, want):
        np.testing.assert_array_equal(g, r)


# ------------------------------------------------------- convolve / MC ----

@pytest.fixture(scope="module")
def windows():
    rng = np.random.default_rng(11)
    w0 = rng.integers(0, 256, (48, 23, 23)).astype(np.int32)
    w1 = rng.integers(0, 256, (48, 23, 23)).astype(np.int32)
    ph = rng.integers(0, 16, (4, 48)).astype(np.int32)
    return w0, w1, ph


@pytest.mark.parametrize("kind", [0, 1, 2])
def test_convolve_2d_sr_exact(windows, kind):
    w0, _, ph = windows
    ref = jconv.convolve_2d_sr(jnp.asarray(w0), jnp.asarray(ph[0]),
                               jnp.asarray(ph[1]), 16, 16, kind, kind)
    got = tconv.convolve_2d_sr(T(w0), T(ph[0]), T(ph[1]), 16, 16, kind, kind)
    np.testing.assert_array_equal(N(got), np.asarray(ref))
    # the filter kind as a 0-d tensor (the frame pick stays on the device)
    got_t = tconv.convolve_2d_sr(T(w0), T(ph[0]), T(ph[1]), 16, 16,
                                 T(kind), T(kind))
    np.testing.assert_array_equal(N(got_t), np.asarray(ref))


@pytest.mark.parametrize("kind", [0, 2])
def test_compound_convolves_exact(windows, kind):
    w0, w1, ph = windows
    jw = (jnp.asarray(w0), jnp.asarray(w1)) + tuple(jnp.asarray(p)
                                                    for p in ph)
    tw = (T(w0), T(w1)) + tuple(T(p) for p in ph)
    np.testing.assert_array_equal(
        N(tconv.convolve_2d_compound_avg(*tw, 16, 16, kind=kind)),
        np.asarray(jconv.convolve_2d_compound_avg(*jw, 16, 16, kind=kind)))
    inv = (np.arange(48) % 2).astype(np.int32)
    gp, gm = tconv.convolve_2d_compound_diffwtd(*tw, 16, 16, T(inv),
                                                kind=kind)
    rp, rm = jconv.convolve_2d_compound_diffwtd(*jw, 16, 16,
                                                jnp.asarray(inv), kind=kind)
    np.testing.assert_array_equal(N(gp), np.asarray(rp))
    np.testing.assert_array_equal(N(gm), np.asarray(rm))
    mask = np.random.default_rng(3).integers(0, 65, (48, 16, 16)).astype(
        np.int32)
    np.testing.assert_array_equal(
        N(tconv.convolve_2d_compound_masked(*tw, 16, 16, T(mask), kind=kind)),
        np.asarray(jconv.convolve_2d_compound_masked(
            *jw, 16, 16, jnp.asarray(mask), kind=kind)))


@pytest.fixture(scope="module")
def mc_case():
    """A 64x96 reference padded as the encoder pads it, block positions
    on the 16 grid and MVs that include both clamp bounds (the chroma
    window at the lower bound starts one row before the padded plane)."""
    h, w = 64, 96
    rng = np.random.default_rng(5)
    planes = [rng.integers(0, 256, s).astype(np.int32)
              for s in ((h, w), (h // 2, w // 2))]
    nb = (h // 16) * (w // 16)
    ys = (np.arange(nb) // (w // 16) * 16).astype(np.int32)
    xs = (np.arange(nb) % (w // 16) * 16).astype(np.int32)
    mvs = rng.integers(-700, 700, (nb, 2, 2)).astype(np.int32)
    mvs[0, 0] = (-(ys[0] + 76) * 8, -(xs[0] + 76) * 8)
    mvs[-1, 1] = ((h + 76 - (ys[-1] + 16)) * 8, (w + 76 - (xs[-1] + 16)) * 8)
    cand = jgf._clamp_cands(jnp.asarray(mvs), jnp.asarray(ys),
                            jnp.asarray(xs), 16, h, w)
    cand_t = tgf._clamp_cands(T(mvs), T(ys), T(xs), 16, h, w)
    np.testing.assert_array_equal(N(cand_t), np.asarray(cand))
    return planes, ys, xs, np.asarray(cand)


@pytest.mark.parametrize("plane", [0, 1])
def test_mc_blocks_exact(mc_case, plane):
    planes, ys, xs, mvs = mc_case
    ss, n = plane, 16 >> plane
    pad = jmc.PAD >> ss
    refp = np.pad(planes[plane], pad, mode="edge")
    refp_t = tmc.pad_plane(T(planes[plane]), pad)
    np.testing.assert_array_equal(N(refp_t), refp)
    py, px = ys >> ss, xs >> ss
    for kind in (0, 1):
        ref = jmc.mc_blocks(jnp.asarray(refp), py, px, mvs[:, 0], n,
                            jmc.PAD, ss, kind=kind)
        got = tmc.mc_blocks(refp_t, T(py), T(px), T(mvs[:, 0]), n, tmc.PAD,
                            ss, kind=kind)
        np.testing.assert_array_equal(N(got), np.asarray(ref))
    jr = jnp.asarray(refp)
    ref = jmc.mc_blocks_compound(jr, jr[::-1], py, px, mvs[:, 0], mvs[:, 1],
                                 n, jmc.PAD, ss)
    got = tmc.mc_blocks_compound(refp_t, refp_t.flip(0), T(py), T(px),
                                 T(mvs[:, 0]), T(mvs[:, 1]), n, tmc.PAD, ss)
    np.testing.assert_array_equal(N(got), np.asarray(ref))
    mask = np.random.default_rng(9).integers(0, 65, (len(ys), n, n))
    ref = jmc.mc_blocks_compound(jr, jr[::-1], py, px, mvs[:, 0], mvs[:, 1],
                                 n, jmc.PAD, ss, mask=jnp.asarray(mask))
    got = tmc.mc_blocks_compound(refp_t, refp_t.flip(0), T(py), T(px),
                                 T(mvs[:, 0]), T(mvs[:, 1]), n, tmc.PAD, ss,
                                 mask=T(mask))
    np.testing.assert_array_equal(N(got), np.asarray(ref))
    if plane == 0:
        inv = (np.arange(len(ys)) % 2).astype(np.int32)
        rp, rm = jmc.mc_blocks_compound_diffwtd(jr, jr[::-1], ys, xs,
                                                mvs[:, 0], mvs[:, 1], 16,
                                                jmc.PAD, jnp.asarray(inv))
        gp, gm = tmc.mc_blocks_compound_diffwtd(refp_t, refp_t.flip(0),
                                                T(ys), T(xs), T(mvs[:, 0]),
                                                T(mvs[:, 1]), 16, tmc.PAD,
                                                T(inv))
        np.testing.assert_array_equal(N(gp), np.asarray(rp))
        np.testing.assert_array_equal(N(gm), np.asarray(rm))


# --------------------------------------------------------- warp / GM ----

_MATS = [(-3000, 5000, WM + 900, 700, -700, WM + 900),
         (12000, -7000, WM - 1500, -1200, 1200, WM - 1500),
         (0, 0, WM, 0, 0, WM)]


@pytest.mark.parametrize("mi", range(len(_MATS)))
def test_warp_exact(mi):
    mat = _MATS[mi]
    assert twarp.shear_params(mat) == jwarp.shear_params(mat)
    rng = np.random.default_rng(mi)
    for ss, (h, w) in ((0, (48, 64)), (1, (24, 32))):
        plane = rng.integers(0, 256, (h, w)).astype(np.int32)
        ref = jwarp.warp_plane(plane, mat, w, h, subsampling=ss)
        got = twarp.warp_plane(T(plane), mat, w, h, subsampling=ss)
        np.testing.assert_array_equal(N(got), ref)
        # the device-parameter path of P1
        sh_j = jgf._shear_device(jnp.asarray(mat, jnp.int32))
        sh_t = tgf._shear_device(T(mat))
        for a, b in zip(sh_t, sh_j):
            assert int(a) == int(b)
        got_d = tgf._warp_plane_traced(T(plane), T(mat), sh_t[:4], w, h, 8,
                                       ss)
        np.testing.assert_array_equal(N(got_d), ref)
    np.testing.assert_array_equal(
        N(tgf._gm_block_mvs(T(mat), 4, 6)),
        np.asarray(jgf._gm_block_mvs(jnp.asarray(mat, jnp.int32), 4, 6)))


def _field(kind, gh, gw, seed):
    """Synthetic HME fields: pure translation, rotation-zoom around the
    center, and a rotation-zoom with outlier blocks."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:gh, 0:gw] * 16 + 8
    if kind == "trans":
        my = np.full((gh, gw), -3) + (rng.random((gh, gw)) < 0.1)
        mx = np.full((gh, gw), 5) - (rng.random((gh, gw)) < 0.1)
    else:
        a, b = 0.012 * (seed % 3 + 1), -0.009
        cy, cx = gh * 8, gw * 8
        mx = np.round(a * (xx - cx) + b * (yy - cy) + 2)
        my = np.round(-b * (xx - cx) + a * (yy - cy) - 1)
        if kind == "outliers":
            sel = rng.random((gh, gw)) < 0.2
            my[sel] = rng.integers(-20, 20, sel.sum())
            mx[sel] = rng.integers(-20, 20, sel.sum())
    return my.astype(np.int32), mx.astype(np.int32)


@pytest.mark.parametrize("kind,shape", [("trans", (4, 6)),
                                        ("rotzoom", (18, 22)),
                                        ("outliers", (18, 22)),
                                        ("rotzoom", (45, 80))])
def test_gm_fit_tie_rule(kind, shape):
    gh, gw = shape
    ties = 0
    for seed in range(3):
        mv_y, mv_x = _field(kind, gh, gw, seed)
        ref = [np.asarray(a) for a in jgf._gm_fit(jnp.asarray(mv_y),
                                                  jnp.asarray(mv_x), gh, gw)]
        got = [N(a) for a in tgf._gm_fit(T(mv_y), T(mv_x), gh, gw)]
        if all(np.array_equal(g, r) for g, r in zip(got, ref)):
            continue
        # a mismatch must come from a value that lies, in float64, within
        # 1e-3 of a rounding boundary (x.5)
        ties += 1
        raw = N(tgf._gm_fit(T(mv_y), T(mv_x), gh, gw, dtype=torch.float64,
                            raw=True)[3])
        assert np.min(np.abs(np.abs(raw - np.floor(raw)) - 0.5)) < 1e-3, (
            got, ref, raw)
    print(f"gm fit {kind} {shape}: {ties} of 3 fields differ (ties)")
    assert ties <= 1
    if kind == "trans":
        assert int(got[2]) == 1          # a translation model was found
    else:
        assert int(got[2]) == 2          # a rotation-zoom model was found


def test_interp_pick_tie_rule():
    """The frame interp-filter pick of P1 on a moved 64x96 frame: the port
    (exact int64 SSEs) and the reference (float32) pick the same kind, or
    the two best SSEs are within 1e-6 relative."""
    h, w = 64, 96
    ties = 0
    for seed, shift in ((1, (2, -3)), (2, (-5, 4)), (3, (0, 1))):
        src, ref = _moved(seed, h, w, *shift)
        my, mx, _ = jme_pipe.hierarchical_me(src, ref, rad2=6, rad0=4)
        hme = np.stack([my.reshape(-1) * 8, mx.reshape(-1) * 8],
                       -1).astype(np.int32)
        nb = hme.shape[0]
        ys = (np.arange(nb) // (w // 16) * 16).astype(np.int32)
        xs = (np.arange(nb) % (w // 16) * 16).astype(np.int32)
        refp = np.pad(ref.astype(np.int32), jmc.PAD, mode="edge")
        probe = jgf._clamp_cands(jnp.asarray(hme + 2)[:, None],
                                 jnp.asarray(ys), jnp.asarray(xs), 16, h,
                                 w)[:, 0]
        sj = []
        for kind in (0, 1, 2):
            pp = jmc.mc_blocks(jnp.asarray(refp), ys, xs, probe, 16, jmc.PAD,
                               0, kind=kind)
            ar = np.arange(16)
            d = (src.astype(np.int32)[ys[:, None, None] + ar[:, None],
                                      xs[:, None, None] + ar]
                 - np.asarray(pp)).astype(np.float32)
            sj.append(float(jnp.sum(jnp.asarray(d) * jnp.asarray(d))))
        kind_t, st = tgf._interp_pick(T(src), T(refp), T(hme), T(ys), T(xs),
                                      h, w)
        st = N(st).astype(np.float64)
        if int(kind_t) != int(np.argmin(sj)):
            ties += 1
            two = np.sort(st)[:2]
            assert (two[1] - two[0]) <= 1e-6 * two[1]
    print(f"interp pick: {ties} ties in 3 frames")
    assert ties <= 1


def _wedge_inputs():
    """(d1, e) float32 (nb, 256) of _eval_pair's wedge pick: the wipe
    clip's 16 blocks (src frame 2, pA frame 0, pB frame 4, zero MVs) and
    480 seeded random blocks."""
    fr = [f[0].astype(np.int32) for f in clips.wipe_clip(5)]
    blk = lambda y: y.reshape(4, 16, 4, 16).transpose(0, 2, 1, 3).reshape(
        16, 256)
    src, pA, pB = blk(fr[2]), blk(fr[0]), blk(fr[4])
    rng = np.random.default_rng(21)
    r = rng.integers(0, 256, (3, 480, 256))
    src, pA, pB = (np.concatenate([a, b]) for a, b in zip((src, pA, pB), r))
    return (src - pB).astype(np.float32), (pA - pB).astype(np.float32)


def test_wedge_pick_tie_rule():
    """The wedge pick of _eval_pair: the port and the reference's
    expression (gop_fast.py:755-757) pick the same option, or the float64
    SSEs of the two picks lie within 1e-6 relative; the port's pick is the
    float64 argmin under the same rule."""
    from svt_av1_tpu.ops import wedge as jwedge
    d1, e = _wedge_inputs()
    m_all = np.concatenate([jwedge.masks_16[0], jwedge.masks_16[1]])
    Mj = jnp.asarray(m_all.reshape(32, -1).astype(np.float32) / 64.0)
    dj, ej = jnp.asarray(d1), jnp.asarray(e)
    ref = np.asarray(jnp.argmin(jnp.sum(dj * dj, axis=1, keepdims=True)
                                - 2.0 * (dj * ej) @ Mj.T
                                + (ej * ej) @ (Mj * Mj).T, axis=1))
    M, M2, _, _ = tgf._wedge_masks_on(CPU)
    got = N(tgf._wedge_pick(torch.from_numpy(d1), torch.from_numpy(e), M,
                            M2))
    m64 = m_all.reshape(32, -1).astype(np.float64) / 64.0
    sse64 = ((d1.astype(np.float64)[:, None] - m64[None]
              * e.astype(np.float64)[:, None]) ** 2).sum(2)
    rows = np.arange(len(got))
    ties = 0
    for other in (ref, sse64.argmin(1)):
        diff = got != other
        a, b = sse64[rows, got], sse64[rows, other]
        assert np.all(np.abs(a - b)[diff] <= 1e-6 * np.maximum(a, b)[diff])
        ties += int(diff.sum())
    print(f"wedge pick: {ties} ties over {len(got)} blocks (vs the "
          f"reference, vs float64)")
    assert ties <= 4


# -------------------------------------------------- masked deblocking ----

def test_masked_dlf_exact():
    """edge_flens and loop_filter_plane_masked on a 64x96 plane with a
    mix of 16x16 leaves, a merged 32x32 skip leaf and a rect pair."""
    h, w = 64, 96
    mr, mc_ = h // 4, w // 4
    txw = np.full((mr, mc_), 4, np.int32)
    txh = txw.copy()
    sk = np.zeros((mr, mc_), bool)
    txw[0:8, 0:8] = txh[0:8, 0:8] = 8          # a 32x32 skip leaf
    sk[0:8, 0:8] = True
    txw[8:16, 8:16] = 8                         # a HORZ pair (32x16)
    sk[8:16, 8:16] = True
    sk[4:8, 16:20] = True                       # a skip 16x16 leaf
    rng = np.random.default_rng(2)
    plane = np.clip(rng.normal(128, 6, (h, w)), 0, 255).astype(np.int32)
    for is_luma in (True, False):
        fv_j = np.asarray(jdlf.edge_flens(txw, txw, sk, is_luma))
        fh_j = np.asarray(jdlf.edge_flens(txh.T, txh.T, sk.T, is_luma)).T
        fv_t = tdlf.edge_flens(T(txw), T(txw), T(sk, torch.bool), is_luma)
        fh_t = tdlf.edge_flens(T(txh).T, T(txh).T, T(sk, torch.bool).T,
                               is_luma).T
        np.testing.assert_array_equal(N(fv_t), fv_j)
        np.testing.assert_array_equal(N(fh_t), fh_j)
        for level in (10, 30):
            ref = jdlf.loop_filter_plane_masked(plane, fv_j, fh_j, level, 0,
                                                is_luma)
            got = tdlf.loop_filter_plane_masked(T(plane), fv_t, fh_t, level,
                                                0, is_luma)
            np.testing.assert_array_equal(N(got), np.asarray(ref))


def _mixed_decisions(bd_cls, h=64, w=96, seed=4):
    """Leaf decisions of a 64x96 inter frame with merged skip leaves: a
    32x32 at the top left, a HORZ pair of 32x16 leaves, and 16x16 leaves
    (inter or intra, some skip) elsewhere."""
    from svt_av1_tpu_torch.codec import constants as cc
    rng = np.random.default_rng(seed)
    big = {(0, 0): (cc.BLOCK_32X32, 32, 32),
           (8, 8): (cc.BLOCK_32X16, 16, 32),
           (12, 8): (cc.BLOCK_32X16, 16, 32)}
    covered = {(r, c) for r in range(0, 8, 4) for c in range(0, 8, 4)} | {
        (r, c) for r in (8, 12) for c in (8, 12)}
    out = {}
    for (r4, c4), (bsize, th, tw) in big.items():
        out[(r4, c4)] = bd_cls(
            r4=r4, c4=c4, bsize=bsize, y_mode=0, uv_mode=0, tx_type=0,
            qcoeff_y=np.zeros((th, tw), np.int32),
            qcoeff_u=np.zeros((th // 2, tw // 2), np.int32),
            qcoeff_v=np.zeros((th // 2, tw // 2), np.int32), is_inter=True)
    for r4 in range(0, h // 4, 4):
        for c4 in range(0, w // 4, 4):
            if (r4, c4) in covered:
                continue
            lv = lambda n: (rng.integers(-2, 3, (n, n))
                            * (rng.random() < 0.6)).astype(np.int32)
            out[(r4, c4)] = bd_cls(
                r4=r4, c4=c4, bsize=cc.BLOCK_16X16, y_mode=0, uv_mode=0,
                tx_type=0,
                qcoeff_y=lv(16), qcoeff_u=lv(8), qcoeff_v=lv(8),
                is_inter=bool(rng.random() < 0.7))
    return out


def test_masked_dlf_stage_exact():
    """maps_from_decisions, flens_from_maps, apply_masked and
    search_and_apply_masked on a mixed-size inter frame, exact."""
    from svt_av1_tpu.codec.syntax import BlockDecision as JBD
    from svt_av1_tpu.pipeline import dlf_stage as jst
    from svt_av1_tpu_torch.codec import obu as tobu
    from svt_av1_tpu_torch.codec.syntax import BlockDecision as TBD
    from svt_av1_tpu_torch.pipeline import dlf_stage as tst
    from svt_av1_tpu.codec import obu as jobu
    h, w = 64, 96
    mj = jst.maps_from_decisions(_mixed_decisions(JBD), h // 4, w // 4)
    mt = tst.maps_from_decisions(_mixed_decisions(TBD), h // 4, w // 4)
    for g in ("y", "uv"):
        for a, b in zip(mt[g], mj[g]):
            np.testing.assert_array_equal(a, b)
    fj = jst.flens_from_maps(mj)
    ft = tst.flens_from_maps(mt, device="cpu")
    for k in fj:
        np.testing.assert_array_equal(N(ft[k]), fj[k])
    rng = np.random.default_rng(6)
    src = {k: rng.integers(0, 256, s).astype(np.uint8)
           for k, s in (("y", (h, w)), ("u", (h // 2, w // 2)),
                        ("v", (h // 2, w // 2)))}
    rec = {k: np.clip(src[k].astype(int) + rng.integers(-9, 10, v.shape),
                      0, 255).astype(np.uint8) for k, v in src.items()}
    tt = lambda d: {k: torch.from_numpy(v.copy()) for k, v in d.items()}
    fpj, fpt = jobu.FrameParams(base_q_idx=180), tobu.FrameParams(
        base_q_idx=180)
    fpj.filter_level = fpt.filter_level = (14, 14)
    fpj.filter_level_uv = fpt.filter_level_uv = (9, 7)
    aj = jst.apply_masked(rec, fpj, fj)
    at = tst.apply_masked(tt(rec), fpt, ft)
    for k in "yuv":
        np.testing.assert_array_equal(N(at[k]), np.asarray(aj[k]))
    sj = jst.search_and_apply_masked(src, rec, fpj, fj)
    st = tst.search_and_apply_masked(tt(src), tt(rec), fpt, ft)
    assert (fpt.filter_level, fpt.filter_level_uv) == (
        fpj.filter_level, fpj.filter_level_uv)
    for k in "yuv":
        np.testing.assert_array_equal(N(st[k]), np.asarray(sj[k]))
