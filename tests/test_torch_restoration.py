"""The port's loop restoration and superres ops against the JAX package on
the CPU (ops/restoration.py, ops/resize.py, pipeline/lr_stage.py).

What holds exactly, and why:
- wiener_filter, selfguided_restoration (all 16 parameter sets),
  apply_selfguided and superres_upscale (denominators 9-16) are normative
  int32 arithmetic: bit-exact on seeded random windows;
- the stage's windows (one gather through host-built index maps) equal
  the reference's numpy _window for every chunk of a frame;
- search_lr's unit choices (type, parameter set, xqd, Wiener taps) are
  identical: its SSEs are exact int64 sums, its five projection dot
  products are sums of integer products under 2^26 over at most ~2^18
  samples, so the device's int64 sums equal the reference's float64 ones
  exactly in any order (_xq_from_sums against the reference's
  _solve_xq); the Wiener solve's float mean removal and alternating
  solves are the reference's own numpy code on the same host planes, so
  they match exactly too;
- apply_lr exact.
The JAX outputs are stored in tests/golden/torch_port_refs.npz
(tests/port_refs.py; remade by tools/make_torch_port_refs.py).
"""
import numpy as np
import pytest
import torch

import clips
import port_refs
from svt_av1_tpu_torch.codec import lr as lr_mod
from svt_av1_tpu_torch.ops import resize, restoration as rst
from svt_av1_tpu_torch.pipeline import lr_stage

torch.set_num_threads(2)
T = torch.from_numpy


def _taps(rng, b):
    """(B, 8) kernel-domain Wiener taps within the signaled ranges."""
    out = np.zeros((b, 8), np.int32)
    for i in range(b):
        t = [int(rng.integers(lo, hi + 1))
             for lo, hi, _, _ in lr_mod.WIENER_TAPS]
        out[i] = [t[0], t[1], t[2], -2 * sum(t), t[2], t[1], t[0], 0]
    return out


@pytest.mark.parametrize("h,w", [(12, 16), (21, 35)])
def test_wiener_filter_matches_jax(h, w):
    rng = np.random.default_rng(h * w)
    win = rng.integers(0, 256, (5, h + 6, w + 7)).astype(np.int32)
    fx, fy = _taps(rng, 5), _taps(rng, 5)

    def jax_out():
        from svt_av1_tpu.ops import restoration as jr
        return (jr.wiener_filter(win, fx, fy, w, h),)

    (want,) = port_refs.jax_ref(f"lr_wiener_{h}x{w}", jax_out, win, fx, fy)
    got = rst.wiener_filter(T(win), T(fx), T(fy), w, h).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("eps", range(16))
def test_selfguided_matches_jax(eps):
    """flt0 / flt1 and the projection, on 4 windows of 13 rows (odd: the
    r0 filter's half-rate rows count from each window's first row)."""
    h, w = 13, 22
    rng = np.random.default_rng(100 + eps)
    ext = rng.integers(0, 256, (4, h + 6, w + 6)).astype(np.int32)
    # flat windows too: z saturates at 255 there
    ext[1] = ext[1, 0, 0]
    xqd0 = rng.integers(-96, 32, 4).astype(np.int32)
    xqd1 = rng.integers(-32, 96, 4).astype(np.int32)

    def jax_out():
        from svt_av1_tpu.ops import restoration as jr
        f0, f1 = jr.selfguided_restoration(ext, eps, h, w)
        return f0, f1, jr.apply_selfguided(ext, eps, xqd0, xqd1, h, w)

    f0, f1, out = port_refs.jax_ref(f"lr_sgr_{eps}", jax_out, ext, xqd0,
                                    xqd1)
    g0, g1 = rst.selfguided_restoration(T(ext), eps, h, w)
    r0, r1 = rst.sgr_params(eps)[:2]
    if r0:
        np.testing.assert_array_equal(g0.numpy(), f0)
    if r1:
        np.testing.assert_array_equal(g1.numpy(), f1)
    got = rst.apply_selfguided(T(ext), eps, T(xqd0), T(xqd1), h, w)
    np.testing.assert_array_equal(got.numpy(), out)


@pytest.mark.parametrize("denom", range(9, 17))
def test_superres_upscale_matches_jax(denom):
    out_w = 96
    in_w = resize.scaled_width(out_w, denom)
    rng = np.random.default_rng(denom)
    plane = rng.integers(0, 256, (2, 6, in_w)).astype(np.int32)

    def jax_out():
        from svt_av1_tpu.ops import resize as jz
        return (jz.superres_upscale(plane, out_w),)

    (want,) = port_refs.jax_ref(f"superres_{denom}", jax_out, plane)
    got = resize.superres_upscale(T(plane), out_w).numpy()
    np.testing.assert_array_equal(got, want)


def test_windows_match_reference_window():
    """Every chunk's window, gathered on the device through the plan's
    index maps, equals the reference's numpy _window (stripe-boundary
    rows from the deblocked planes, edge replication), at a size with
    several stripes and units per plane."""
    from svt_av1_tpu.pipeline import lr_stage as jst
    h, w = 200, 400
    rng = np.random.default_rng(5)
    cdef = {p: rng.integers(0, 256, s).astype(np.uint8) for p, s in
            (("y", (h, w)), ("u", (h // 2, w // 2)), ("v", (h // 2, w // 2)))}
    deb = {p: rng.integers(0, 256, a.shape).astype(np.uint8)
           for p, a in cdef.items()}
    bounds = jst.save_boundaries(deb)
    n = 0
    for p, info in zip("yuv", lr_mod.make_lr_info(w, h)):
        plane = cdef[p].astype(np.int32)
        H, W = plane.shape
        ss = int(p != "y")
        pl = lr_stage._plan(H, W, info.unit_size, ss, (h, h // 2, h // 2))
        rows, cols, _, _, valid = pl.on(torch.device("cpu"))
        wins = lr_stage._windows(T(cdef[p]), T(deb[p]), rows, cols).numpy()
        b = 0
        for (_, _, v0, uh, x, uw) in pl.units:
            for (y, ch, ca, cb, stripe) in jst._stripe_chunks(v0, v0 + uh,
                                                              H, ss):
                want = jst._window(plane, bounds[p], y, x, ch, uw, ca, cb,
                                   stripe, 1)
                np.testing.assert_array_equal(
                    wins[b, :ch + 6, :uw + 7], want, err_msg=f"{p} {b}")
                assert valid[b].sum() == ch * uw
                b += 1
        assert b == pl.n
        n += b
    assert n > 20


def test_padded_batch_equals_single_windows():
    """Chunks of different sizes padded into one batch give, on each
    chunk's own samples, what each window gives alone (Wiener and every
    self-guided radius pair)."""
    rng = np.random.default_rng(8)
    sizes = [(8, 20), (13, 17), (5, 9)]
    hm, wm = 13, 20
    batch = np.zeros((3, hm + 6, wm + 7), np.int32)
    singles = []
    for i, (h, w) in enumerate(sizes):
        win = rng.integers(0, 256, (h + 6, w + 7)).astype(np.int32)
        singles.append(win)
        batch[i, :h + 6, :w + 7] = win
        batch[i, h + 6:, :] = rng.integers(0, 256, (hm - h, wm + 7))
        batch[i, :, w + 7:] = rng.integers(0, 256, (hm + 6, wm - w))
    taps = _taps(rng, 3)
    res = rst.wiener_filter(T(batch), T(taps), T(taps), wm, hm)
    for i, (h, w) in enumerate(sizes):
        one = rst.wiener_filter(T(singles[i][None]), T(taps[i:i + 1]),
                                T(taps[i:i + 1]), w, h)[0]
        assert torch.equal(res[i, :h, :w], one)
    for eps in (0, 10, 14):
        f = rst.selfguided_restoration(T(batch[:, :, :wm + 6]), eps, hm, wm)
        for i, (h, w) in enumerate(sizes):
            g = rst.selfguided_restoration(
                T(singles[i][None, :, :w + 6]), eps, h, w)
            for a, b in zip(f, g):
                assert torch.equal(a[i, :h, :w], b[0])


@pytest.mark.parametrize("r0,r1", [(2, 1), (2, 0), (0, 1)])
def test_xq_from_sums_matches_solve_xq(r0, r1):
    """The projection solve from the five integer dot products equals the
    reference's _solve_xq on the arrays (whose float64 dots are exact)."""
    from svt_av1_tpu.pipeline import lr_stage as jst
    rng = np.random.default_rng(r0 * 3 + r1)
    for _ in range(20):
        n = int(rng.integers(50, 4000))
        u = rng.integers(0, 256, n) << 4
        s = np.clip(u + rng.integers(-300, 300, n), 0, 4080)
        f0 = np.clip(u + rng.integers(-500, 500, n), 0, 4095)
        f1 = np.clip(u + (s - u) // 2 + rng.integers(-200, 200, n), 0, 4095)
        f0d, f1d, d = f0 - u, f1 - u, s - u
        sums = [int(a @ b) for a, b in ((f0d, f0d), (f1d, f1d), (f0d, f1d),
                                         (f0d, d), (f1d, d))]
        assert lr_stage._xq_from_sums(sums, r0, r1) == \
            jst._solve_xq(u, f0, f1, s, r0, r1)


LR_EPS = {"m10": (0, 4, 8, 12), "m0": tuple(range(16))}


def _unit_array(info):
    """Per plane and unit: type, parameter set, xqd and Wiener taps."""
    out = []
    for p in info:
        for row in p.units:
            for u in row:
                sg = u.sgrproj or lr_mod.SgrprojInfo(-1, (0, 0))
                wi = u.wiener or lr_mod.WienerInfo((0, 0, 0), (0, 0, 0))
                out.append([u.rtype, sg.ep, *sg.xqd, *wi.vfilter,
                            *wi.hfilter])
    return np.array(out, np.int32)


@pytest.mark.parametrize("preset", sorted(LR_EPS))
@pytest.mark.parametrize("exact", [False, True])
def test_search_lr_matches_jax(preset, exact):
    """Unit choices on a 128x96 frame with M10's four parameter sets and
    M0's sixteen: Wiener for luma, self-guided (r1 alone, and both radii)
    for chroma; RESTORE_NONE everywhere where the planes equal the source.
    The restored planes equal the reference's apply."""
    src, deb, cdef = clips.lr_planes(exact=exact)
    eps = LR_EPS[preset]

    def jax_out():
        from svt_av1_tpu.codec import lr as jlr
        from svt_av1_tpu.pipeline import lr_stage as jst
        info = jlr.make_lr_info(128, 96)
        bounds = jst.save_boundaries(deb)
        jst.search_lr(src, cdef, bounds, info, eps_set=eps)
        out = jst.apply_lr(cdef, bounds, info)
        return (_unit_array(info),) + tuple(np.asarray(out[k])
                                            for k in "yuv")

    want = port_refs.jax_ref(
        f"lr_search_{preset}_{int(exact)}", jax_out,
        *[d[k] for d in (src, deb, cdef) for k in "yuv"], np.array(eps))
    info = lr_mod.make_lr_info(128, 96)
    tcdef = {k: T(v) for k, v in cdef.items()}
    tdeb = {k: T(v) for k, v in deb.items()}
    lr_stage.search_lr(src, tcdef, tdeb, info, eps_set=eps)
    units = _unit_array(info)
    print(f"{preset} exact={exact}: units (type, ep, xqd, taps) "
          f"{units.tolist()}")
    np.testing.assert_array_equal(units, want[0])
    out = lr_stage.apply_lr(tcdef, tdeb, info)
    for k, ref in zip("yuv", want[1:]):
        np.testing.assert_array_equal(out[k].numpy(), ref)
    kinds = set(units[:, 0].tolist())
    assert kinds == ({lr_mod.RESTORE_NONE} if exact else
                     {lr_mod.RESTORE_WIENER, lr_mod.RESTORE_SGRPROJ})


def test_apply_lr_mixed_units_matches_jax():
    """apply_lr at 400x200 (several stripes and units a plane) with units
    of every kind: NONE, Wiener and self-guided at several parameter sets
    in one plane."""
    h, w = 200, 400
    rng = np.random.default_rng(12)
    cdef = {p: rng.integers(0, 256, s).astype(np.uint8) for p, s in
            (("y", (h, w)), ("u", (h // 2, w // 2)), ("v", (h // 2, w // 2)))}
    deb = {p: rng.integers(0, 256, a.shape).astype(np.uint8)
           for p, a in cdef.items()}
    kinds = []
    for p in lr_mod.make_lr_info(w, h):
        for row in p.units:
            for _ in row:
                k = int(rng.integers(0, 3))
                taps = [int(rng.integers(lo, hi + 1))
                        for _ in range(2)
                        for lo, hi, _, _ in lr_mod.WIENER_TAPS]
                kinds.append([k, int(rng.integers(0, 16)),
                              int(rng.integers(-96, 32)),
                              int(rng.integers(-32, 96)), *taps])
    kinds = np.array(kinds, np.int32)

    def make(lrm):
        info = lrm.make_lr_info(w, h)
        i = 0
        for p in info:
            for row in p.units:
                for j in range(len(row)):
                    k = kinds[i]
                    row[j] = lrm.RestUnitInfo(
                        rtype=int(k[0]),
                        sgrproj=lrm.SgrprojInfo(int(k[1]), (int(k[2]),
                                                            int(k[3]))),
                        wiener=lrm.WienerInfo(tuple(int(x) for x in k[4:7]),
                                              tuple(int(x) for x in k[7:])))
                    i += 1
        return info

    def jax_out():
        from svt_av1_tpu.codec import lr as jlr
        from svt_av1_tpu.pipeline import lr_stage as jst
        out = jst.apply_lr(cdef, jst.save_boundaries(deb), make(jlr))
        return tuple(np.asarray(out[k]) for k in "yuv")

    want = port_refs.jax_ref("lr_apply_mixed", jax_out, kinds,
                             *[d[k] for d in (cdef, deb) for k in "yuv"])
    out = lr_stage.apply_lr({k: T(v) for k, v in cdef.items()},
                            {k: T(v) for k, v in deb.items()}, make(lr_mod))
    for k, ref in zip("yuv", want):
        np.testing.assert_array_equal(out[k].numpy(), ref)
    assert {0, 1, 2} <= set(kinds[:, 0].tolist())
