"""The port's 10-bit all-intra encode against the JAX package on the CPU.

- Ops at 10 bits against the JAX functions: the quantizer tables of
  every qindex (exact); the forward transforms under the 10-bit tie rule
  (tests/tie_rule.py: a coefficient may differ by one only where its
  exact value lies within the float32 error bound of the two matrix
  products of a half-integer); the film-grain estimate (equal
  parameters); exact against the JAX outputs stored in
  tests/golden/torch_port_refs.npz (eager JAX calls would take about 40
  s): the inverse transform at every size and type, the intra
  predictors with the unavailable-edge base values, filter-intra and
  CfL, DLF, CDEF, Wiener, the self-guided filters and the superres
  upscale.
- K1's plain version (ops/fused_txq.py) at 10-bit residuals against the
  JAX path that stands for the Pallas kernel on the CPU (fwd_txfm2d +
  quantize): coefficients under the 10-bit tie rule, qcoeff / dqcoeff
  exact on the coefficients.  Flat +-1023 blocks drive |coeff| + round
  past the quantizer's int16 clamp, which both packages keep.
- Streams, each byte-identical to the JAX package's stored stream (the
  same qindex sequence under rate control), decoded exactly to
  Packet.recon (uint16) by the port's decoder, and by the JAX package's
  decoder (its stored output): send_picture at M10 with DLF + CDEF + LR,
  M6 (tx search, CfL, no palette at 10 bits), M4 (varpart, filter-intra,
  per-SB CDEF), superres + LR, film grain, AQ 1, one-pass CBR with one
  recode, send_pictures x2 at M10 (the per-block route, K1 on every
  luma wave); at 8 bits encoder_color_format=3 (read nowhere: 4:2:0,
  as in the reference) and a levels-3 GOP with a scene cut.
- A 10-bit GOP raises NotImplementedError naming its ROADMAP.md item.
"""
import functools

import numpy as np
import pytest
import torch

import clips
import port_refs
import test_torch_rate_control as trc
import tie_rule
from svt_av1_tpu_torch.api.encoder import Encoder, EncoderConfig
from svt_av1_tpu_torch.codec import constants as cc
from svt_av1_tpu_torch.codec import obu
from svt_av1_tpu_torch.codec.decoder import Decoder
from svt_av1_tpu_torch.ops import cdef as tcdef
from svt_av1_tpu_torch.ops import dlf as tdlf
from svt_av1_tpu_torch.ops import fused_txq, intra, quant, resize
from svt_av1_tpu_torch.ops import restoration as rst
from svt_av1_tpu_torch.ops import transforms as tf
from svt_av1_tpu_torch.pipeline import intra_encoder as tie
from svt_av1_tpu_torch.pipeline import noise_model

torch.set_num_threads(2)
BD = 10
T = lambda a: torch.from_numpy(np.ascontiguousarray(a))
FILTERS = dict(enable_dlf_flag=1, cdef_level=1)
LR = dict(enable_restoration_filtering=1, **FILTERS)


# ------------------------------------------------------------------ ops ---

@pytest.mark.parametrize("dc_delta,ac_delta", [(0, 0), (-6, 9), (15, -4)])
def test_quant_tables_10bit(dc_delta, ac_delta):
    from svt_av1_tpu.ops import quant as jquant
    for q in range(256):
        ref = jquant.make_quant_params(q, dc_delta, ac_delta, bd=BD)
        got = quant.make_quant_params(q, dc_delta, ac_delta, bd=BD)
        for a, b in zip(ref, got):
            assert a.dtype == b.dtype and np.array_equal(a, b), q
        assert tie.frame_lambda(q, BD) == np.float32(
            0.7 * (jquant.dc_q(q, bd=BD) / 8.0) ** 2)


def _tx_cases():
    """Every (size, legal type) pair with a 10-bit batch of dequantized
    coefficients (in the range an int16 level times a 10-bit step
    reaches, mostly small) and predictions."""
    import golden_defs as gd
    rng = np.random.default_rng(10)
    for tx_size in range(cc.TX_SIZES_ALL):
        h, w = int(cc.tx_size_high[tx_size]), int(cc.tx_size_wide[tx_size])
        for tx_type in gd.legal_tx_types(tx_size):
            c = rng.integers(-12000, 12001, (4, h, w)).astype(np.int32)
            c[rng.random(c.shape) < 0.8] //= 40
            p = rng.integers(0, 1 << BD, (4, h, w)).astype(np.int32)
            yield tx_size, tx_type, c, p


def test_inv_txfm_10bit_every_size_and_type():
    cases = list(_tx_cases())

    def jax_out():
        import jax.numpy as jnp
        from svt_av1_tpu.ops import transforms as jtf
        return tuple(np.asarray(jtf.inv_txfm2d_add(
            jnp.asarray(c), jnp.asarray(p), t, s, bd=BD))
            for s, t, c, p in cases)

    refs = port_refs.jax_ref(
        "tenbit_inv_txfm", jax_out,
        *[a for _, _, c, p in cases for a in (c, p)],
        np.array([(s, t) for s, t, _, _ in cases], np.int32))
    clipped = 0
    for (s, t, c, p), ref in zip(cases, refs):
        got = tf.inv_txfm2d_add(T(c), T(p), t, s, bd=BD).numpy()
        assert np.array_equal(got, ref), (s, t)
        clipped += int((got == (1 << BD) - 1).sum())
    assert len(cases) > 150 and clipped > 0


@pytest.mark.parametrize("tx_size,tx_type", [
    (cc.TX_16X16, cc.DCT_DCT), (cc.TX_16X16, cc.ADST_ADST),
    (cc.TX_16X16, cc.ADST_DCT), (cc.TX_16X16, cc.DCT_ADST),
    (cc.TX_8X8, cc.DCT_DCT), (cc.TX_8X8, cc.ADST_ADST),
    (cc.TX_32X32, cc.DCT_DCT)])
def test_fwd_txfm_10bit_tie_rule(tx_size, tx_type):
    import jax.numpy as jnp
    from svt_av1_tpu.ops import transforms as jtf
    n = int(cc.tx_size_wide[tx_size])
    rng = np.random.default_rng(40 + tx_type + tx_size)
    resid = rng.integers(-1023, 1024, (400, n, n)).astype(np.int32)
    resid[:20] = 1023 * np.where(rng.random((20, 1, 1)) < 0.5, -1, 1)
    ref = np.asarray(jtf.fwd_txfm2d(jnp.asarray(resid), tx_type, tx_size))
    got = tf.fwd_txfm2d(T(resid), tx_type, tx_size).numpy()
    fv, fh, ud, lr = tf._fwd_matrices(tx_type, tx_size)
    x = resid[:, ::-1] if ud else resid
    x = x[:, :, ::-1] if lr else x
    n_bad, maxd, worst = tie_rule.tie_mismatches_bounded(
        got, ref, tie_rule.exact_coeffs(x, fv, fh),
        tie_rule.coeff_error_bound(x, fv, fh))
    print(f"10-bit tie mismatches: {n_bad} of {got.size}, max |diff| "
          f"{maxd}, largest distance to .5 {worst:.3g}")
    assert np.abs(ref).max() > 1 << 15    # at 8 bits: a quarter of it


def _neighbors10(n, b, seed):
    rng = np.random.default_rng(seed)
    above = rng.integers(0, 1 << BD, (b, n)).astype(np.int32)
    left = rng.integers(0, 1 << BD, (b, n)).astype(np.int32)
    corner = rng.integers(0, 1 << BD, (b,)).astype(np.int32)
    ha, hl = rng.random(b) < 0.6, rng.random(b) < 0.6
    return above, left, corner, ha, hl


@pytest.mark.parametrize("n", [16, 8])
def test_intra_predictors_10bit(n):
    """Every luma mode of the ladder with random availability (DC's
    unavailable-edge value is 1 << (bd - 1)), exact; the neighbour
    gather substitutes base +- 1 at frame edges."""
    above, left, corner, ha, hl = _neighbors10(n, 24, 7 + n)
    modes = (tie.MODES[:6] + (cc.SMOOTH_V_PRED, cc.SMOOTH_H_PRED)
             + tie.MODES[6:])
    plane = np.random.default_rng(n).integers(
        0, 1 << BD, (64, 64)).astype(np.int32)
    ys = np.array([0, 0, 16, 16, 32], np.int32)
    xs = np.array([0, 16, 0, 16, 32], np.int32)
    a, l = ys > 0, xs > 0

    def jax_out():
        import jax.numpy as jnp
        from svt_av1_tpu.ops import intra as jintra
        from svt_av1_tpu.pipeline import intra_encoder as jie
        preds = [np.asarray(jintra.predict(
            mode, jnp.asarray(above), jnp.asarray(left),
            jnp.asarray(corner), n, n, have_above=jnp.asarray(ha),
            have_left=jnp.asarray(hl), bd=BD)) for mode in modes]
        return tuple(preds) + tuple(jie._gather_neighbors(
            jnp.asarray(plane), jnp.asarray(ys), jnp.asarray(xs), n,
            jnp.asarray(a), jnp.asarray(l), bd=BD))

    refs = port_refs.jax_ref(f"tenbit_intra_{n}", jax_out, above, left,
                             corner, ha, hl, plane, ys, xs)
    for mode, ref in zip(modes, refs):
        got = intra.predict(mode, T(above), T(left), T(corner), n, n,
                            have_above=T(ha), have_left=T(hl), bd=BD)
        assert np.array_equal(got.numpy(), ref), mode
    got = tie._gather_neighbors(T(plane)[None], torch.zeros(5).long(),
                                T(ys).long(), T(xs).long(), n, T(a), T(l),
                                bd=BD)
    for g, r in zip(got, refs[len(modes):]):
        assert np.array_equal(g.numpy(), r)
    assert got[0][0, 0].item() == (1 << (BD - 1)) - 1


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_filter_intra_and_cfl_10bit(n):
    above, left, corner, _, _ = _neighbors10(n, 12, 50 + n)
    # bright and dark edges drive the filter past both ends of the range
    above[:4], left[:4] = 1023, 0
    rng = np.random.default_rng(n)
    luma = rng.integers(0, 1 << BD, (12, 2 * n, 2 * n)).astype(np.int32)
    dc = rng.integers(0, 1 << BD, (12, n, n)).astype(np.int32)
    alpha = rng.integers(-16, 17, 12).astype(np.int32)

    def jax_out():
        import jax.numpy as jnp
        from svt_av1_tpu.ops import intra as jintra
        fi = jintra.filter_intra_pred_multi(
            jnp.asarray(above), jnp.asarray(left), jnp.asarray(corner),
            tuple(range(5)), n, n, bd=BD)
        ac = jintra.cfl_ac_420(jnp.asarray(luma), n, n)
        return fi, ac, jintra.cfl_predict(jnp.asarray(dc), ac,
                                          jnp.asarray(alpha), bd=BD)

    fi, ac, cfl = port_refs.jax_ref(f"tenbit_fi_cfl_{n}", jax_out, above,
                                    left, corner, luma, dc, alpha)
    got = intra.filter_intra_pred_multi(T(above), T(left), T(corner),
                                        tuple(range(5)), n, n, bd=BD)
    assert np.array_equal(got.numpy(), fi)
    assert got.max() == (1 << BD) - 1 and got.min() == 0
    got_ac = intra.cfl_ac_420(T(luma), n, n)
    assert np.array_equal(got_ac.numpy(), ac)
    got = intra.cfl_predict(T(dc), got_ac, T(alpha), bd=BD)
    assert np.array_equal(got.numpy(), cfl)


def test_dlf_10bit():
    """filter_lines at every length and a blocky plane through the uniform
    filter, at 10 bits (thresholds and clamps shifted by bd - 8)."""
    rng = np.random.default_rng(3)
    base = rng.integers(80, 944, (600, 1))
    step = np.where(np.arange(14) >= 7, 1, 0)[None]
    lines = np.clip(base + np.cumsum(rng.integers(-4, 5, (600, 14)), 1)
                    + step * rng.integers(-200, 201, (600, 1)), 0,
                    1023).astype(np.int32)
    yy, xx = np.mgrid[0:64, 0:96]
    off = rng.integers(-16, 17, (5, 7))
    plane = np.clip(360 + xx * 4 // 3 + yy + off[yy // 16, xx // 16]
                    + rng.integers(0, 4, (64, 96)), 0, 1023).astype(np.int32)
    grid = [(level, flen) for level in (8, 32, 63) for flen in (4, 6, 8, 14)]

    def jax_out():
        import jax.numpy as jnp
        from svt_av1_tpu.ops import dlf as jdlf
        return tuple(jdlf.filter_lines(
            lines, *jdlf.loop_filter_thresholds(lv, 0), fl, bd=BD)
            for lv, fl in grid) + (jdlf.loop_filter_plane_uniform(
                jnp.asarray(plane), 16, 24, 0, 14, bd=BD),)

    refs = port_refs.jax_ref("tenbit_dlf", jax_out, lines, plane)
    changed = 0
    for (level, flen), ref in zip(grid, refs):
        thr = tdlf.loop_filter_thresholds(level, 0)
        got = tdlf.filter_lines(T(lines), *thr, flen, bd=BD).numpy()
        assert np.array_equal(got, ref), (level, flen)
        changed += int((got != lines).any(axis=1).sum())
    assert changed > 500
    got = tdlf.loop_filter_plane_uniform(T(plane), 16, 24, 0, 14, bd=BD)
    assert np.array_equal(got.numpy(), refs[-1])
    assert (refs[-1] != plane).any()


def test_cdef_10bit():
    """The direction search on 10-bit blocks (shifted by coeff_shift 2)
    and the filter at shifted strengths and damping, exact."""
    rng = np.random.default_rng(8)
    blocks = rng.integers(0, 1 << BD, (200, 8, 8)).astype(np.int32)
    ii, jj = np.mgrid[0:8, 0:8]
    blocks[:8] = ((ii + (np.arange(8)[:, None, None] - 3) * jj) // 2 % 2
                  * 1023)
    grid = []
    for n in (8, 4):
        wins = rng.integers(0, 1 << BD, (96, n + 4, n + 4)).astype(np.int32)
        wins[::3, :2] = tcdef.CDEF_VERY_LARGE
        pri = (rng.integers(0, 16, 96) << 2).astype(np.int32)
        sec = (rng.choice([0, 1, 2, 4], 96) << 2).astype(np.int32)
        dirs = rng.integers(0, 8, 96).astype(np.int32)
        grid += [(n, damping, wins, pri, sec, dirs) for damping in (3, 6)]

    def jax_out():
        import jax.numpy as jnp
        from svt_av1_tpu.ops import cdef as jcdef
        return jcdef.cdef_find_dir(jnp.asarray(blocks), 2) + tuple(
            jcdef.cdef_filter_block(
                jnp.asarray(w), jnp.asarray(p), jnp.asarray(s_),
                jnp.asarray(d), dp + 2, dp + 2, 2, BD, n=n)
            for n, dp, w, p, s_, d in grid)

    refs = port_refs.jax_ref("tenbit_cdef", jax_out, blocks,
                             *[a for g in grid for a in g[2:]])
    d_got, v_got = tcdef.cdef_find_dir(T(blocks), 2)
    assert np.array_equal(d_got.numpy(), refs[0])
    assert np.array_equal(v_got.numpy(), refs[1])
    for (n, dp, w, p, s_, d), ref in zip(grid, refs[2:]):
        got = tcdef.cdef_filter_block(T(w), T(p), T(s_), T(d), dp + 2,
                                      dp + 2, 2, BD, n=n)
        assert np.array_equal(got.numpy(), ref), (n, dp)


@pytest.mark.parametrize("eps", [0, 5, 10, 14, 15])
def test_wiener_and_selfguided_10bit(eps):
    """Wiener (the bd rounding and intermediate clamp) and the self-guided
    filters with the bd scaling of the box sums, and their projection,
    exact on random 10-bit windows, a flat one included; with Wiener the
    superres upscale, clipped to 1023."""
    from svt_av1_tpu_torch.codec import lr as lr_mod
    h, w = 13, 22
    rng = np.random.default_rng(200 + eps)
    ext = rng.integers(0, 1 << BD, (4, h + 6, w + 7)).astype(np.int32)
    ext[1] = ext[1, 0, 0]
    sext = ext[:, :, :w + 6]
    if eps == 0:
        taps = np.zeros((2, 4, 8), np.int32)
        for i in range(2):
            for b in range(4):
                t = [int(rng.integers(lo, hi + 1))
                     for lo, hi, _, _ in lr_mod.WIENER_TAPS]
                taps[i, b] = [t[0], t[1], t[2], -2 * sum(t), t[2], t[1],
                              t[0], 0]
        plane = rng.integers(0, 1 << BD, (2, 6, 48)).astype(np.int32)
        plane[:, :, ::5] = 1023

        def jax_out():
            from svt_av1_tpu.ops import resize as jz
            from svt_av1_tpu.ops import restoration as jr
            return (jr.wiener_filter(ext, taps[0], taps[1], w, h, bd=BD),
                    jz.superres_upscale(plane, 96, bd=BD),
                    jz.superres_upscale(plane, 64, bd=BD))

        ref, up96, up64 = port_refs.jax_ref("tenbit_wiener", jax_out, ext,
                                            taps, plane)
        got = rst.wiener_filter(T(ext), T(taps[0]), T(taps[1]), w, h,
                                bd=BD)
        assert np.array_equal(got.numpy(), ref)
        for out_w, want in ((96, up96), (64, up64)):
            got = resize.superres_upscale(T(plane), out_w, bd=BD).numpy()
            assert np.array_equal(got, want) and got.max() <= 1023
        return
    xqd0 = rng.integers(-96, 32, 4).astype(np.int32)
    xqd1 = rng.integers(-32, 96, 4).astype(np.int32)

    def jax_out():
        from svt_av1_tpu.ops import restoration as jr
        f0, f1 = jr.selfguided_restoration(sext, eps, h, w, bd=BD)
        return f0, f1, jr.apply_selfguided(sext, eps, xqd0, xqd1, h, w,
                                           bd=BD)

    f0, f1, ref = port_refs.jax_ref(f"tenbit_sgr_{eps}", jax_out, sext,
                                    xqd0, xqd1)
    g0, g1 = rst.selfguided_restoration(T(sext), eps, h, w, bd=BD)
    r0, r1 = rst.sgr_params(eps)[:2]
    if r0:
        assert np.array_equal(g0.numpy(), f0)
    if r1:
        assert np.array_equal(g1.numpy(), f1)
    got = rst.apply_selfguided(T(sext), eps, T(xqd0), T(xqd1), h, w, bd=BD)
    assert np.array_equal(got.numpy(), ref)


def test_noise_model_10bit():
    """The film-grain estimate of a 10-bit grainy picture: the same
    parameters as the JAX package's (host numpy in both)."""
    import dataclasses
    from svt_av1_tpu.pipeline import noise_model as jnm
    y, u, v = clips.to_10bit([clips.grain_frame()], seed=4)[0]
    ref, _ = jnm.estimate_grain_params(y, u, v, bd=BD)
    got, _ = noise_model.estimate_grain_params(y, u, v, bd=BD)
    assert got is not None and ref is not None
    a, b = dataclasses.asdict(got), dataclasses.asdict(ref)
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


# ------------------------------------------------------ K1 at 10 bits ---

def _k1_resid(b, seed):
    """(b, 16, 16) 10-bit residuals: uniform in [-1023, 1023], the first
    eight blocks flat at +-1023 (their DC passes the int16 clamp)."""
    rng = np.random.default_rng(seed)
    resid = rng.integers(-1023, 1024, (b, 16, 16)).astype(np.int32)
    resid[:8] = 1023 * np.array([1, -1] * 4, np.int32)[:, None, None]
    return resid


@pytest.mark.parametrize("qindex", [1, 35, 128, 255])
def test_fused_txq_plain_10bit(qindex):
    """K1's plain version against fwd_txfm2d + quantize of the JAX
    package (the path that stands for the Pallas kernel on the CPU) at
    make_quant_params(q, bd=10): coefficients under the 10-bit tie rule,
    the quantizer exact on each side's coefficients, the saturated blocks
    exact."""
    import jax.numpy as jnp
    from svt_av1_tpu.ops import quant as jquant
    from svt_av1_tpu.ops import transforms as jtf
    resid = _k1_resid(300, qindex)
    jqp = jquant.make_quant_params(qindex, bd=BD)
    jc = jtf.fwd_txfm2d(jnp.asarray(resid), cc.DCT_DCT, cc.TX_16X16)
    jq, jd = jquant.quantize(jc, jqp, cc.TX_16X16)
    qp = quant.to_device(quant.make_quant_params(qindex, bd=BD), "cpu")
    c, q, d = fused_txq.fused_txq(T(resid), qp)
    fv, fh, _, _ = tf._fwd_matrices(cc.DCT_DCT, cc.TX_16X16)
    n_bad, maxd, worst = tie_rule.tie_mismatches_bounded(
        c.numpy(), np.asarray(jc), tie_rule.exact_coeffs(resid, fv, fh),
        tie_rule.coeff_error_bound(resid, fv, fh))
    print(f"qindex {qindex}: {n_bad} of {c.numel()} coefficients differ "
          f"(max |diff| {maxd}, largest distance to .5 {worst:.3g})")
    q2, d2 = quant.quantize(c, qp, cc.TX_16X16)
    assert torch.equal(q, q2) and torch.equal(d, d2)
    jq2, jd2 = jquant.quantize(jnp.asarray(c.numpy()), jqp, cc.TX_16X16)
    assert np.array_equal(q.numpy(), np.asarray(jq2))
    assert np.array_equal(d.numpy(), np.asarray(jd2))
    assert np.array_equal(q.numpy()[:8], np.asarray(jq)[:8])
    assert np.array_equal(d.numpy()[:8], np.asarray(jd)[:8])


def test_quantizer_saturates_at_10_bits():
    """A flat 1023 block's DC (130,972) plus the rounding passes 32767,
    so at qindex 1 the JAX quantizer, the port's plain quantizer and K1's
    plain version all clamp |coeff| + round to int16 before the multiply
    (svt_av1_tpu/ops/quant.py:127): the same level, far below what the
    unclamped value gives (ROADMAP.md queue C item 3: a reference
    behaviour the port keeps)."""
    import jax.numpy as jnp
    from svt_av1_tpu.ops import quant as jquant
    resid = np.full((1, 16, 16), 1023, np.int32)
    coeff = tf.fwd_txfm2d(T(resid), cc.DCT_DCT, cc.TX_16X16)
    dc = int(coeff[0, 0, 0])
    assert dc > 3 * 32767 and int(coeff.abs().sum()) == dc
    jqp = jquant.make_quant_params(1, bd=BD)
    qp = quant.to_device(quant.make_quant_params(1, bd=BD), "cpu")
    jq, _ = jquant.quantize(jnp.asarray(coeff.numpy()), jqp, cc.TX_16X16)
    pq, _ = quant.quantize(coeff, qp, cc.TX_16X16)
    _, kq, _ = fused_txq.fused_txq(T(resid), qp)
    k = [int(a[0, 0, 0]) for a in (np.asarray(jq), pq.numpy(), kq.numpy())]
    # the level of the clamped value, 32767, by the quantizer's formula
    quant_, shift = (int(qp.quant[0]), int(qp.quant_shift[0]))
    sat = ((((32767 * quant_) >> 16) + 32767) * shift) >> 16
    unclamped = dc // int(qp.dequant[0])
    assert k == [sat] * 3 and sat < unclamped // 2


# -------------------------------------------------------------- streams ---

def _recode_clip10():
    """The rate-control recode clip at 10 bits: five smooth 128x96
    frames, a random one, three more smooth ones."""
    smooth = clips.natural_clip10(8, 128, 96, seed=2)
    rng = np.random.default_rng(0)
    noise = tuple(rng.integers(0, 1 << BD, s).astype(np.uint16)
                  for s in ((96, 128), (48, 64), (48, 64)))
    return smooth[:5] + [noise] + smooth[5:]


TEN = dict(encoder_bit_depth=BD)
# name: (frames, route ("picture": send_picture / flush; "pictures":
# send_pictures, eos), EncoderConfig fields; qp 35 unless given)
CASES = {
    "m10_lr": (lambda: clips.natural_clip10(1, 128, 96, seed=4), "picture",
               dict(LR, **TEN)),
    "m6": (lambda: clips.natural_clip10(1, 64, 64, seed=5)
           + clips.to_10bit([clips.screen_frame(64, 64, seed=1)]),
           "picture", dict(enc_mode=6, **FILTERS, **TEN)),
    "m4": (lambda: clips.to_10bit([clips.varpart_frame()]), "picture",
           dict(enc_mode=4, **FILTERS, **TEN)),
    "superres_lr": (lambda: clips.natural_clip10(1, 160, 96, seed=5),
                    "picture", dict(superres_mode=1, qp=40, **LR, **TEN)),
    "film_grain": (lambda: clips.to_10bit([clips.grain_frame()], seed=4),
                   "picture", dict(film_grain_denoise_strength=8, qp=40,
                                   **TEN)),
    "aq1": (lambda: clips.to_10bit([clips.varpart_frame()]), "picture",
            dict(enable_adaptive_quantization=1, **TEN)),
    "cbr_recode": (_recode_clip10, "picture",
                   dict(rate_control_mode=2, target_bit_rate=150_000,
                        qp=30, **TEN)),
    "pictures_m10": (lambda: clips.natural_clip10(2, 64, 64, seed=6),
                     "pictures", dict(enable_dlf_flag=1, **TEN)),
    "color_format_3": (lambda: clips.natural_clip(1, 64, 64, seed=7),
                       "picture", dict(encoder_color_format=3)),
    "scene_cut_gop": (clips.scene_cut_clip, "picture",
                      dict(intra_period_length=15, hierarchical_levels=3)),
}


def config(cls, name, frames):
    h, w = frames[0][0].shape
    return cls(source_width=w, source_height=h,
               **dict(dict(qp=35), **CASES[name][2]))


def drive(enc, route, frames):
    if route == "pictures":
        enc.send_pictures(frames, eos=True)
    else:
        for f in frames:
            enc.send_picture(*f)
        enc.flush()
    return list(iter(enc.get_packet, None))


def qindices(datas):
    """base_q_idx of every frame OBU of a stream."""
    return trc.qindices(obu, datas)


def jax_stream(name, frames, port_datas):
    """The JAX package's stream of a case (packet count, packet bytes,
    the shown recon planes) and its decoder's frames of the port's
    stream (none where its decoder raises)."""
    from svt_av1_tpu.api.config import EncoderConfig as JConfig
    from svt_av1_tpu.api.encoder import Encoder as JEncoder
    from svt_av1_tpu.codec.decoder import Decoder as JDecoder
    pkts = drive(JEncoder(config(JConfig, name, frames)), CASES[name][1],
                 frames)
    shown = [p for p in pkts if p.displayed]
    dec = JDecoder()
    got = [r for d in port_datas for r in dec.decode_temporal_unit(d)]
    out = [np.array([len(pkts)])]
    out += [np.frombuffer(p.data, np.uint8) for p in pkts]
    out += [np.stack([p.recon[k] for p in shown]) for k in "yuv"]
    out += [np.stack([np.asarray(r[k]) for r in got]) for k in "yuv"]
    return out


def encode(name, frames, device="cpu"):
    """The port's packets of a case on ``device``."""
    return drive(Encoder(config(EncoderConfig, name, frames), device=device),
                 CASES[name][1], frames)


def stored(name, frames, datas):
    """The JAX package's stored outputs of a case whose port stream is
    ``datas`` (its packets' bytes are part of the fingerprint): packet
    bytes, shown recon, its decoder's frames of the port's stream;
    computed live while tools/make_torch_port_refs.py records."""
    ref = port_refs.jax_ref(
        f"tenbit_{name}", lambda: jax_stream(name, frames, datas),
        *[a for f in frames for a in f],
        np.array(sorted(CASES[name][2].items()), str),
        *[np.frombuffer(d, np.uint8) for d in datas])
    n = int(ref[0][0])
    planes = lambda i0: [dict(y=ref[i0][j], u=ref[i0 + 1][j],
                              v=ref[i0 + 2][j])
                         for j in range(len(ref[i0]))]
    return dict(data=[bytes(a) for a in ref[1:1 + n]], recon=planes(1 + n),
                decoded=planes(4 + n))


@functools.lru_cache(maxsize=None)
def run_case(name):
    """(frames, the port's packets, the JAX package's stored outputs)."""
    frames = CASES[name][0]()
    pkts = encode(name, frames)
    return frames, pkts, stored(name, frames, [p.data for p in pkts])


@pytest.mark.parametrize("name", sorted(CASES))
def test_stream_matches_jax(name):
    """Byte-identical to the JAX package's stream, with the same qindex
    sequence, and the same recon planes."""
    _, pkts, jax = run_case(name)
    assert [p.data for p in pkts] == jax["data"]
    assert qindices(jax["data"]) == qindices([p.data for p in pkts])
    shown = [p for p in pkts if p.displayed]
    for p, r in zip(shown, jax["recon"]):
        for k in "yuv":
            assert np.array_equal(p.recon[k], r[k]), (p.pts, k)
    print(f"{name}: {len(pkts)} packets, {sum(map(len, jax['data']))} "
          f"bytes, qindex {qindices(jax['data'])}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_round_trip_both_decoders(name):
    """The port's decoder and the JAX package's decoder (its stored
    output) decode the port's stream exactly to Packet.recon; 10-bit
    planes come back as uint16."""
    frames, pkts, jax = run_case(name)
    dec = Decoder(device="cpu")
    shown = [r for p in pkts for r in dec.decode_temporal_unit(p.data)]
    recon = [p.recon for p in pkts if p.displayed]
    assert len(shown) == len(recon) == len(jax["decoded"]) == len(frames)
    want = np.uint16 if CASES[name][2].get("encoder_bit_depth") else np.uint8
    for r, p, j in zip(shown, recon, jax["decoded"]):
        for k in "yuv":
            h, w = p[k].shape
            assert r[k].dtype == p[k].dtype == want
            assert np.array_equal(r[k][:h, :w], p[k])
            assert np.array_equal(np.asarray(j[k])[:h, :w], p[k])


def test_tools_show_in_the_streams():
    """Each case codes what it is there for: 10-bit sequence headers, no
    palette at 10 bits, filter-intra at M4, LR units, superres, the grain
    parameters, delta-q, a recode (the qindex of pts 5 raised), a key
    frame at the scene cut."""
    hdr = {}
    for name in CASES:
        dec = Decoder(device="cpu")
        fps = []
        for p in run_case(name)[1]:
            dec.decode_temporal_unit(p.data)
            fps.append(dec.last_frame_header)
        hdr[name] = (dec.sp, fps, dec.last_decisions)
    for name, (sp, fps, _) in hdr.items():
        tenbit = "encoder_bit_depth" in CASES[name][2]
        assert sp.bit_depth == (BD if tenbit else 8), name
        if tenbit:
            assert not sp.enable_screen_content
    assert any(d.filter_intra_mode >= 0 for d in hdr["m4"][2].values())
    assert any(t != 0 for t in hdr["m10_lr"][1][0].lr_types)
    assert hdr["superres_lr"][1][0].superres_denom == 16
    assert hdr["film_grain"][1][0].film_grain is not None
    assert hdr["aq1"][1][0].delta_q_present
    q = qindices([p.data for p in run_case("cbr_recode")[1]])
    assert len(q) == 9 and q[5] > q[4]
    kinds = [(p.pts, p.frame_type) for p in run_case("scene_cut_gop")[1]
             if p.displayed]
    assert (5, obu.KEY_FRAME) in kinds and (0, obu.KEY_FRAME) in kinds


def test_recode_at_10_bits():
    """The noise frame at pts 5 overshoots eight times its budget and is
    coded once more at a higher qindex; the frames after it code at the
    JAX package's qindex (test_stream_matches_jax)."""
    frames = CASES["cbr_recode"][0]()
    with trc.recode_spy() as seen:
        drive(Encoder(config(EncoderConfig, "cbr_recode", frames),
                      device="cpu"), "picture", frames)
    assert [pts for pts, _ in seen] == [5]


def test_ten_bit_gop_and_wrong_dtype_raise():
    """A 10-bit GOP is the reference's stage path (not ported); a 10-bit
    encoder takes uint16 planes only."""
    with pytest.raises(NotImplementedError,
                       match="ROADMAP.md queue A item 7"):
        Encoder(EncoderConfig(source_width=64, source_height=64,
                              intra_period_length=15, hierarchical_levels=3,
                              **TEN), device="cpu")
    enc = Encoder(EncoderConfig(source_width=32, source_height=32, **TEN),
                  device="cpu")
    y = np.zeros((32, 32), np.uint8)
    with pytest.raises(ValueError, match="uint16"):
        enc.send_picture(y, y[:16, :16], y[:16, :16])
