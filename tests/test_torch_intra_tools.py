"""The key-frame tools of presets M5-M8 in the port vs the JAX package:
zone-1/zone-3 directional predictors, chroma-from-luma, the tx-type /
angle-delta candidate list, the 16x16 ADST forward transforms, one luma
wave over the 62-candidate list, one chroma wave with CfL, and the
palette candidates.

Tolerances.  Integer ops (predictors, CfL AC and prediction, levels and
recon of agreeing blocks, palette colors/maps/levels) are exact.  Forward
transforms follow the tie rule of tests/tie_rule.py.  Winners of a wave
must agree on >= 99% of the blocks (another float32 summation order may
flip a near-tied argmin).  The CfL alpha is a float32 least-squares fit
whose sum passes 2^24: a block's alphas (and with them its chroma
decision) may differ from JAX only where the float64 value of
64 * sum / den lies within 1e-3 of a half-integer for one of its planes;
every such block is counted and printed.  Palette costs: 1e-3 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import clips
import tie_rule
from svt_av1_tpu.codec import constants as cc
from svt_av1_tpu.codec import rate_est as jrate
from svt_av1_tpu.ops import intra as jintra
from svt_av1_tpu.ops import quant as jquant
from svt_av1_tpu.ops import transforms as jtf
from svt_av1_tpu.pipeline import intra_encoder as jie

from svt_av1_tpu_torch import convert
from svt_av1_tpu_torch.ops import intra as tintra
from svt_av1_tpu_torch.ops import transforms as ttf
from svt_av1_tpu_torch.pipeline import intra_encoder as tie

torch.set_num_threads(2)

MIN_AGREE = 0.99
ALPHA_TIE_EPS = 1e-3
MAX_TIE_SHARE = 1e-3
QINDEX = 140
# every angle the slice's zone-1/zone-3 candidates produce
Z1_ANGLES = (81, 84, 87)        # V-9 .. V-3
Z3_ANGLES = (183, 186, 189)     # H+3 .. H+9

t_ = lambda a: torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("angle", Z1_ANGLES + Z3_ANGLES)
def test_z1_z3_pred_exact(angle):
    n, b = 16, 40
    rng = np.random.default_rng(angle)
    ext = rng.integers(0, 256, (b, 2 * n + 1)).astype(np.int32)
    ext[:, -1] = ext[:, -2]
    if angle < 90:
        ref = jintra.z1_pred(jnp.asarray(ext), n, n, angle)
        got = tintra.z1_pred(t_(ext), n, n, angle)
    else:
        ref = jintra.z3_pred(jnp.asarray(ext), n, n, angle)
        got = tintra.z3_pred(t_(ext), n, n, angle)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(ref))


def test_z1_z3_refuse_other_zones():
    ext = torch.zeros((1, 33), dtype=torch.int32)
    with pytest.raises(ValueError):
        tintra.z1_pred(ext, 16, 16, 135)
    with pytest.raises(ValueError):
        tintra.z3_pred(ext, 16, 16, 90)


def test_cfl_ac_and_predict_exact():
    n, b = 8, 64
    rng = np.random.default_rng(5)
    luma = rng.integers(0, 256, (b, 2 * n, 2 * n)).astype(np.int32)
    luma[:8] = 77                                  # flat blocks: ac == 0
    ac_j = jintra.cfl_ac_420(jnp.asarray(luma), n, n)
    ac_t = tintra.cfl_ac_420(t_(luma), n, n)
    assert np.array_equal(ac_t.numpy(), np.asarray(ac_j))
    dc = rng.integers(0, 256, (b, n, n)).astype(np.int32)
    alpha = rng.integers(-16, 17, b).astype(np.int32)
    ref = jintra.cfl_predict(jnp.asarray(dc), ac_j, jnp.asarray(alpha))
    got = tintra.cfl_predict(t_(dc), ac_t, t_(alpha))
    assert np.array_equal(got.numpy(), np.asarray(ref))
    for a in (-16, -1, 0, 3, 16):                  # scalar alpha
        ref = jintra.cfl_predict(jnp.asarray(dc), ac_j, jnp.int32(a))
        got = tintra.cfl_predict(t_(dc), ac_t, a)
        assert np.array_equal(got.numpy(), np.asarray(ref)), a


@pytest.mark.parametrize("angle_deltas", [False, True])
@pytest.mark.parametrize("nmodes", [8, 6])
def test_expand_tx_cands_equal(nmodes, angle_deltas):
    modes = tie.MODES[:nmodes]
    assert modes == jie.MODES[:nmodes]
    ref = jie.expand_tx_cands(modes, angle_deltas)
    got = tie.expand_tx_cands(modes, angle_deltas)
    assert got == ref
    if nmodes == 8 and angle_deltas:
        assert len(got[0]) == len(got[1]) == 62
    assert tie.TX_SEARCH_SET == jie.TX_SEARCH_SET
    assert tie.ANGLE_DELTAS == jie.ANGLE_DELTAS
    for m, d in got[0]:
        assert tie.cand_angle(m, d) == jie.cand_angle(m, d)


@pytest.mark.parametrize("tx_type", [cc.ADST_ADST, cc.ADST_DCT,
                                     cc.DCT_ADST])
def test_fwd_txfm_16x16_adst_tie_rule(tx_type):
    b = 2000
    rng = np.random.default_rng(40 + tx_type)
    resid = rng.integers(-255, 256, (b, 16, 16)).astype(np.int32)
    ref = np.asarray(jtf.fwd_txfm2d(jnp.asarray(resid), tx_type,
                                    cc.TX_16X16))
    got = ttf.fwd_txfm2d(t_(resid), tx_type, cc.TX_16X16).numpy()
    fv, fh, ud, lr = ttf._fwd_matrices(tx_type, cc.TX_16X16)
    assert not ud and not lr
    exact = tie_rule.exact_coeffs(resid, fv, fh)
    nmis, maxd = tie_rule.tie_mismatches(got, ref, exact)
    print(f"16x16 tx type {tx_type}: {nmis} of {got.size} coefficients "
          f"differ from JAX, all on rounding ties (max |diff| {maxd})")
    assert nmis <= MAX_TIE_SHARE * got.size
    assert (ttf.coeff_sse_scale(cc.TX_16X16, tx_type)
            == pytest.approx(jtf.coeff_sse_scale(cc.TX_16X16, tx_type),
                             rel=1e-6))


def _state(size, seed):
    """(src, recon) int32 planes: a natural picture and a noisy copy of it
    standing for already reconstructed neighbors."""
    rng = np.random.default_rng(seed)
    y = clips.natural_clip(1, size, size, seed)[0][0].astype(np.int32)
    rec = np.clip(y + rng.integers(-6, 7, y.shape), 0, 255).astype(np.int32)
    return y, rec


def _flags(g):
    by, bx = np.divmod(np.arange(g * g), g)
    trbl = np.array([tie.tr_bl_avail(int(r), int(c), g, g)
                     for r, c in zip(by, bx)])
    return by, bx, trbl[:, 0], trbl[:, 1]


def test_luma_wave_62_candidates_matches_jax():
    """One _rd_step over every 16x16 block of a 64x64 state with the M6
    candidate list (tx search + angle deltas), candidate index out."""
    src, recon = _state(64, 1)
    by, bx, tr, bl = _flags(4)
    b = by.size
    cand_modes, cand_txs = tie.expand_tx_cands(tie.MODES, True)
    mode_ids = tuple(m for m, _ in cand_modes)
    qp = jquant.make_quant_params(QINDEX)
    lam = tie.frame_lambda(QINDEX)
    rt = jrate.md_rate_args(QINDEX, mode_ids, tie.UV_MODES, exact=True)
    # jitted, as the JAX package runs it (and quicker than op by op)
    m_j, q_j, r_j = jax.jit(lambda rec, s, rates: jie._rd_step(
        rec, s, jnp.asarray(by * 16),
        jnp.asarray(bx * 16), jnp.ones(b, bool), jnp.asarray(by > 0),
        jnp.asarray(bx > 0), tuple(jnp.asarray(a) for a in qp),
        jnp.float32(lam), 16, cc.TX_16X16, cand_modes, 0,
        tx_types=cand_txs, tr_avail=jnp.asarray(tr),
        bl_avail=jnp.asarray(bl), rates=rates, return_index=True))(
            jnp.asarray(recon), jnp.asarray(src),
            (rt[0], rt[2], rt[3], rt[5]))
    trt = convert.rate_args_from_jax(rt, device="cpu")
    rec_t = t_(recon)[None].clone()
    m_t, q_t, _ = tie._rd_step(
        rec_t, t_(src)[None], torch.zeros(b, dtype=torch.int64),
        t_(by * 16), t_(bx * 16), torch.arange(b), t_(by > 0), t_(bx > 0),
        convert.quant_params_from_jax(qp, device="cpu"), torch.tensor(lam),
        cand_modes, (trt[0], trt[2], trt[3], trt[5]), tx_types=cand_txs,
        tr_avail=t_(tr), bl_avail=t_(bl), return_index=True)
    m_j, q_j, r_j = np.asarray(m_j), np.asarray(q_j), np.asarray(r_j)
    agree = m_t.numpy() == m_j
    picked = [cand_modes[i] + (cand_txs[i],) for i in m_t.numpy()]
    print(f"luma wave, 62 candidates: {agree.sum()} of {b} winners agree; "
          f"picked (mode, delta, tx): {sorted(set(picked))}")
    assert agree.mean() >= MIN_AGREE
    assert np.array_equal(q_t.numpy()[agree], q_j[agree])
    rec = rec_t[0].numpy()
    for i in np.nonzero(agree)[0]:
        sl = np.s_[by[i] * 16:by[i] * 16 + 16, bx[i] * 16:bx[i] * 16 + 16]
        assert np.array_equal(rec[sl], r_j[sl])
    # no zone-3 winner where bottom-left is available
    for i in range(b):
        if bl[i]:
            assert tie.cand_angle(*cand_modes[m_t.numpy()[i]]) <= 180


def test_luma_wave_palette_override_matches_jax():
    """The ``inter=(cost, rec)`` override of _rd_step: the alternative is
    taken exactly where its cost beats the best candidate."""
    src, recon = _state(64, 2)
    by, bx, tr, bl = _flags(4)
    b = by.size
    rng = np.random.default_rng(9)
    alt_rec = rng.integers(0, 256, (b, 16, 16)).astype(np.int32)
    alt_cost = np.where(np.arange(b) % 2 == 0, 1.0, 3.0e38).astype(
        np.float32)
    qp = jquant.make_quant_params(QINDEX)
    lam = tie.frame_lambda(QINDEX)
    modes = tie.MODES
    rt = jrate.md_rate_args(QINDEX, modes, tie.UV_MODES, exact=True)
    _, _, r_j, ch_j = jax.jit(lambda rec, s, rates, alt: jie._rd_step(
        rec, s, jnp.asarray(by * 16),
        jnp.asarray(bx * 16), jnp.ones(b, bool), jnp.asarray(by > 0),
        jnp.asarray(bx > 0), tuple(jnp.asarray(a) for a in qp),
        jnp.float32(lam), 16, cc.TX_16X16, modes, 0,
        tr_avail=jnp.asarray(tr), bl_avail=jnp.asarray(bl),
        rates=rates, inter=alt))(
            jnp.asarray(recon), jnp.asarray(src),
            (rt[0], rt[2], rt[3], rt[5]),
            (jnp.asarray(alt_cost), jnp.asarray(alt_rec)))
    trt = convert.rate_args_from_jax(rt, device="cpu")
    rec_t = t_(recon)[None].clone()
    _, _, _, ch_t = tie._rd_step(
        rec_t, t_(src)[None], torch.zeros(b, dtype=torch.int64),
        t_(by * 16), t_(bx * 16), torch.arange(b), t_(by > 0), t_(bx > 0),
        convert.quant_params_from_jax(qp, device="cpu"), torch.tensor(lam),
        modes, (trt[0], trt[2], trt[3], trt[5]), tr_avail=t_(tr),
        bl_avail=t_(bl), inter=(t_(alt_cost), t_(alt_rec)))
    assert np.array_equal(ch_t.numpy(), np.asarray(ch_j))
    assert np.array_equal(ch_t.numpy(), np.arange(b) % 2 == 0)
    rec = rec_t[0].numpy()
    for i in np.nonzero(ch_t.numpy())[0]:
        sl = np.s_[by[i] * 16:by[i] * 16 + 16, bx[i] * 16:bx[i] * 16 + 16]
        assert np.array_equal(rec[sl], alt_rec[i])
        assert np.array_equal(np.asarray(r_j)[sl], alt_rec[i])


def _alpha_fit_exact(src_c, rec_c, luma_rec, by, bx):
    """float64 value of 64 * sum(resid * ac) / den per block, from the
    port's integer DC prediction and AC buffer."""
    b = by.size
    fi = torch.zeros(b, dtype=torch.int64)
    above, left, corner = tie._gather_neighbors(
        t_(rec_c)[None], fi, t_(by * 8), t_(bx * 8), 8, t_(by > 0),
        t_(bx > 0))
    dc = tintra.predict(cc.DC_PRED, above, left, corner, 8, 8,
                        have_above=t_(by > 0), have_left=t_(bx > 0)).numpy()
    ac = tintra.cfl_ac_420(t_(luma_rec), 8, 8).numpy().astype(np.float64)
    blocks = np.stack([src_c[r * 8:r * 8 + 8, c * 8:c * 8 + 8]
                       for r, c in zip(by, bx)]).astype(np.float64)
    den = (ac * ac).sum(axis=(1, 2)) + 1e-6
    return 64.0 * ((blocks - dc) * ac).sum(axis=(1, 2)) / den


def test_chroma_wave_cfl_matches_jax():
    """One _rd_step_chroma with the CfL candidate over every 8x8 chroma
    block of a 64x64 luma / 32x32 chroma state."""
    src_u, rec_u = _state(32, 3)
    src_v, rec_v = _state(32, 4)
    _, rec_y = _state(64, 5)
    # chroma that follows luma on part of the picture, so that CfL wins
    src_u[:, :16] = np.clip(128 + (rec_y[::2, ::2][:, :16] - 128) // 2,
                            0, 255)
    src_v[:16] = np.clip(128 - (rec_y[::2, ::2][:16] - 128) // 3, 0, 255)
    g = 4
    by, bx = np.divmod(np.arange(g * g), g)
    b = by.size
    lblk = np.stack([rec_y[r * 16:r * 16 + 16, c * 16:c * 16 + 16]
                     for r, c in zip(by, bx)])
    qp = jquant.make_quant_params(QINDEX)
    lam = tie.frame_lambda(QINDEX)
    rt = jrate.md_rate_args(QINDEX, tie.MODES, tie.UV_MODES, exact=True)
    out_j = jax.jit(lambda ru, rv, su, sv, lb, rates: jie._rd_step_chroma(
        ru, rv, su, sv, jnp.asarray(by * 8), jnp.asarray(bx * 8),
        jnp.ones(b, bool), jnp.asarray(by > 0), jnp.asarray(bx > 0),
        tuple(jnp.asarray(a) for a in qp), jnp.float32(lam),
        rates=rates, luma_rec=lb, cfl=True))(
            jnp.asarray(rec_u), jnp.asarray(rec_v), jnp.asarray(src_u),
            jnp.asarray(src_v), jnp.asarray(lblk),
            (rt[1], rt[2], rt[4], rt[6]))
    um_j, qu_j, qv_j, ru_j, rv_j, au_j, av_j = (np.asarray(o)
                                                for o in out_j)
    trt = convert.rate_args_from_jax(rt, device="cpu")
    ru_t, rv_t = t_(rec_u)[None].clone(), t_(rec_v)[None].clone()
    um_t, qu_t, qv_t, _, _, au_t, av_t = tie._rd_step_chroma(
        ru_t, rv_t, t_(src_u)[None], t_(src_v)[None],
        torch.zeros(b, dtype=torch.int64), t_(by * 8), t_(bx * 8),
        torch.arange(b), t_(by > 0), t_(bx > 0),
        convert.quant_params_from_jax(qp, device="cpu"), torch.tensor(lam),
        (trt[1], trt[2], trt[4], trt[6]), luma_rec=t_(lblk), cfl=True)
    n_cfl = int((um_t.numpy() == cc.UV_CFL_PRED).sum())
    assert n_cfl > 0, "no block chose CfL: the test does not test it"
    # the alpha tie rule, per block
    frac = lambda x: np.abs(np.abs(x - np.floor(x)) - 0.5)
    on_tie = ((frac(_alpha_fit_exact(src_u, rec_u, lblk, by, bx))
               <= ALPHA_TIE_EPS)
              | (frac(_alpha_fit_exact(src_v, rec_v, lblk, by, bx))
                 <= ALPHA_TIE_EPS))
    da = np.maximum(np.abs(au_t.numpy() - au_j), np.abs(av_t.numpy() - av_j))
    alpha_mis = da > 0
    print(f"chroma wave with CfL: {n_cfl} of {b} blocks chose CfL; "
          f"{int(alpha_mis.sum())} blocks differ from JAX in alpha "
          f"(max |diff| {int(da.max())}), {int(on_tie.sum())} blocks lie "
          "on an alpha rounding tie")
    assert not (alpha_mis & ~on_tie).any(), \
        "alpha differs from JAX off a rounding tie"
    free = ~on_tie
    agree = (um_t.numpy() == um_j) & free
    assert agree.sum() >= MIN_AGREE * free.sum()
    for got, ref in ((qu_t, qu_j), (qv_t, qv_j)):
        assert np.array_equal(got.numpy()[agree], ref[agree])
    assert np.array_equal(au_t.numpy()[agree], au_j[agree])
    assert np.array_equal(av_t.numpy()[agree], av_j[agree])
    for got, ref in ((ru_t, ru_j), (rv_t, rv_j)):
        for i in np.nonzero(agree)[0]:
            sl = np.s_[by[i] * 8:by[i] * 8 + 8, bx[i] * 8:bx[i] * 8 + 8]
            assert np.array_equal(got[0].numpy()[sl], ref[sl])
    # the uncodable joint sign never comes out
    cflm = um_t.numpy() == cc.UV_CFL_PRED
    assert not ((au_t.numpy() == 0) & (av_t.numpy() == 0) & cflm).any()
    assert not (au_t.numpy()[~cflm].any() or av_t.numpy()[~cflm].any())


def test_palette_md_candidates_match_jax():
    y, _, _ = clips.screen_frame(96, 64, seed=3)
    ref = jie.palette_md_candidates(y, QINDEX)
    got = tie.palette_md_candidates(y, QINDEX, device="cpu")
    assert ref is not None and got is not None
    cost_j, rec_j, qy_j, info_j = ref
    cost_t, rec_t, qy_t, info_t = got
    assert sorted(info_t) == sorted(info_j) and len(info_t) >= 4
    for bid, (colors, cmap) in info_t.items():
        assert np.array_equal(colors, info_j[bid][0])
        assert np.array_equal(cmap, info_j[bid][1])
        assert colors.dtype == info_j[bid][0].dtype
    assert np.array_equal(qy_t.numpy(), qy_j)
    assert np.array_equal(rec_t.numpy(), rec_j)
    np.testing.assert_allclose(cost_t.numpy(), cost_j, rtol=1e-3)
    print(f"palette candidates: {len(info_t)} of {cost_j.size} blocks")
    # a natural picture has none
    assert tie.palette_md_candidates(
        clips.natural_clip(1, 64, 64)[0][0], QINDEX, device="cpu") is None
    # and the candidates cross packages as tensors
    conv = convert.palette_cands_from_jax(ref, device="cpu")
    assert torch.equal(conv[2], qy_t) and conv[3] is info_j
