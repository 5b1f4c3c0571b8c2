"""svt_av1_tpu_torch ops vs the JAX package (and the C goldens).

Integer ops (quantizer, inverse transform, the slice's intra predictors)
must be bit-exact.  The float32 forward transform follows the rounding
tie rule: |diff| <= 1, and only where the float64 value lies within 1e-2
of a half-integer, on fewer than 1e-3 of the coefficients.  Rate sums add
float32 table entries in another order: rtol 1e-5.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import golden_defs as gd
import tie_rule
from svt_av1_tpu.codec import constants as cc
from svt_av1_tpu.codec import rate_est as jrate
from svt_av1_tpu.ops import coef_rate as jcoef
from svt_av1_tpu.ops import intra as jintra
from svt_av1_tpu.ops import quant as jquant
from svt_av1_tpu.ops import transforms as jtf

from svt_av1_tpu_torch import convert
from svt_av1_tpu_torch.codec import rate_est as trate
from svt_av1_tpu_torch.ops import coef_rate as tcoef
from svt_av1_tpu_torch.ops import intra as tintra
from svt_av1_tpu_torch.ops import quant as tquant
from svt_av1_tpu_torch.ops import transforms as ttf
from svt_av1_tpu_torch.pipeline import intra_encoder as tie

torch.set_num_threads(2)

MAX_TIE_SHARE = 1e-3
CHROMA_TYPES = (cc.DCT_DCT, cc.ADST_DCT, cc.DCT_ADST, cc.ADST_ADST)
SLICE_TX = ([(cc.TX_16X16, cc.DCT_DCT)]
            + [(cc.TX_8X8, t) for t in CHROMA_TYPES])


@pytest.mark.parametrize("qindex", [1, 60, 140, 255])
def test_make_quant_params_matches(qindex):
    ref = jquant.make_quant_params(qindex)
    got = tquant.make_quant_params(qindex)
    for a, b in zip(ref, got):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    t = convert.quant_params_from_jax(ref, device="cpu")
    assert all(x.dtype == torch.int32 and np.array_equal(x.numpy(), a)
               for x, a in zip(t, ref))


@pytest.mark.parametrize("tx_size", [cc.TX_16X16, cc.TX_8X8])
def test_quantize_dequantize_bit_exact(tx_size):
    n = int(cc.tx_size_wide[tx_size])
    rng = np.random.default_rng(3 + tx_size)
    coeffs = rng.integers(-4000, 4001, (64, n, n)).astype(np.int32)
    coeffs[rng.random(coeffs.shape) < 0.5] //= 50
    for qindex in (20, 140, 255):
        qp = jquant.make_quant_params(qindex)
        qc_j, dq_j = jquant.quantize(jnp.asarray(coeffs), qp, tx_size)
        tqp = tquant.to_device(qp, "cpu")
        qc_t, dq_t = tquant.quantize(torch.from_numpy(coeffs), tqp, tx_size)
        assert np.array_equal(qc_t.numpy(), np.asarray(qc_j))
        assert np.array_equal(dq_t.numpy(), np.asarray(dq_j))
        deq_j = jquant.dequantize(qc_j, qp, tx_size)
        deq_t = tquant.dequantize(qc_t, tqp, tx_size)
        assert np.array_equal(deq_t.numpy(), np.asarray(deq_j))
        assert np.array_equal(
            tquant.dequant_field(tqp, n, n).numpy(),
            np.asarray(jquant.dequant_field(qp, n, n)))


@pytest.mark.parametrize("tx_size,tx_type", SLICE_TX)
def test_inv_txfm_bit_exact_vs_jax_and_golden(tx_size, tx_type):
    n = int(cc.tx_size_wide[tx_size])
    rng = np.random.default_rng(11 + tx_type)
    coeffs = rng.integers(-3000, 3001, (48, n, n)).astype(np.int32)
    coeffs[rng.random(coeffs.shape) < 0.7] = 0
    pred = rng.integers(0, 256, (48, n, n)).astype(np.int32)
    ref = np.asarray(jtf.inv_txfm2d_add(jnp.asarray(coeffs),
                                        jnp.asarray(pred), tx_type, tx_size))
    got = ttf.inv_txfm2d_add(torch.from_numpy(coeffs),
                             torch.from_numpy(pred), tx_type, tx_size)
    assert np.array_equal(got.numpy(), ref)
    vec = np.load(os.path.join(gd.GOLDEN_DIR, "inv_txfm.npz"))
    c, p = gd.inv_txfm_input(tx_size, tx_type, 8)
    got = ttf.inv_txfm2d_add(torch.from_numpy(c[None]),
                             torch.from_numpy(p[None]), tx_type, tx_size)
    assert np.array_equal(got[0].numpy(),
                          vec[f"s{tx_size}_t{tx_type}_b8"].astype(np.int32))


def test_inv_txfm_all_golden_cases():
    vec = np.load(os.path.join(gd.GOLDEN_DIR, "inv_txfm.npz"))
    n = 0
    for tx_size, tx_type, bd in gd.inv_txfm_cases():
        c, p = gd.inv_txfm_input(tx_size, tx_type, bd)
        got = ttf.inv_txfm2d_add(torch.from_numpy(c[None]),
                                 torch.from_numpy(p[None]), tx_type,
                                 tx_size, bd=bd)
        assert np.array_equal(
            got[0].numpy(), vec[f"s{tx_size}_t{tx_type}_b{bd}"]), \
            (tx_size, tx_type, bd)
        n += 1
    assert n > 60


def _neighbors(n, b, seed):
    rng = np.random.default_rng(seed)
    above = rng.integers(0, 256, (b, n)).astype(np.int32)
    left = rng.integers(0, 256, (b, n)).astype(np.int32)
    corner = rng.integers(0, 256, (b,)).astype(np.int32)
    ha = rng.random(b) < 0.6
    hl = rng.random(b) < 0.6
    return above, left, corner, ha, hl


@pytest.mark.parametrize("mode", tie.MODES + (cc.SMOOTH_V_PRED,
                                               cc.SMOOTH_H_PRED))
@pytest.mark.parametrize("n", [16, 8])
def test_predictors_bit_exact_vs_jax(mode, n):
    above, left, corner, ha, hl = _neighbors(n, 40, 100 + mode + n)
    ref = np.asarray(jintra.predict(
        mode, jnp.asarray(above), jnp.asarray(left), jnp.asarray(corner),
        n, n, have_above=jnp.asarray(ha), have_left=jnp.asarray(hl)))
    got = tintra.predict(
        mode, torch.from_numpy(above), torch.from_numpy(left),
        torch.from_numpy(corner), n, n, have_above=torch.from_numpy(ha),
        have_left=torch.from_numpy(hl))
    assert np.array_equal(got.numpy(), ref)


@pytest.mark.parametrize("mode", [cc.DC_PRED, cc.V_PRED, cc.H_PRED,
                                  cc.SMOOTH_PRED, cc.SMOOTH_V_PRED,
                                  cc.SMOOTH_H_PRED, cc.PAETH_PRED])
def test_predictors_vs_golden(mode):
    vec = np.load(os.path.join(gd.GOLDEN_DIR, "intra.npz"))
    for (w, h) in gd.INTRA_SIZES:
        above, left, corner = gd.intra_input(mode, w, h)
        got = tintra.predict(
            mode, torch.from_numpy(above[None].astype(np.int32)),
            torch.from_numpy(left[None].astype(np.int32)),
            torch.tensor([corner], dtype=torch.int32), h, w)
        assert np.array_equal(got[0].numpy(),
                              vec[f"m{mode}_{w}x{h}"].astype(np.int32)), \
            (mode, w, h)


@pytest.mark.parametrize("tx_size,tx_type", SLICE_TX)
def test_fwd_txfm_tie_rule(tx_size, tx_type):
    n = int(cc.tx_size_wide[tx_size])
    rng = np.random.default_rng(21 + tx_type)
    resid = rng.integers(-255, 256, (2000, n, n)).astype(np.int32)
    ref = np.asarray(jtf.fwd_txfm2d(jnp.asarray(resid), tx_type, tx_size))
    got = ttf.fwd_txfm2d(torch.from_numpy(resid), tx_type, tx_size).numpy()
    fv, fh, ud, lr = jtf._fwd_matrices(tx_type, tx_size)
    x = resid[:, ::-1] if ud else resid
    x = x[:, :, ::-1] if lr else x
    n_bad, _ = tie_rule.tie_mismatches(got, ref,
                                       tie_rule.exact_coeffs(x, fv, fh))
    print(f"tie mismatches: {n_bad} of {got.size}")
    assert n_bad < MAX_TIE_SHARE * got.size


@pytest.mark.parametrize("tx_size,tx_type", SLICE_TX)
def test_coeff_sse_scale_matches(tx_size, tx_type):
    assert ttf.coeff_sse_scale(tx_size, tx_type) == pytest.approx(
        jtf.coeff_sse_scale(tx_size, tx_type), rel=1e-6)


@pytest.mark.parametrize("tx_size,plane", [(cc.TX_16X16, 0),
                                           (cc.TX_8X8, 1)])
def test_txb_bits_exact_matches(tx_size, plane):
    n = int(cc.tx_size_wide[tx_size])
    rng = np.random.default_rng(5 + n)
    q = rng.integers(0, 24, (300, n, n)).astype(np.int32)
    q[rng.random(q.shape) < 0.8] = 0
    q[:20] = 0                      # all-zero blocks take the skip cost
    q[20:40, 1:] = 0                # DC-only blocks
    t = jrate._default_exact_tables(140, tx_size, plane)
    ref = np.asarray(jcoef.txb_bits_exact(jnp.asarray(q), t, n))
    got = tcoef.txb_bits_exact(
        torch.from_numpy(q), convert.coef_tables_from_jax(t, device="cpu"),
        n)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5)


def test_txb_bits_analytic_matches():
    from svt_av1_tpu.pipeline import intra_encoder as jie
    rng = np.random.default_rng(9)
    q = rng.integers(0, 24, (200, 16, 16)).astype(np.int32)
    q[rng.random(q.shape) < 0.85] = 0
    rt = jrate.md_rate_args(180, tie.MODES[:4], tie.UV_MODES)
    pos = jie._scan_pos(cc.TX_16X16)
    ref = np.asarray(jie._txb_bits(jnp.asarray(q), rt[0], rt[2][0], rt[5],
                                   jnp.asarray(pos)))
    trt = convert.rate_args_from_jax(rt, device="cpu")
    got = tie._txb_bits(torch.from_numpy(q), trt[0], trt[2][0], trt[5],
                        torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5)


@pytest.mark.parametrize("exact", [True, False])
def test_md_rate_args_and_convert_round_trip(exact):
    modes = tie.MODES if exact else tie.MODES[:4]
    ref = jrate.md_rate_args(140, modes, tie.UV_MODES, exact=exact)
    got = trate.md_rate_args(140, modes, tie.UV_MODES, exact=exact,
                            device="cpu")
    conv = convert.rate_args_from_jax(ref, device="cpu")
    assert len(ref) == len(got) == len(conv) == 9
    for r, g, c in zip(ref, got, conv):
        if hasattr(r, "_fields"):
            assert isinstance(g, tcoef.CoefTables)
            pairs = zip(r, g, c)
        else:
            pairs = [(r, g, c)]
        for a, b, d in pairs:
            a = np.asarray(a, np.float32)
            assert np.array_equal(a, b.numpy()) and np.array_equal(
                a, d.numpy())
