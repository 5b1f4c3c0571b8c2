"""The port's fused 16x16 transform+quantize op vs the reference's Pallas
kernel (svt_av1_tpu/ops/pallas/fused_txq.py, interpret mode on the CPU).

Tie rule for coeff (tests/tie_rule.py): |diff| <= 1 and only where the
float64 value lies within 1e-2 of a half-integer; qcoeff/dqcoeff must
equal the quantizer applied to the op's own coefficients exactly.  The
CUDA kernel itself runs only on a card: tests/test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tie_rule
from svt_av1_tpu.codec import constants as cc
from svt_av1_tpu.ops import quant as jquant
from svt_av1_tpu.ops import transforms as jtf
from svt_av1_tpu.ops.pallas import fused_txq as jfused

from svt_av1_tpu_torch import convert
from svt_av1_tpu_torch.ops import fused_txq, quant

torch.set_num_threads(2)


def _exact(resid):
    fv, fh, _, _ = jtf._fwd_matrices(cc.DCT_DCT, cc.TX_16X16)
    return tie_rule.exact_coeffs(resid, fv, fh)


@pytest.mark.parametrize("b,seed,qindex", [(100, 0, 120), (70, 1, 100)])
def test_plain_matches_pallas_kernel(b, seed, qindex):
    rng = np.random.default_rng(seed)
    resid = rng.integers(-200, 200, (b, 16, 16)).astype(np.int32)
    qp = jquant.make_quant_params(qindex)
    coef_j, qc_j, dq_j = jfused.fwd_txfm_quant_16x16_qp(
        jnp.asarray(resid), qp, interpret=True)
    tqp = convert.quant_params_from_jax(qp)
    coef, qc, dq = fused_txq.fused_txq_plain(torch.from_numpy(resid), tqp)
    n, _ = tie_rule.tie_mismatches(coef.numpy(), np.asarray(coef_j),
                                   _exact(resid))
    print(f"B={b}: {n} tie mismatches of {coef.numel()}")
    q_ref, d_ref = quant.quantize(coef, tqp, cc.TX_16X16)
    assert torch.equal(qc, q_ref) and torch.equal(dq, d_ref)
    same = coef.numpy() == np.asarray(coef_j)
    assert np.array_equal(qc.numpy()[same], np.asarray(qc_j)[same])
    assert np.array_equal(dq.numpy()[same], np.asarray(dq_j)[same])


def test_cpu_tensor_takes_plain_version():
    rng = np.random.default_rng(2)
    resid = torch.from_numpy(
        rng.integers(-255, 256, (33, 16, 16)).astype(np.int32))
    qp = quant.to_device(quant.make_quant_params(140), "cpu")
    before = fused_txq.launches
    got = fused_txq.fused_txq(resid, qp)
    ref = fused_txq.fused_txq_plain(resid, qp)
    assert fused_txq.launches == before
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
