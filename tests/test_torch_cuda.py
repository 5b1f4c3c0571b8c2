"""The port on an NVIDIA GPU: the fused transform+quantize kernel against
its plain version, and a small all-intra encode on the card against the
same encode on the CPU.

Every test here is marked ``cuda`` and skips without a card.  The file
imports no JAX, so it also runs where JAX is not installed:

    python -m pytest -q -p no:cacheprovider --noconftest tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

import tie_rule
from svt_av1_tpu.codec import constants as cc

from svt_av1_tpu_torch.api.encoder import Encoder, EncoderConfig
from svt_av1_tpu_torch.codec.decoder import Decoder
from svt_av1_tpu_torch.ops import fused_txq, quant
from svt_av1_tpu_torch.ops import transforms as tf

MIN_AGREE = 0.99
MAX_DPSNR = 0.05
MAX_DBYTES = 0.01


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("b", [2112, 100])
def test_kernel_matches_plain_on_cuda(b):
    _need_card()
    rng = np.random.default_rng(b)
    resid_np = rng.integers(-255, 256, (b, 16, 16)).astype(np.int32)
    resid = torch.from_numpy(resid_np).cuda()
    fv, fh, _, _ = tf._fwd_matrices(cc.DCT_DCT, cc.TX_16X16)
    exact = tie_rule.exact_coeffs(resid_np, fv, fh)
    for qindex in (140, 255):
        qp = quant.to_device(quant.make_quant_params(qindex), "cuda")
        before = fused_txq.launches
        coef, qc, dq = fused_txq.fused_txq(resid, qp)
        torch.cuda.synchronize()
        assert fused_txq.launches == before + 1
        pc, _, _ = fused_txq.fused_txq_plain(resid, qp)
        tie_rule.tie_mismatches(coef.cpu().numpy(), pc.cpu().numpy(), exact)
        q_ref, d_ref = quant.quantize(coef, qp, cc.TX_16X16)
        assert torch.equal(qc, q_ref) and torch.equal(dq, d_ref)


def _frames(n, w, h):
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for t in range(n):
        y = (96 + 60 * np.sin(xx / 17.0 + t * 0.13)
             + 50 * np.cos(yy / 23.0) + rng.integers(-5, 6, (h, w)))
        u = 128 + 40 * np.sin(xx[::2, ::2] / 31.0 + t * 0.05)
        v = 128 + 40 * np.cos(yy[::2, ::2] / 29.0)
        out.append(tuple(np.clip(p, 0, 255).astype(np.uint8)
                         for p in (y, u, v)))
    return out


def _encode_decode(frames, w, h, device):
    """(packets, decoded decisions per frame); the port's decoder on
    ``device`` must reproduce every packet's recon."""
    enc = Encoder(EncoderConfig(source_width=w, source_height=h, qp=35,
                                enc_mode=10), device=device)
    enc.send_pictures(frames, eos=True)
    pkts = []
    while (p := enc.get_packet()) is not None:
        pkts.append(p)
    assert len(pkts) == len(frames)
    dec = Decoder(device=device)
    decisions = []
    for p in pkts:
        (rec,) = dec.decode_temporal_unit(p.data)
        for k in "yuv":
            assert np.array_equal(rec[k], p.recon[k]), (device, k, p.pts)
        decisions.append(rec["decisions"])
    return pkts, decisions


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))


@pytest.mark.cuda
def test_slice_on_cuda_matches_cpu():
    _need_card()
    w, h = 96, 64
    frames = _frames(2, w, h)
    before = fused_txq.launches
    pk_g, dec_g = _encode_decode(frames, w, h, "cuda")
    assert fused_txq.launches > before
    pk_c, dec_c = _encode_decode(frames, w, h, "cpu")
    same = total = 0
    for dg, dc in zip(dec_g, dec_c):
        for key, a in dg.items():
            b = dc[key]
            total += 1
            same += (a.y_mode == b.y_mode and a.uv_mode == b.uv_mode
                     and all(np.array_equal(getattr(a, q), getattr(b, q))
                             for q in ("qcoeff_y", "qcoeff_u", "qcoeff_v")))
    assert same / total >= MIN_AGREE
    for f, a, b in zip(frames, pk_g, pk_c):
        assert abs(_psnr(f[0], a.recon["y"])
                   - _psnr(f[0], b.recon["y"])) <= MAX_DPSNR
    nb_g = sum(len(p.data) for p in pk_g)
    nb_c = sum(len(p.data) for p in pk_c)
    assert abs(nb_g - nb_c) <= MAX_DBYTES * nb_c
