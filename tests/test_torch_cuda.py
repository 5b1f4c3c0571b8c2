"""The port on an NVIDIA GPU: the fused transform+quantize kernel against
its plain version and against the first form of the kernel, and a small
all-intra encode on the card against the same encode on the CPU, at M10
through send_pictures and at M6 (tx-type search, angle deltas, CfL,
palette) through send_picture.

Every test here is marked ``cuda`` and skips without a card.  The file
imports no JAX, so it also runs where JAX is not installed:

    python -m pytest -q -p no:cacheprovider --noconftest tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

import clips
import tie_rule
from svt_av1_tpu_torch.api.encoder import Encoder, EncoderConfig
from svt_av1_tpu_torch.codec import constants as cc
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


@pytest.mark.cuda
@pytest.mark.parametrize("b", [2112, 1920, 100, 1])
def test_kernel_bit_identical_to_first_kernel(b):
    """The redesigned kernel and the first one (svt_fused_txq16_v1) sum in
    the same order, so every coeff, qcoeff and dqcoeff is equal."""
    _need_card()
    rng = np.random.default_rng(b + 1)
    resid = torch.from_numpy(
        rng.integers(-255, 256, (b, 16, 16)).astype(np.int32)).cuda()
    for qindex in (140, 255):
        qp = quant.to_device(quant.make_quant_params(qindex), "cuda")
        got = torch.stack(fused_txq.fused_txq(resid, qp))
        ref = torch.empty_like(got)
        fv, fh = tf.fwd_matrices_on(cc.DCT_DCT, cc.TX_16X16, resid.device)
        rc = fused_txq.entry("svt_fused_txq16_v1")(
            resid.data_ptr(), b, fv.data_ptr(), fh.data_ptr(),
            *(a.data_ptr() for a in qp), ref[0].data_ptr(),
            ref[1].data_ptr(), ref[2].data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        assert rc == 0
        torch.cuda.synchronize()
        assert torch.equal(got, ref)


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


def _encode_decode(frames, w, h, device, preset=10, batched=True):
    """(packets, decoded decisions per frame); the port's decoder on
    ``device`` must reproduce every packet's recon."""
    enc = Encoder(EncoderConfig(source_width=w, source_height=h, qp=35,
                                enc_mode=preset), device=device)
    if batched:
        enc.send_pictures(frames, eos=True)
    else:
        for f in frames:
            enc.send_picture(*f)
        enc.flush()
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


def _same_block(a, b):
    return (a.y_mode == b.y_mode and a.uv_mode == b.uv_mode
            and a.tx_type == b.tx_type
            and a.angle_delta_y == b.angle_delta_y
            and a.cfl_alpha_u == b.cfl_alpha_u
            and a.cfl_alpha_v == b.cfl_alpha_v
            and (a.palette is None) == (b.palette is None)
            and all(np.array_equal(getattr(a, q), getattr(b, q))
                    for q in ("qcoeff_y", "qcoeff_u", "qcoeff_v")))


def _parity(frames, pk_g, dec_g, pk_c, dec_c):
    same = total = 0
    for dg, dc in zip(dec_g, dec_c):
        for key, a in dg.items():
            total += 1
            same += _same_block(a, dc[key])
    assert same / total >= MIN_AGREE
    for f, a, b in zip(frames, pk_g, pk_c):
        assert abs(_psnr(f[0], a.recon["y"])
                   - _psnr(f[0], b.recon["y"])) <= MAX_DPSNR
    nb_g = sum(len(p.data) for p in pk_g)
    nb_c = sum(len(p.data) for p in pk_c)
    assert abs(nb_g - nb_c) <= MAX_DBYTES * nb_c


@pytest.mark.cuda
def test_slice_on_cuda_matches_cpu():
    _need_card()
    w, h = 96, 64
    frames = _frames(2, w, h)
    before = fused_txq.launches
    pk_g, dec_g = _encode_decode(frames, w, h, "cuda")
    assert fused_txq.launches > before
    pk_c, dec_c = _encode_decode(frames, w, h, "cpu")
    _parity(frames, pk_g, dec_g, pk_c, dec_c)


@pytest.mark.cuda
def test_m6_key_frames_on_cuda_match_cpu():
    """send_picture at M6 on a natural and a screen-content frame: the
    card against the CPU under the parity rule, every tool in use."""
    _need_card()
    w, h = 96, 64
    frames = [clips.natural_clip(1, w, h)[0], clips.screen_frame(w, h, 1)]
    pk_g, dec_g = _encode_decode(frames, w, h, "cuda", 6, batched=False)
    pk_c, dec_c = _encode_decode(frames, w, h, "cpu", 6, batched=False)
    _parity(frames, pk_g, dec_g, pk_c, dec_c)
    blocks = [b for d in dec_g for b in d.values()]
    assert any(b.tx_type != cc.DCT_DCT for b in blocks)
    assert any(b.uv_mode == cc.UV_CFL_PRED for b in blocks)
    assert any(b.palette is not None for b in blocks)
