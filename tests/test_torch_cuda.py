"""The port on an NVIDIA GPU: the fused transform+quantize kernel against
its plain version and against the first form of the kernel, and a small
all-intra encode on the card against the same encode on the CPU, at M10
through send_pictures and at M6 (tx-type search, angle deltas, CfL,
palette) through send_picture, without and with the in-loop filters
(whose ops are also held to their CPU run, exactly), and a hierarchical
GOP at M6, M8, M10 and M12 (round trip on the card, parity with the CPU),
the GOP clips that code wedge, diffwtd and warped blocks (the card's
stream codes each tool, round trip, parity with the CPU), a GOP with the
lookahead (MCTF + TPL, a delta-q key frame) on the card against the CPU,
the M0-M4 predictors (filter-intra, D45 / D67 / D203) and an M2
varpart key frame with the filters on the card against the CPU, and a
10-bit M10 frame with DLF + CDEF + LR on the card against the CPU.

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
from svt_av1_tpu_torch.ops import cdef, dlf, fused_txq, quant
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
@pytest.mark.parametrize("b", [1440, 97])
def test_kernel_rows_form_matches_twin_on_cuda(b):
    """K1's per-row form (a quantizer row per block, one per stream) against
    its plain twin: coefficients under the tie rule, the quantizer exact on
    the kernel's own coefficients, and each block equal to the one-row
    kernel at its row's quantizer, at qindices across 1-255 with flat
    blocks that saturate the int16 clamp."""
    _need_card()
    qs = [1, 100, 121, 255]
    rng = np.random.default_rng(b + 7)
    resid_np = rng.integers(-255, 256, (b, 16, 16)).astype(np.int32)
    resid_np[::5] = 255
    resid = torch.from_numpy(resid_np).cuda()
    sid = torch.from_numpy(rng.integers(0, len(qs), b)).cuda()
    sq = quant.StreamQuant(quant.stream_table(qs, resid.device), sid)
    before = fused_txq.launches_rows
    coef, qc, dq = fused_txq.fused_txq_rows(resid, sq)
    torch.cuda.synchronize()
    assert fused_txq.launches_rows == before + 1
    fv, fh, _, _ = tf._fwd_matrices(cc.DCT_DCT, cc.TX_16X16)
    exact = tie_rule.exact_coeffs(resid_np, fv, fh)
    pc, _, _ = fused_txq.fused_txq_rows_plain(resid, sq)
    tie_rule.tie_mismatches(coef.cpu().numpy(), pc.cpu().numpy(), exact)
    q_ref, d_ref = quant.quantize(coef, sq, cc.TX_16X16)
    assert torch.equal(qc, q_ref) and torch.equal(dq, d_ref)
    for s, q in enumerate(qs):
        m = sid == s
        one = fused_txq.fused_txq(resid[m].contiguous(),
                                  quant.params_on(q, resid.device))
        for a, o in zip((coef, qc, dq), one):
            assert torch.equal(a[m], o)


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


def _encode_decode(frames, w, h, device, preset=10, batched=True,
                   **filters):
    """(packets, decoded decisions per frame); the port's decoder on
    ``device`` must reproduce every packet's recon.  ``filters``: the
    in-loop filter settings of EncoderConfig."""
    enc = Encoder(EncoderConfig(source_width=w, source_height=h, qp=35,
                                enc_mode=preset, **filters), device=device)
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


@pytest.mark.cuda
def test_filter_ops_on_cuda_match_cpu():
    """filter_lines, loop_filter_plane_uniform, cdef_find_dir and
    cdef_filter_block: the card's results equal the CPU's exactly."""
    _need_card()
    rng = np.random.default_rng(3)
    both = lambda a: (torch.from_numpy(a), torch.from_numpy(a).cuda())
    c, g = both(np.clip(rng.integers(60, 70, (500, 1))
                        + rng.integers(-2, 3, (500, 14)) + np.where(
                            np.arange(14) >= 7, rng.integers(-9, 10, (500, 1)),
                            0), 0, 255).astype(np.int32))
    for flen in (4, 6, 8, 14):
        for level in (4, 12, 32, 63):
            thr = dlf.loop_filter_thresholds(level)
            assert torch.equal(dlf.filter_lines(g, *thr, flen).cpu(),
                               dlf.filter_lines(c, *thr, flen))
    yy, xx = np.mgrid[0:64, 0:96]
    off = rng.integers(-4, 5, (8, 12))
    c, g = both((90 + xx // 3 + off[yy // 8, xx // 8]).astype(np.int32))
    for step, flen in ((16, 14), (8, 6)):
        ref = dlf.loop_filter_plane_uniform(c, step, 20, 0, flen)
        assert not torch.equal(ref, c)
        assert torch.equal(
            dlf.loop_filter_plane_uniform(g, step, 20, 0, flen).cpu(), ref)
    c, g = both(np.where(rng.random((300, 8, 8)) < 0.5, 0, 255)
                .astype(np.int32))
    for a, b in zip(cdef.cdef_find_dir(g), cdef.cdef_find_dir(c)):
        assert torch.equal(a.cpu(), b)
    for n in (8, 4):
        wins = rng.integers(0, 256, (300, n + 4, n + 4)).astype(np.int32)
        wins[::3, :2] = cdef.CDEF_VERY_LARGE
        args = [torch.from_numpy(a) for a in (
            wins, rng.integers(0, 16, 300).astype(np.int32),
            rng.choice([0, 1, 2, 4], 300).astype(np.int32),
            rng.integers(0, 8, 300).astype(np.int32))]
        for damping in (3, 6):
            ref = cdef.cdef_filter_block(*args, damping, damping, n=n)
            got = cdef.cdef_filter_block(*(a.cuda() for a in args), damping,
                                         damping, n=n)
            assert torch.equal(got.cpu(), ref)


@pytest.mark.cuda
def test_m6_filtered_key_frames_on_cuda_match_cpu():
    """send_picture at M6 with DLF and CDEF on at 96x64: the card against
    the CPU under the parity rule, with the same filter levels and CDEF
    strengths, and every packet decoded exactly on its device."""
    _need_card()
    w, h = 96, 64
    frames = [clips.natural_clip(1, w, h)[0], clips.screen_frame(w, h, 1)]
    filt = dict(enable_dlf_flag=1, cdef_level=1)
    pk_g, dec_g = _encode_decode(frames, w, h, "cuda", 6, batched=False,
                                 **filt)
    pk_c, dec_c = _encode_decode(frames, w, h, "cpu", 6, batched=False,
                                 **filt)
    _parity(frames, pk_g, dec_g, pk_c, dec_c)
    headers = []
    for pkts in (pk_g, pk_c):
        dec = Decoder(device="cpu")
        for p in pkts:
            dec.decode_temporal_unit(p.data)
            f = dec.last_frame_header
            headers.append((f.filter_level, f.filter_level_uv,
                            f.cdef_strengths))
    assert headers[:2] == headers[2:]
    assert headers[0][0][0] > 0


def _gop(frames, device, preset, clip=None, **fields):
    """A hierarchical GOP (levels 2, keyint 4, qp 35 unless ``fields``
    set them) through send_picture / flush, under the setting of the
    tool clip ``clip`` (clips.tool_setting)."""
    from svt_av1_tpu_torch.pipeline import gop_fast
    h, w = frames[0][0].shape
    cfg = dict(dict(qp=35, intra_period_length=4, enable_tf=0,
                    enable_tpl_la=0), **fields)
    enc = Encoder(EncoderConfig(source_width=w, source_height=h,
                                enc_mode=preset, hierarchical_levels=2,
                                enable_dlf_flag=1, cdef_level=1, **cfg),
                  device=device)
    with clips.tool_setting(clip, enc, gop_fast):
        for f in frames:
            enc.send_picture(*f)
        enc.flush()
    pkts = []
    while (p := enc.get_packet()) is not None:
        pkts.append(p)
    return pkts


@pytest.mark.cuda
@pytest.mark.parametrize("preset", [6, 8, 10, 12])
def test_gop_on_cuda_round_trips_and_matches_cpu(preset):
    """A 5-frame hierarchical GOP (levels 2, keyint 4) at 96x64 on the
    card (at M6 and M8 with the inter tx search, OBMC and inter-intra, at
    M6 the 8x8 split and TMVP too): the port's decoder on the card
    reproduces every shown frame,
    show-existing ones included, and the stream meets the parity rule
    against the same encode on the CPU."""
    _need_card()
    frames = clips.natural_clip(5, 96, 64, seed=3)
    pk_g = _gop(frames, "cuda", preset)
    pk_c = _gop(frames, "cpu", preset)
    dec = Decoder(device="cuda")
    shown = []
    for p in pk_g:
        shown += dec.decode_temporal_unit(p.data)
    disp_g = [p for p in pk_g if p.displayed]
    assert len(shown) == len(disp_g) == len(frames)
    for rec, p in zip(shown, disp_g):
        for k in "yuv":
            assert np.array_equal(rec[k], p.recon[k]), (p.pts, k)
    disp_c = [p for p in pk_c if p.displayed]
    p_g = np.mean([_psnr(frames[p.pts][0], p.recon["y"]) for p in disp_g])
    p_c = np.mean([_psnr(frames[p.pts][0], p.recon["y"]) for p in disp_c])
    b_g = sum(len(p.data) for p in pk_g)
    b_c = sum(len(p.data) for p in pk_c)
    assert abs(p_g - p_c) <= MAX_DPSNR
    assert abs(b_g - b_c) <= MAX_DBYTES * b_c


USES_TOOL = dict(
    wedge=lambda b: b.is_inter and b.ref2 and b.comp_type == 1,
    diffwtd=lambda b: b.is_inter and b.ref2 and b.comp_type == 2,
    warp=lambda b: b.is_inter and b.use_warp)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(clips.TOOL_CLIPS))
def test_gop_tools_on_cuda_round_trip_and_match_cpu(name):
    """The clips that code one tool each at M10 — wedge (wipe), diffwtd
    (iris), warped blocks (zoom + rotate) — on the card: the card's stream
    codes that tool, the port's decoder on the card reproduces every shown
    frame, and >= 99% of blocks (modes, references, MVs, warp, compound
    type, wedge option, qcoeff) equal those of the same encode on the
    CPU."""
    _need_card()
    clip, fields, tool = clips.TOOL_CLIPS[name]
    frames = clip()
    pk_g = _gop(frames, "cuda", 10, clip=name, **fields)
    pk_c = _gop(frames, "cpu", 10, clip=name, **fields)
    blocks = []
    for pkts, dev in ((pk_g, "cuda"), (pk_c, "cpu")):
        dec = Decoder(device=dev)
        coded = []
        for p in pkts:
            out = dec.decode_temporal_unit(p.data)
            for rec in out:
                for k in "yuv":
                    assert np.array_equal(rec[k], p.recon[k]), (dev, p.pts)
            if len(p.data) > 8:
                coded.append(dec.last_decisions)
        blocks.append(coded)
    assert any(USES_TOOL[tool](b) for d in blocks[0] for b in d.values())
    same = tot = 0
    for dg, dc in zip(*blocks):
        for k, a in dc.items():
            b = dg.get(k)
            tot += 1
            same += bool(
                b is not None and (a.bsize, a.is_inter, a.y_mode, a.ref,
                                   a.ref2, a.mv, a.mv2, a.use_warp,
                                   a.comp_type, a.wedge_idx, a.wedge_sign)
                == (b.bsize, b.is_inter, b.y_mode, b.ref, b.ref2, b.mv,
                    b.mv2, b.use_warp, b.comp_type, b.wedge_idx,
                    b.wedge_sign)
                and np.array_equal(a.qcoeff_y, b.qcoeff_y))
    assert same >= MIN_AGREE * tot, (name, same, tot)


@pytest.mark.cuda
def test_lookahead_gop_on_cuda_round_trips_and_matches_cpu():
    """The 7-frame 128x96 GOP of tests/test_torch_lookahead.py with MCTF
    and TPL on (M10) on the card: a key frame coded with delta-q, the
    port's decoder on the card reproduces every shown frame, and the
    stream meets the parity rule against the same encode on the CPU."""
    _need_card()
    from svt_av1_tpu_torch.codec import obu
    frames = clips.split_motion_clip(7)
    la = dict(enable_tf=1, enable_tpl_la=1)
    pk_g = _gop(frames, "cuda", 10, **la)
    pk_c = _gop(frames, "cpu", 10, **la)
    dec = Decoder(device="cuda")
    shown, delta_q = [], []
    for p in pk_g:
        shown += dec.decode_temporal_unit(p.data)
        if p.frame_type == obu.KEY_FRAME:
            delta_q.append(dec.last_frame_header.delta_q_present)
    disp_g = [p for p in pk_g if p.displayed]
    assert len(shown) == len(disp_g) == len(frames)
    for rec, p in zip(shown, disp_g):
        for k in "yuv":
            assert np.array_equal(rec[k], p.recon[k]), (p.pts, k)
    assert any(delta_q)
    disp_c = [p for p in pk_c if p.displayed]
    p_g = np.mean([_psnr(frames[p.pts][0], p.recon["y"]) for p in disp_g])
    p_c = np.mean([_psnr(frames[p.pts][0], p.recon["y"]) for p in disp_c])
    b_g = sum(len(p.data) for p in pk_g)
    b_c = sum(len(p.data) for p in pk_c)
    assert abs(p_g - p_c) <= MAX_DPSNR
    assert abs(b_g - b_c) <= MAX_DBYTES * b_c


@pytest.mark.cuda
def test_quality_ops_on_cuda_match_cpu():
    """The M0-M4 predictors on the card against the CPU, exact: the five
    filter-intra modes in one wavefront at 4-32, D45 / D67 / D203 at
    16-64."""
    _need_card()
    from svt_av1_tpu_torch.ops import intra
    rng = np.random.default_rng(28)
    t = torch.from_numpy
    for n in (4, 8, 16, 32, 64):
        a, l = (rng.integers(0, 256, (9, n)).astype(np.int32)
                for _ in range(2))
        c = rng.integers(0, 256, 9).astype(np.int32)
        ext = rng.integers(0, 256, (9, 2 * n + 1)).astype(np.int32)
        if n <= 32:
            ref = intra.filter_intra_pred_multi(t(a), t(l), t(c),
                                                tuple(range(5)), n, n)
            got = intra.filter_intra_pred_multi(
                t(a).cuda(), t(l).cuda(), t(c).cuda(), tuple(range(5)), n, n)
            assert torch.equal(ref, got.cpu()), n
        for mode in (cc.D45_PRED, cc.D67_PRED, cc.D203_PRED):
            ref = intra.predict(mode, t(a), t(l), t(c), n, n,
                                above_ext=t(ext), left_ext=t(ext))
            got = intra.predict(mode, t(a).cuda(), t(l).cuda(), t(c).cuda(),
                                n, n, above_ext=t(ext).cuda(),
                                left_ext=t(ext).cuda())
            assert torch.equal(ref, got.cpu()), (n, mode)


@pytest.mark.cuda
def test_m2_varpart_key_frame_on_cuda_matches_cpu():
    """send_picture at M2 with DLF + CDEF (the varpart program,
    filter-intra, the mask-aware DLF search, per-SB CDEF) on the varpart
    picture: the card's stream round-trips on the card and equals the
    CPU's under the parity rule."""
    _need_card()
    frames = [clips.varpart_frame()]
    h, w = frames[0][0].shape
    kw = dict(enable_dlf_flag=1, cdef_level=1)
    pk_g, dec_g = _encode_decode(frames, w, h, "cuda", 2, batched=False,
                                 **kw)
    pk_c, dec_c = _encode_decode(frames, w, h, "cpu", 2, batched=False, **kw)
    _parity(frames, pk_g, dec_g, pk_c, dec_c)
    sizes = {b.bsize for b in dec_g[0].values()}
    assert {cc.BLOCK_16X16, cc.BLOCK_32X32} <= sizes


@pytest.mark.cuda
def test_ten_bit_frame_on_cuda_matches_cpu():
    """A 64x64 10-bit M10 frame with DLF + CDEF + LR on the card: the same
    stream as on the CPU (K1 launched on every luma wave at 10-bit
    residuals), decoded on the card to the uint16 recon."""
    _need_card()
    (frame,) = clips.natural_clip10(1, 64, 64, seed=4)

    def run(device):
        enc = Encoder(EncoderConfig(source_width=64, source_height=64, qp=35,
                                    encoder_bit_depth=10, enable_dlf_flag=1,
                                    cdef_level=1,
                                    enable_restoration_filtering=1),
                      device=device)
        enc.send_picture(*frame)
        enc.flush()
        return enc.get_packet()

    before = fused_txq.launches
    card = run("cuda")
    assert fused_txq.launches > before
    cpu = run("cpu")
    assert card.data == cpu.data
    (rec,) = Decoder(device="cuda").decode_temporal_unit(card.data)
    for k in "yuv":
        assert rec[k].dtype == card.recon[k].dtype == np.uint16
        assert np.array_equal(rec[k], card.recon[k])
