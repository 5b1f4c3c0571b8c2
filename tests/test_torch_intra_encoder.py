"""The port's all-intra slice vs the JAX package.

Wave steps: best modes agree on >= 99% of blocks; levels and recon are
exact on the agreeing blocks (the forward transform may round a tie the
other way, which can flip a near-tied mode choice).  The JAX package's
wave outputs are stored (tests/port_refs.py).  Whole slice at
64x64: the JAX package's Decoder decodes the port's stream to exactly the
port's recon, so does the port's own decoder, and the port agrees with
the JAX encoder on >= 99% of blocks, within 0.05 dB Y-PSNR and 1% bytes;
on the CPU the two streams are byte-identical.
"""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import port_refs
from svt_av1_tpu.api.config import EncoderConfig as JEncoderConfig
from svt_av1_tpu.api.encoder import Encoder as JEncoder
from svt_av1_tpu.codec import constants as cc
from svt_av1_tpu.codec import rate_est as jrate
from svt_av1_tpu.codec.decoder import Decoder as JDecoder
from svt_av1_tpu.ops import quant as jquant
from svt_av1_tpu.pipeline import dlf_stage as jdlf_stage
from svt_av1_tpu.pipeline import intra_encoder as jie

from svt_av1_tpu_torch import convert
from svt_av1_tpu_torch.api.encoder import Encoder, EncoderConfig
from svt_av1_tpu_torch.codec.decoder import Decoder
from svt_av1_tpu_torch.pipeline import intra_encoder as tie

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIN_AGREE = 0.99
MAX_DPSNR = 0.05
MAX_DBYTES = 0.01


def _clip(n, w, h, seed=0):
    """Smooth moving pattern + noise (the bench's synthetic clip shape)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for t in range(n):
        y = (96 + 60 * np.sin(xx / 17.0 + t * 0.13)
             + 50 * np.cos(yy / 23.0 + t * 0.02)
             + rng.integers(-5, 6, (h, w)))
        y = np.clip(y, 0, 255).astype(np.uint8)
        u = np.clip(128 + 40 * np.sin(xx[::2, ::2] / 31.0 + t * 0.05)
                    + rng.integers(-3, 4, (h // 2, w // 2)), 0,
                    255).astype(np.uint8)
        v = np.clip(128 + 40 * np.cos(yy[::2, ::2] / 29.0), 0,
                    255).astype(np.uint8)
        out.append((y, u, v))
    return out


def _wave_inputs(n, size, seed):
    """A plane of already reconstructed neighbors, a source, and every
    n x n block of it as one batch."""
    rng = np.random.default_rng(seed)
    y, _, _ = _clip(1, size, size, seed)[0]
    src = y.astype(np.int32)
    recon = np.clip(src + rng.integers(-6, 7, src.shape), 0,
                    255).astype(np.int32)
    g = size // n
    by, bx = np.divmod(np.arange(g * g), g)
    return src, recon, by, bx


@pytest.mark.parametrize("exact,modes", [(True, tie.MODES),
                                         (False, tie.MODES[:4])])
def test_rd_step_wave_matches_jax(exact, modes):
    src, recon, by, bx = _wave_inputs(16, 128, 1)
    qindex = 140
    qp = jquant.make_quant_params(qindex)
    lam = tie.frame_lambda(qindex)
    rt = jrate.md_rate_args(qindex, modes, tie.UV_MODES, exact=exact)
    b = by.size
    # the JAX package's step, jitted as it runs it (stored: port_refs)
    m_j, q_j, r_j = port_refs.jax_ref(
        f"rd_step_wave_{exact}_{len(modes)}",
        lambda: jax.jit(lambda rec, s, rates: jie._rd_step(
            rec, s, jnp.asarray(by * 16),
            jnp.asarray(bx * 16), jnp.ones(b, bool), jnp.asarray(by > 0),
            jnp.asarray(bx > 0), tuple(jnp.asarray(a) for a in qp),
            jnp.float32(lam), 16, cc.TX_16X16, modes, 0,
            tr_avail=jnp.zeros(b, bool), bl_avail=jnp.zeros(b, bool),
            rates=rates))(jnp.asarray(recon), jnp.asarray(src),
                          (rt[0], rt[2], rt[3], rt[5])),
        src, recon, np.array(modes), qindex)
    trt = convert.rate_args_from_jax(rt, device="cpu")
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    rec_t = t(recon)[None].clone()
    m_t, q_t, _ = tie._rd_step(
        rec_t, t(src)[None], torch.zeros(b, dtype=torch.int64),
        t(by * 16), t(bx * 16), torch.arange(b), t(by > 0), t(bx > 0),
        convert.quant_params_from_jax(qp, device="cpu"), torch.tensor(lam),
        modes, (trt[0], trt[2], trt[3], trt[5]))
    m_j, q_j, r_j = np.asarray(m_j), np.asarray(q_j), np.asarray(r_j)
    agree = m_t.numpy() == m_j
    print(f"luma wave: {agree.sum()} of {b} modes agree")
    assert agree.mean() >= MIN_AGREE
    assert np.array_equal(q_t.numpy()[agree], q_j[agree])
    rec = rec_t[0].numpy()
    for i in np.nonzero(agree)[0]:
        sl = np.s_[by[i] * 16:by[i] * 16 + 16, bx[i] * 16:bx[i] * 16 + 16]
        assert np.array_equal(rec[sl], r_j[sl])


def test_rd_step_chroma_wave_matches_jax():
    src_u, rec_u, by, bx = _wave_inputs(8, 64, 2)
    src_v, rec_v, _, _ = _wave_inputs(8, 64, 3)
    qindex = 140
    qp = jquant.make_quant_params(qindex)
    lam = tie.frame_lambda(qindex)
    rt = jrate.md_rate_args(qindex, tie.MODES, tie.UV_MODES, exact=True)
    b = by.size
    um_j, qu_j, qv_j, ru_j, rv_j = port_refs.jax_ref(
        "rd_step_chroma_wave", lambda: jax.jit(
            lambda ru, rv, su, sv, rates: jie._rd_step_chroma(
                ru, rv, su, sv, jnp.asarray(by * 8), jnp.asarray(bx * 8),
                jnp.ones(b, bool), jnp.asarray(by > 0), jnp.asarray(bx > 0),
                tuple(jnp.asarray(a) for a in qp), jnp.float32(lam),
                rates=rates))(
                    jnp.asarray(rec_u), jnp.asarray(rec_v),
                    jnp.asarray(src_u), jnp.asarray(src_v),
                    (rt[1], rt[2], rt[4], rt[6])),
        src_u, rec_u, src_v, rec_v, qindex)
    trt = convert.rate_args_from_jax(rt, device="cpu")
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    ru_t, rv_t = t(rec_u)[None].clone(), t(rec_v)[None].clone()
    um_t, qu_t, qv_t, _, _ = tie._rd_step_chroma(
        ru_t, rv_t, t(src_u)[None], t(src_v)[None],
        torch.zeros(b, dtype=torch.int64), t(by * 8), t(bx * 8),
        torch.arange(b), t(by > 0), t(bx > 0),
        convert.quant_params_from_jax(qp, device="cpu"), torch.tensor(lam),
        (trt[1], trt[2], trt[4], trt[6]))
    agree = um_t.numpy() == np.asarray(um_j)
    print(f"chroma wave: {agree.sum()} of {b} modes agree")
    assert agree.mean() >= MIN_AGREE
    for got, ref in ((qu_t, qu_j), (qv_t, qv_j)):
        assert np.array_equal(got.numpy()[agree], np.asarray(ref)[agree])
    for got, ref in ((ru_t, ru_j), (rv_t, rv_j)):
        for i in np.nonzero(agree)[0]:
            sl = np.s_[by[i] * 8:by[i] * 8 + 8, bx[i] * 8:bx[i] * 8 + 8]
            assert np.array_equal(got[0].numpy()[sl], np.asarray(ref)[sl])


def _encode(enc, frames):
    enc.send_pictures(frames, eos=True)
    out = []
    while (p := enc.get_packet()) is not None:
        out.append(p)
    return out


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))


def test_slice_matches_jax_package():
    frames = _clip(2, 64, 64)
    cfg = dict(source_width=64, source_height=64, qp=35, enc_mode=10)
    pk_j = _encode(JEncoder(JEncoderConfig(**cfg)), frames)
    pk_t = _encode(Encoder(EncoderConfig(**cfg), device="cpu"), frames)
    assert len(pk_t) == len(pk_j) == 2
    jdec_t, jdec_j, tdec = JDecoder(), JDecoder(), Decoder(device="cpu")
    same = total = 0
    for f, a, b in zip(frames, pk_j, pk_t):
        (rec,) = jdec_t.decode_temporal_unit(b.data)
        for k in "yuv":
            assert np.array_equal(rec[k], b.recon[k]), k
        (rec2,) = tdec.decode_temporal_unit(b.data)
        for k in "yuv":
            assert np.array_equal(rec2[k], b.recon[k]), k
        jdec_j.decode_temporal_unit(a.data)
        for key, d in jdec_t.last_decisions.items():
            e = jdec_j.last_decisions[key]
            total += 1
            same += (d.y_mode == e.y_mode and d.uv_mode == e.uv_mode
                     and all(np.array_equal(getattr(d, q), getattr(e, q))
                             for q in ("qcoeff_y", "qcoeff_u", "qcoeff_v")))
        assert abs(_psnr(f[0], a.recon["y"])
                   - _psnr(f[0], b.recon["y"])) <= MAX_DPSNR
    nb_j = sum(len(p.data) for p in pk_j)
    nb_t = sum(len(p.data) for p in pk_t)
    identical = all(a.data == b.data for a, b in zip(pk_j, pk_t))
    print(f"blocks equal {same}/{total}, bytes {nb_t} vs {nb_j}, "
          f"identical streams: {identical}")
    assert same / total >= MIN_AGREE
    assert abs(nb_t - nb_j) <= MAX_DBYTES * nb_j
    # on the CPU no forward-transform tie has flipped a decision here: the
    # port's copies of the host side code the same stream
    assert identical


@pytest.mark.parametrize("filters", ["dlf", "dlf+cdef"])
def test_send_pictures_filters_match_jax(filters):
    """M10 send_pictures with the in-loop filters, on the frames (and so
    the JAX package's compiled programs) of the slice test above.  DLF
    alone keeps the array route with the heuristic level; with CDEF both
    packages take the per-block route, which has no source: the heuristic
    DLF level, and CDEF signaled with strengths (0, 0, 0, 0) at damping 3
    (a behaviour of the reference, ROADMAP.md queue C)."""
    frames = _clip(2, 64, 64)
    cfg = dict(source_width=64, source_height=64, qp=35, enc_mode=10,
               enable_dlf_flag=1, cdef_level=int(filters == "dlf+cdef"))
    pk_j = _encode(JEncoder(JEncoderConfig(**cfg)), frames)
    pk_t = _encode(Encoder(EncoderConfig(**cfg), device="cpu"), frames)
    assert len(pk_t) == len(pk_j) == 2
    assert all(a.data == b.data for a, b in zip(pk_j, pk_t))
    jdec, tdec = JDecoder(), Decoder(device="cpu")
    for b in pk_t:
        (rec,) = jdec.decode_temporal_unit(b.data)
        (rec2,) = tdec.decode_temporal_unit(b.data)
        for k in "yuv":
            assert np.array_equal(rec[k], b.recon[k]), k
            assert np.array_equal(rec2[k], b.recon[k]), k
        fp = tdec.last_frame_header
        level = jdlf_stage.default_filter_level(fp.base_q_idx)
        assert fp.filter_level == (level, level) and level > 0
        assert fp.filter_level_uv == (level - 2, level - 2)
        assert tdec.sp.enable_cdef == (filters == "dlf+cdef")
        assert fp.cdef_strengths == (0, 0, 0, 0) and fp.cdef_damping == 3


def test_port_never_imports_jax():
    """Encodes and decodes through the port on the CPU (all-intra batch,
    key frame with the M6 tools, a hierarchical GOP) load neither JAX nor
    any module of the JAX package, and open no file under it."""
    code = textwrap.dedent("""
        import os
        import sys
        jax_pkg = os.path.join(os.getcwd(), "svt_av1_tpu") + os.sep
        opened = []
        def hook(event, args):
            if event == "open" and isinstance(args[0], str):
                opened.append(os.path.abspath(args[0]))
        sys.addaudithook(hook)
        import numpy as np
        from svt_av1_tpu_torch.api.encoder import Encoder, EncoderConfig
        from svt_av1_tpu_torch.codec.decoder import Decoder
        rng = np.random.default_rng(0)
        y = rng.integers(0, 256, (32, 32)).astype(np.uint8)
        u = rng.integers(0, 256, (16, 16)).astype(np.uint8)
        enc = Encoder(EncoderConfig(source_width=32, source_height=32),
                      device="cpu")
        enc.send_pictures([(y, u, u)], eos=True)
        pkt = enc.get_packet()
        (rec,) = Decoder(device="cpu").decode_temporal_unit(pkt.data)
        assert np.array_equal(rec["y"], pkt.recon["y"])
        y[:, 16:] = y[:, 16:] // 128 * 90       # two-color blocks: palette
        enc = Encoder(EncoderConfig(source_width=32, source_height=32,
                                    enc_mode=6, enable_dlf_flag=1,
                                    cdef_level=1), device="cpu")
        enc.send_picture(y, u, u)
        enc.flush()
        pkt = enc.get_packet()
        (rec,) = Decoder(device="cpu").decode_temporal_unit(pkt.data)
        assert np.array_equal(rec["y"], pkt.recon["y"])
        assert any(d.palette is not None for d in rec["decisions"].values())
        # a hierarchical GOP with the lookahead (MCTF, TPL): key, hidden
        # base, inter and show-existing
        enc = Encoder(EncoderConfig(source_width=32, source_height=32,
                                    intra_period_length=4,
                                    hierarchical_levels=1, enable_tf=1,
                                    enable_tpl_la=1, enable_dlf_flag=1,
                                    cdef_level=1),
                      device="cpu")
        for t in range(4):
            enc.send_picture(np.roll(y, t, axis=1), u, u)
        enc.flush()
        dec = Decoder(device="cpu")
        while (pkt := enc.get_packet()) is not None:
            for rec in dec.decode_temporal_unit(pkt.data):
                assert np.array_equal(rec["y"], pkt.recon["y"])
        bad = sorted(m for m in sys.modules if m == "jax"
                     or m.startswith("jax.") or m == "svt_av1_tpu"
                     or m.startswith("svt_av1_tpu."))
        assert not bad, f"loaded: {bad}"
        read = sorted({p for p in opened if p.startswith(jax_pkg)})
        assert not read, f"opened under svt_av1_tpu/: {read}"
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", \
        proc.stderr[-2000:]


@pytest.mark.parametrize("field,value", [
    ("intra_period_length", 15), ("encoder_bit_depth", 10)])
def test_out_of_slice_configs_raise(field, value):
    """An IPPP GOP, and 10 bits in a GOP (all-intra 10-bit streams are
    ported: tests/test_torch_10bit.py)."""
    cfg = EncoderConfig(source_width=64, source_height=64)
    setattr(cfg, field, value)
    if field == "encoder_bit_depth":
        cfg.intra_period_length, cfg.hierarchical_levels = 15, 3
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        Encoder(cfg, device="cpu")


def test_send_picture_raises():
    """send_picture codes all-intra frames; what it still raises on is a
    picture that does not match the configured geometry or bit depth."""
    enc = Encoder(EncoderConfig(source_width=32, source_height=32),
                  device="cpu")
    plane = np.zeros((32, 32), np.uint8)
    with pytest.raises(ValueError, match="geometry"):
        enc.send_picture(plane, plane, plane[:16, :16])
    with pytest.raises(ValueError, match="dtype"):
        enc.send_picture(plane.astype(np.uint16), plane[:16, :16],
                         plane[:16, :16])
    enc.send_picture(plane, plane[:16, :16], plane[:16, :16], eos=True)
    assert len(enc.get_packet().data) > 0 and enc.done


@pytest.mark.parametrize("gh,gw", [(4, 4), (18, 22), (45, 80)])
def test_wave_schedule_matches_jax(gh, gw):
    maxb = tie._natural_maxb(gh, gw)
    assert maxb == jie._natural_maxb(gh, gw)
    ref = jie._schedule_arrays(gh, gw, maxb)
    got = tie._schedule_arrays(gh, gw, maxb)
    assert got[0] == ref[0]
    for a, b in zip(got[1:], ref[1:]):
        assert np.array_equal(a, b)
    slots = tie._device_schedule(gh, gw, 2, torch.device("cpu"))
    rids = np.concatenate([s.rid.numpy() for s in slots])
    assert np.array_equal(np.sort(rids), np.arange(2 * gh * gw))
