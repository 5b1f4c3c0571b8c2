"""The port's lookahead (MCTF and TPL) and its delta-q key frames against
the JAX package on the CPU.

- SATD exact on random residuals (+-255 blocks included).
- MCTF: the subblock weights and the filter (ops/tf.py) on random and
  natural-clip blocks with F = 1, 2, 3, and mctf_filter_frame on a natural
  clip (the key's 2 neighbours, the base's 3, a size that is not a
  multiple of 32), under the tie rule: a filtered pixel may differ from
  the reference's by 1 only where the float64 value of accum / count lies
  within 1e-3 of a half-integer (tests/tie_rule.py); the flips are
  printed, luma and chroma apart.
- TPL: gop_fast.tpl_group_stats exact (intra, inter, MVs, reference
  choice) over a key's IPP chain and over a mini-GoP schedule with
  two-reference frames and an IPP tail; synthesize, r0, beta_qmap and
  crf_qindex_calc equal.
- The delta-q key frame: encode_intra_frame(qmap=...) decisions, per-block
  qindex and recon exact, the packet coded with delta-q byte-identical,
  both decoders reproducing the recon.
- The GOP with the lookahead (M10, MCTF + TPL, DLF + CDEF, 128x96, two key
  frames, one coded with delta-q): with the reference's filtered planes
  put in place of the port's MCTF the stream is byte-identical to the
  JAX package's; with the port's own MCTF it meets the parity rule (byte
  identity required when no MCTF pixel flipped); the port's decoder
  reproduces both, and the JAX package's decoder the first packets live.

The JAX package's outputs are stored in tests/golden/torch_port_refs.npz
(tests/port_refs.py; remade by tools/make_torch_port_refs.py).
"""
import functools

import numpy as np
import pytest
import torch

import clips
import port_refs
import tie_rule
from svt_av1_tpu_torch.api import encoder as enc_mod
from svt_av1_tpu_torch.api.encoder import Encoder, EncoderConfig
from svt_av1_tpu_torch.codec import obu
from svt_av1_tpu_torch.codec.decoder import Decoder
from svt_av1_tpu_torch.ops import satd
from svt_av1_tpu_torch.ops import tf as tf_ops
from svt_av1_tpu_torch.pipeline import gop, gop_fast, intra_encoder, tf_stage
from svt_av1_tpu_torch.pipeline import tpl
from svt_av1_tpu_torch.pipeline.presets import features_for
from svt_av1_tpu_torch.pipeline.rate_control import crf_qindex_calc

torch.set_num_threads(2)
DECAY = 80.0


def test_hadamard_and_satd_exact():
    from svt_av1_tpu.ops import satd as jsatd
    from svt_av1_tpu.pipeline import tpl as jtpl
    rng = np.random.default_rng(31)
    d = rng.integers(-255, 256, (400, 8, 8)).astype(np.int32)
    d[:8] = 255
    d[8:16] = -255
    d[16:32] = np.where(rng.random((16, 8, 8)) < 0.5, 255, -255)
    t = torch.from_numpy(d)
    np.testing.assert_array_equal(satd.hadamard_8x8(t).numpy(),
                                  np.asarray(jsatd.hadamard_8x8(d)))
    got = satd.satd(t).numpy()
    np.testing.assert_array_equal(got, np.asarray(jsatd.satd(d)))
    d16 = d.reshape(100, 16, 16)
    got16 = tpl._satd16(torch.from_numpy(d16)).numpy()
    np.testing.assert_array_equal(got16, np.asarray(jtpl._satd16(d16)))
    assert got16.max() < 2 ** 24
    print(f"SATD: 400 8x8 blocks exact, max {got.max()}; 100 16x16 "
          f"blocks exact, max {got16.max()}")


# ------------------------------------------------------------------ MCTF ---

def _quad_sse(center, preds):
    """(B, F, 4) subblock SSE / 256 (the reference's block error
    domain)."""
    d = (center[:, None].astype(np.int64) - preds) ** 2
    q = [d[..., :16, :16], d[..., :16, 16:], d[..., 16:, :16],
         d[..., 16:, 16:]]
    return (np.stack([x.sum(axis=(-2, -1)) for x in q], -1)
            / 256.0).astype(np.float32)


def _tf_inputs(kind, F):
    rng = np.random.default_rng(40 + F)
    if kind == "random":
        center = rng.integers(0, 256, (16, 32, 32))
        preds = np.clip(center[:, None]
                        + rng.integers(-30, 31, (16, F, 32, 32)), 0, 255)
    else:
        # 32x32 tiles of a natural clip frame and the co-located tiles of
        # its neighbours
        fr = clips.natural_clip(F + 1, 128, 96, seed=8)
        tiles = lambda y: (y.reshape(3, 32, 4, 32).transpose(0, 2, 1, 3)
                           .reshape(12, 32, 32))
        center = tiles(fr[0][0])
        preds = np.stack([tiles(fr[i + 1][0]) for i in range(F)], 1)
    center = center.astype(np.int32)
    preds = preds.astype(np.int32)
    mvs = rng.integers(-6, 7, preds.shape[:2] + (4, 2)).astype(np.float32)
    return center, preds, _quad_sse(center, preds), mvs


@pytest.mark.parametrize("F", [1, 2, 3])
@pytest.mark.parametrize("kind", ["random", "clip"])
def test_temporal_filter_tie_rule(kind, F):
    center, preds, berr, mvs = _tf_inputs(kind, F)

    def jax_tf():
        from svt_av1_tpu.ops import tf as jtf
        return (jtf.subblock_weights(center, preds, berr, mvs, DECAY, 16.0),
                np.asarray(jtf.temporal_filter(center, preds, berr, mvs,
                                               decay_factor=DECAY),
                           np.uint8))

    w_ref, f_ref = port_refs.jax_ref(f"tf_{kind}_{F}", jax_tf, center,
                                     preds, berr, mvs)
    t = [torch.from_numpy(a) for a in (center, preds, berr, mvs)]
    w = tf_ops.subblock_weights(*t, DECAY, 16.0).numpy()
    got = tf_ops.temporal_filter(*t, decay_factor=DECAY).numpy()
    exact = tf_ops.temporal_filter(*t, decay_factor=DECAY,
                                   dtype=torch.float64, raw=True).numpy()
    # exp is not correctly rounded: the weights agree to a few ulps
    ulps = np.abs(w - w_ref) / np.spacing(np.maximum(w_ref, 1e-30))
    assert ulps.max() <= 8, f"weights {ulps.max()} ulps apart"
    flips, _ = tie_rule.pixel_flips(got, f_ref, exact)
    print(f"temporal_filter {kind} F={F}: {got.size} pixels, flips "
          f"{flips}, weights within {int(ulps.max())} ulps, "
          f"{int((got != center).sum())} pixels changed")


MCTF_CASES = {
    # name: (width, height, center index, neighbour indices)
    "key": (96, 96, 0, (1, 2)),
    "base": (96, 96, 2, (1, 3, 0)),
    "odd": (100, 84, 1, (2,)),
}


def _mctf_inputs(name):
    w, h, c, nb = MCTF_CASES[name]
    fr = clips.natural_clip(4, w, h, seed=12)
    return fr[c], [fr[i] for i in nb]


@pytest.mark.parametrize("name", sorted(MCTF_CASES))
def test_mctf_filter_frame_tie_rule(name):
    center, neighbors = _mctf_inputs(name)

    def jax_mctf():
        from svt_av1_tpu.pipeline import tf_stage as jtf
        return jtf.mctf_filter_frame(center, neighbors)

    want = port_refs.jax_ref(f"mctf_{name}", jax_mctf, *center,
                             *[a for n in neighbors for a in n])
    got = tf_stage.mctf_filter_frame(center, neighbors, device="cpu")
    exact = tf_stage.mctf_filter_frame(center, neighbors, device="cpu",
                                       dtype=torch.float64, raw=True)
    flips = [tie_rule.pixel_flips(g, r, e)[0]
             for g, r, e in zip(got, want, exact)]
    for g, c in zip(got, center):
        assert g.dtype == np.uint8 and g.shape == c.shape
    print(f"mctf_filter_frame {name} {center[0].shape[1]}x"
          f"{center[0].shape[0]} F={len(neighbors)}: flips luma "
          f"{flips[0]}, chroma {flips[1] + flips[2]}; pixels changed "
          f"{[int((g != c).sum()) for g, c in zip(got, center)]}")


# ------------------------------------------------------------------- TPL ---

def _group(name):
    """(sources, deps): a key's IPP chain, or the encoder's mini-GoP group
    (hierarchical_levels 2 after anchor 0, decode order) with an IPP tail
    of two frames."""
    srcs = [f[0] for f in clips.split_motion_clip(7)]
    if name == "key_chain":
        return srcs[:5], [None, [0], [1], [2], [3]]
    order, deps = tpl.minigop_group(0, gop.minigop_schedule(0, 4), (5, 6))
    return [srcs[p] for p in order], deps


STAT_KEYS = ("intra", "inter", "mv", "ref_sel")


@pytest.mark.parametrize("name", ["key_chain", "minigop"])
def test_tpl_group_stats_exact(name):
    srcs, deps = _group(name)
    assert name == "key_chain" or any(d and len(d) == 2 for d in deps)

    def jax_stats():
        from svt_av1_tpu.pipeline import gop_fast as jgf
        st = jgf.tpl_group_stats(srcs, deps)
        return [s[k] for s in st for k in STAT_KEYS]

    flat = port_refs.jax_ref(f"tpl_{name}", jax_stats, *srcs,
                             np.array([len(d or ()) for d in deps]),
                             np.array([j for d in deps for j in d or ()]))
    want = [dict(zip(STAT_KEYS, flat[4 * i:4 * i + 4]), gh=6, gw=8)
            for i in range(len(srcs))]
    got = gop_fast.tpl_group_stats(srcs, deps, device="cpu")
    for i, (g, r) in enumerate(zip(got, want)):
        for k in STAT_KEYS:
            np.testing.assert_array_equal(g[k], r[k], err_msg=f"{i} {k}")
            assert g[k].dtype == r[k].dtype, k
    from svt_av1_tpu.pipeline import rate_control as jrc
    from svt_av1_tpu.pipeline import tpl as jtpl
    dep_g, dep_r = tpl.synthesize(got, deps), jtpl.synthesize(want, deps)
    for a, b in zip(dep_g, dep_r):
        np.testing.assert_array_equal(a, b)
    r0 = [tpl.r0_of(s, d) for s, d in zip(got, dep_g)]
    assert r0 == [jtpl.r0_of(s, d) for s, d in zip(want, dep_r)]
    q, arf = crf_qindex_calc(140, r0[0], 0, 2, True)
    assert (q, arf) == jrc.crf_qindex_calc(140, r0[0], 0, 2, True)
    qmap = tpl.beta_qmap(got[0], dep_g[0], q)
    np.testing.assert_array_equal(qmap, jtpl.beta_qmap(want[0], dep_r[0],
                                                       q))
    if name == "minigop":
        layers = [(r, crf_qindex_calc(140, r, 1, 2, False, arf_q=arf,
                                      is_leaf=True)) for r in r0[1:]]
        assert layers == [(r, jrc.crf_qindex_calc(
            140, r, 1, 2, False, arf_q=arf, is_leaf=True)) for r in r0[1:]]
    print(f"TPL {name}: {len(srcs)} frames exact, r0 "
          f"{[round(x, 4) for x in r0]}, key qindex {q}, qmap "
          f"{qmap.tolist()}, blocks taking the second reference "
          f"{[int(s['ref_sel'].sum()) for s in got]}")


# ------------------------------------------------------ delta-q key frame ---

QMAP = np.array([[128, 140], [152, 136]])
KEY_CFG = dict(source_width=128, source_height=96, enc_mode=10)


def _block_rows(decisions):
    """Per-block decision fields in raster order, as int arrays."""
    ks = sorted(decisions)
    scal = np.array([[getattr(decisions[k], f) for f in (
        "y_mode", "uv_mode", "tx_type", "angle_delta_y", "cfl_alpha_u",
        "cfl_alpha_v", "qindex")] for k in ks])
    levels = [np.stack([np.asarray(getattr(decisions[k], f)) for k in ks])
              for f in ("qcoeff_y", "qcoeff_u", "qcoeff_v")]
    return [scal] + levels


@functools.lru_cache(maxsize=None)
def _qmap_key():
    y, u, v = clips.split_motion_clip(1)[0]
    feat = features_for(10)
    kw = dict(modes=feat.intra_modes,
              exact_rates=feat.exact_rates and feat.exact_rates_intra)

    def jax_key():
        from svt_av1_tpu.api.config import EncoderConfig as JConfig
        from svt_av1_tpu.api.encoder import Encoder as JEncoder
        from svt_av1_tpu.codec.decoder import Decoder as JDecoder
        from svt_av1_tpu.pipeline import intra_encoder as jie
        dec, rec = jie.encode_intra_frame(y, u, v, 140, qmap=QMAP, **kw)
        pkt = JEncoder(JConfig(**KEY_CFG))._packetize(dec, rec, 140, 0,
                                                       delta_q=True)
        (out,) = JDecoder().decode_temporal_unit(pkt.data)
        return (_block_rows(dec) + [np.asarray(rec[k]) for k in "yuv"]
                + [np.frombuffer(pkt.data, np.uint8)]
                + [out[k] for k in "yuv"])

    ref = port_refs.jax_ref("qmap_key", jax_key, y, u, v, QMAP)
    dec, rec = intra_encoder.encode_intra_frame(y, u, v, 140, qmap=QMAP,
                                                device="cpu", **kw)
    return dec, rec, ref


def test_qmap_key_frame_matches_jax():
    dec, rec, ref = _qmap_key()
    for a, b, what in zip(_block_rows(dec), ref[:4],
                          ("modes / qindex", "qy", "qu", "qv")):
        np.testing.assert_array_equal(a, b, err_msg=what)
    for k, want in zip("yuv", ref[4:7]):
        np.testing.assert_array_equal(rec[k].numpy(), want)
    qidx = sorted({d.qindex for d in dec.values()})
    assert qidx == sorted(set(QMAP.ravel().tolist()))
    print(f"qmap key frame: {len(dec)} blocks exact, per-block qindex "
          f"{qidx}")


def test_qmap_key_frame_packet_and_decoders():
    dec, rec, ref = _qmap_key()
    pkt = Encoder(EncoderConfig(**KEY_CFG), device="cpu")._packetize(
        dec, rec, 140, 0, delta_q=True)
    assert pkt.data == ref[7].tobytes()
    d = Decoder(device="cpu")
    (out,) = d.decode_temporal_unit(pkt.data)
    assert d.last_frame_header.delta_q_present
    assert d.last_frame_header.delta_q_res == 2
    for k, jax_dec in zip("yuv", ref[8:11]):
        np.testing.assert_array_equal(out[k], pkt.recon[k])
        np.testing.assert_array_equal(jax_dec, pkt.recon[k])
    print(f"qmap key frame: {len(pkt.data)} bytes, identical to the JAX "
          "package's; the port's decoder and (stored) the JAX decoder "
          "reproduce the recon")


# --------------------------------------------------- the lookahead GOP ---

LA = dict(enc_mode=10, hierarchical_levels=2, intra_period_length=4, qp=35,
          enable_tf=1, enable_tpl_la=1, enable_dlf_flag=1, cdef_level=1)


def _la_frames():
    return clips.split_motion_clip(7)


def _la_config(pkg_cfg, frames):
    h, w = frames[0][0].shape
    return pkg_cfg(source_width=w, source_height=h, **LA)


def _drain(enc, frames):
    for f in frames:
        enc.send_picture(*f)
    enc.flush()
    pkts = []
    while (p := enc.get_packet()) is not None:
        pkts.append(p)
    return pkts


def _poc_of(frames, y):
    (poc,) = [i for i, f in enumerate(frames) if np.array_equal(f[0], y)]
    return poc


def _jax_la_stream():
    """The JAX package's stream, its shown recon, every MCTF call's
    centre poc, neighbour count and filtered planes (in call order), and
    the JAX package's decoder's output on the stream."""
    from svt_av1_tpu.api.config import EncoderConfig as JConfig
    from svt_av1_tpu.api.encoder import Encoder as JEncoder
    from svt_av1_tpu.codec.decoder import Decoder as JDecoder
    from svt_av1_tpu.pipeline import tf_stage as jtf
    frames = _la_frames()
    calls = []
    orig = jtf.mctf_filter_frame

    def record(center, neighbors, *a, **k):
        out = orig(center, neighbors, *a, **k)
        calls.append((_poc_of(frames, center[0]), len(neighbors), out))
        return out

    jtf.mctf_filter_frame = record
    try:
        pkts = _drain(JEncoder(_la_config(JConfig, frames)), frames)
    finally:
        jtf.mctf_filter_frame = orig
    shown = [p for p in pkts if p.displayed]
    out = [np.array([len(pkts), len(calls)]),
           np.array([p.displayed for p in pkts]),
           np.array([(c[0], c[1]) for c in calls])]
    out += [np.frombuffer(p.data, np.uint8) for p in pkts]
    out += [np.stack([p.recon[k] for p in shown]) for k in "yuv"]
    out += [pl for c in calls for pl in c[2]]
    dec = JDecoder()
    decoded = [f for p in pkts for f in dec.decode_temporal_unit(p.data)]
    out += [np.stack([f[k] for f in decoded]) for k in "yuv"]
    return out


@functools.lru_cache(maxsize=1)
def _la_ref():
    frames = _la_frames()
    ref = port_refs.jax_ref("la_gop_m10", _jax_la_stream,
                            *[a for f in frames for a in f],
                            np.array([f"{k}={v}" for k, v in
                                      sorted(LA.items())]))
    n, nc = (int(x) for x in ref[0])
    data = [bytes(a) for a in ref[3:3 + n]]
    recon = ref[3 + n:6 + n]
    calls = [(int(ref[2][i][0]), int(ref[2][i][1]),
              tuple(ref[6 + n + 3 * i:9 + n + 3 * i])) for i in range(nc)]
    return frames, dict(data=data, displayed=list(ref[1]), recon=recon,
                        calls=calls, jax_decoded=ref[6 + n + 3 * nc:])


@functools.lru_cache(maxsize=None)
def _la_port(mode):
    """The port's lookahead GOP on the CPU: with the stored JAX MCTF
    planes in place of its own ("jax_mctf"), or its own MCTF ("own"),
    whose outputs are recorded with the flips against the JAX planes."""
    frames, ref = _la_ref()
    calls = []
    orig = tf_stage.mctf_filter_frame

    def replay(center, neighbors, *a, **k):
        poc, nf, planes = ref["calls"][len(calls)]
        assert (poc, nf) == (_poc_of(frames, center[0]), len(neighbors))
        calls.append(None)
        return planes

    def own(center, neighbors, *a, **k):
        out = orig(center, neighbors, *a, **k)
        poc, nf, planes = ref["calls"][len(calls)]
        assert (poc, nf) == (_poc_of(frames, center[0]), len(neighbors))
        exact = orig(center, neighbors, *a, dtype=torch.float64, raw=True,
                     **k)
        calls.append([tie_rule.pixel_flips(g, r, e)[0]
                      for g, r, e in zip(out, planes, exact)])
        return out

    enc_mod.tf_stage.mctf_filter_frame = replay if mode == "jax_mctf" \
        else own
    try:
        pkts = _drain(Encoder(_la_config(EncoderConfig, frames),
                              device="cpu"), frames)
    finally:
        enc_mod.tf_stage.mctf_filter_frame = orig
    assert len(calls) == len(ref["calls"])
    return pkts, calls


def _decode(datas):
    dec = Decoder(device="cpu")
    shown, headers = [], []
    for d in datas:
        shown += dec.decode_temporal_unit(d)
        if obu.OBU_FRAME in [t for t, _ in obu.parse_obus(d)]:
            headers.append(dec.last_frame_header)
    return shown, headers


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 99.0 if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


@pytest.mark.parametrize("mode", ["jax_mctf", "own"])
def test_lookahead_gop_round_trip(mode):
    """The port's decoder reproduces every shown frame; two key frames,
    at least one coded with delta-q; MCTF ran on both key frames and the
    mini-GoP base."""
    frames, ref = _la_ref()
    pkts, calls = _la_port(mode)
    shown, headers = _decode([p.data for p in pkts])
    disp = [p for p in pkts if p.displayed]
    assert len(shown) == len(disp) == len(frames)
    for rec, p in zip(shown, disp):
        for k in "yuv":
            np.testing.assert_array_equal(rec[k], p.recon[k])
    keys = [h for h in headers if h.frame_type == obu.KEY_FRAME]
    assert len(keys) == 2 and any(h.delta_q_present for h in keys)
    assert len(calls) == 3
    print(f"lookahead GOP ({mode}): {len(pkts)} packets, key qindex "
          f"{[h.base_q_idx for h in keys]}, delta-q "
          f"{[h.delta_q_present for h in keys]}, inter qindex "
          f"{[h.base_q_idx for h in headers if h.frame_type != 0]}")


def test_lookahead_gop_with_jax_mctf_is_byte_identical():
    _, ref = _la_ref()
    pkts, _ = _la_port("jax_mctf")
    assert [p.data for p in pkts] == ref["data"]
    assert [p.displayed for p in pkts] == ref["displayed"]
    disp = [p for p in pkts if p.displayed]
    for i, k in enumerate("yuv"):
        np.testing.assert_array_equal(
            np.stack([p.recon[k] for p in disp]), ref["recon"][i])


def test_lookahead_gop_parity_with_jax():
    """The port's own MCTF: >= 99% of blocks equal, Y-PSNR within 0.05 dB,
    bytes within 1%; byte identity when no MCTF pixel flipped."""
    frames, ref = _la_ref()
    pkts, calls = _la_port("own")
    flips = np.array(calls)                        # (calls, planes)
    dec_p = Decoder(device="cpu")
    dec_j = Decoder(device="cpu")
    same = tot = 0
    for a, b in zip([p.data for p in pkts], ref["data"]):
        dec_p.decode_temporal_unit(a)
        dec_j.decode_temporal_unit(b)
        if obu.OBU_FRAME not in [t for t, _ in obu.parse_obus(a)]:
            continue
        for k, blk in dec_p.last_decisions.items():
            o = dec_j.last_decisions.get(k)
            tot += 1
            same += bool(o is not None and blk.bsize == o.bsize
                         and blk.is_inter == o.is_inter
                         and blk.y_mode == o.y_mode and blk.mv == o.mv
                         and blk.qindex == o.qindex
                         and np.array_equal(blk.qcoeff_y, o.qcoeff_y))
    disp = [p for p in pkts if p.displayed]
    p_port = np.mean([_psnr(frames[p.pts][0], p.recon["y"]) for p in disp])
    p_jax = np.mean([_psnr(frames[i][0], r)
                     for i, r in enumerate(ref["recon"][0])])
    b_port = sum(len(p.data) for p in pkts)
    b_jax = sum(len(d) for d in ref["data"])
    identical = [p.data for p in pkts] == ref["data"]
    print(f"lookahead GOP, own MCTF: flips per call (y, u, v) "
          f"{flips.tolist()}; {same / tot:.2%} of {tot} blocks equal, "
          f"Y-PSNR {p_port:.4f} vs {p_jax:.4f} dB, bytes {b_port} vs "
          f"{b_jax}, streams identical: {identical}")
    assert same / tot >= 0.99
    assert abs(p_port - p_jax) <= 0.05
    assert abs(b_port - b_jax) <= 0.01 * b_jax
    if flips.sum() == 0:
        assert identical


def test_jax_decoder_decodes_lookahead_stream():
    """One live cross-run: the JAX package's decoder on the port's
    delta-q key frame (the whole stream takes it about 50 s here; its
    inter frames are held live in tests/test_torch_gop.py).  Where the
    port's stream equals the JAX package's, the JAX decoder's stored
    output on that whole stream must equal the port's recon too."""
    from svt_av1_tpu.codec.decoder import Decoder as JDecoder
    _, ref = _la_ref()
    pkts, _ = _la_port("own")
    assert pkts[0].frame_type == obu.KEY_FRAME
    dec = JDecoder()
    (rec,) = dec.decode_temporal_unit(pkts[0].data)
    assert len({d.qindex for d in dec.last_decisions.values()}) > 1
    for k in "yuv":
        np.testing.assert_array_equal(rec[k], pkts[0].recon[k])
    if [p.data for p in pkts] == ref["data"]:
        disp = [p for p in pkts if p.displayed]
        for i, k in enumerate("yuv"):
            np.testing.assert_array_equal(
                ref["jax_decoded"][i], np.stack([p.recon[k] for p in disp]))


@pytest.mark.parametrize("preset", [10, 11, 12, 13])
def test_lookahead_config_accepted(preset):
    """The bench's GOP structure with the reference's default tools (MCTF
    on by default, TPL on) no longer raises at M10-M13."""
    cfg = EncoderConfig(source_width=64, source_height=64,
                        intra_period_length=15, hierarchical_levels=3,
                        enable_tpl_la=1, enc_mode=preset)
    assert cfg.enable_tf == 1
    enc = Encoder(cfg, device="cpu")
    assert enc._tf_active() and enc.recon_enabled
