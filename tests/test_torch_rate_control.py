"""The port's rate control through the Encoder against the JAX package on
the CPU: one-pass CBR and VBR (rate_control_mode 2 / 1) on
``send_picture``, ``send_pictures`` and the hierarchical GOP, the recode
loop, capped CRF (max_bit_rate), two passes (the pass-1 stats blob, then
the pass-2 stream) and ``reconfigure`` in mid-stream.

- Every stream is byte-identical to the JAX package's stored stream
  (tests/golden/torch_port_refs.npz, made by tools/make_torch_port_refs.py),
  and the per-frame qindex sequences are equal; each stream decodes
  exactly to Packet.recon through the port's decoder, and the JAX
  package's decoder (its stored output) decodes the port's stream to the
  same planes.
- Where a case turns stat_report on, Packet.stats equals the JAX
  package's exactly (the same numpy code on the same planes).
- The recode loop: five smooth 128x96 frames, a random one and three
  more smooth ones at a 150,000 bits/s CBR target.  The random frame
  overshoots eight times its budget and is coded once more at a higher
  qindex; the frames after it keep the JAX package's qindex and bytes.
  (A first frame cannot take the loop: one-pass CBR gives it the worst
  qindex, 252 = max_qindex, on any content at these sizes.)
- ``send_pictures`` picks one qindex per 32-frame chunk, before the
  previous chunk's bits come back (33 frames: two chunks).
"""
import contextlib
import functools

import numpy as np
import pytest
import torch

import clips
import port_refs
from svt_av1_tpu_torch.api.encoder import Encoder, EncoderConfig
from svt_av1_tpu_torch.codec import obu
from svt_av1_tpu_torch.codec.decoder import Decoder
from svt_av1_tpu_torch.utils.bitio import BitReader

torch.set_num_threads(2)
GOP = dict(intra_period_length=31, hierarchical_levels=2, enable_tf=0)
STAT_KEYS = ("psnr_y", "psnr_u", "psnr_v", "ssim_y")


def _recode_clip():
    """Five smooth frames, a random one, three more smooth ones
    (128x96)."""
    smooth = clips.natural_clip(8, 128, 96, seed=2)
    rng = np.random.default_rng(0)
    noise = (rng.integers(0, 256, (96, 128)).astype(np.uint8),
             rng.integers(0, 256, (48, 64)).astype(np.uint8),
             rng.integers(0, 256, (48, 64)).astype(np.uint8))
    return smooth[:5] + [noise] + smooth[5:]


def _noisy_clip(n, w, h, seed=3):
    """Textured frames whose bits overrun a capped-CRF budget."""
    rng = np.random.default_rng(seed)
    base = clips.natural_clip(n, w, h, seed=seed)
    return [(np.clip(y.astype(np.int32) + rng.integers(-40, 41, y.shape),
                     0, 255).astype(np.uint8), u, v) for y, u, v in base]


# name: (frames, route, EncoderConfig fields, extra): route "picture"
# (send_picture / flush), "pictures" (send_pictures, eos) or "gop"
# (send_picture / flush); extra: reconfigure=(after n frames, kwargs),
# two_pass=fields (pass 1 runs the case's fields with pass_ 1, pass 2
# adds these to them)
CASES = {
    "cbr_picture": (lambda: clips.natural_clip(8, 64, 64, seed=1),
                    "picture", dict(rate_control_mode=2,
                                    target_bit_rate=100_000), {}),
    "vbr_picture": (lambda: clips.natural_clip(8, 64, 64, seed=1),
                    "picture", dict(rate_control_mode=1,
                                    target_bit_rate=100_000,
                                    stat_report=1), {}),
    "cbr_pictures": (lambda: clips.natural_clip(8, 64, 64, seed=1),
                     "pictures", dict(rate_control_mode=2,
                                      target_bit_rate=100_000,
                                      stat_report=1), {}),
    "vbr_pictures_33": (lambda: clips.natural_clip(33, 32, 32, seed=4),
                        "pictures", dict(rate_control_mode=1,
                                         target_bit_rate=40_000), {}),
    "recode": (_recode_clip, "picture",
               dict(rate_control_mode=2, target_bit_rate=150_000, qp=30),
               {}),
    "cbr_gop": (lambda: clips.natural_clip(9, 64, 64, seed=1), "gop",
                dict(rate_control_mode=2, target_bit_rate=100_000,
                     stat_report=1, **GOP), {}),
    "vbr_gop": (lambda: clips.natural_clip(9, 64, 64, seed=1), "gop",
                dict(rate_control_mode=1, target_bit_rate=100_000, **GOP),
                {}),
    "capped_crf_picture": (lambda: _noisy_clip(8, 64, 64), "picture",
                           dict(qp=20, max_bit_rate=60_000), {}),
    "capped_crf_gop": (lambda: _noisy_clip(9, 64, 64), "gop",
                       dict(qp=20, max_bit_rate=60_000, **GOP), {}),
    "two_pass_gop": (lambda: clips.natural_clip(9, 64, 64, seed=1), "gop",
                     GOP, dict(two_pass=dict(rate_control_mode=1,
                                             target_bit_rate=60_000))),
    "reconfigure_cbr": (lambda: clips.natural_clip(8, 64, 64, seed=1),
                        "picture", dict(rate_control_mode=2,
                                        target_bit_rate=100_000),
                        dict(reconfigure=(4, dict(target_bit_rate=30_000)))),
    "reconfigure_qp": (lambda: clips.natural_clip(8, 64, 64, seed=1),
                       "picture", dict(qp=30),
                       dict(reconfigure=(4, dict(qp=45)))),
}


def config(cls, name, frames, **extra):
    h, w = frames[0][0].shape
    fields = dict(dict(dict(qp=35), **CASES[name][2]), **extra)
    return cls(source_width=w, source_height=h, **fields)


def drive(enc, route, frames, reconfigure=None):
    """Feed ``frames`` along ``route`` and drain every packet."""
    if route == "pictures":
        enc.send_pictures(frames, eos=True)
    else:
        for i, f in enumerate(frames):
            if reconfigure is not None and i == reconfigure[0]:
                enc.reconfigure(**reconfigure[1])
            enc.send_picture(*f)
        enc.flush()
    pkts = []
    while (p := enc.get_packet()) is not None:
        pkts.append(p)
    return pkts


def encode(cls, cfg_cls, name, frames, **kw):
    """(the encoder, its packets, the pass-1 blob or None) of a case with
    either package's classes."""
    _, route, _, extra = CASES[name]
    blob = None
    if extra.get("two_pass"):
        first = cls(config(cfg_cls, name, frames, pass_=1), **kw)
        drive(first, route, frames)
        blob = first.get_stats()
        enc = cls(config(cfg_cls, name, frames, pass_=2,
                         rc_stats_buffer=blob, **extra["two_pass"]), **kw)
    else:
        enc = cls(config(cfg_cls, name, frames), **kw)
    return enc, drive(enc, route, frames, extra.get("reconfigure")), blob


def qindices(obu_mod, datas):
    """base_q_idx of every coded frame of a stream, from its headers (the
    slots' order hints tracked as a decoder tracks them)."""
    sp, hints, out = None, [0] * 8, []
    for data in datas:
        for t, payload in obu_mod.parse_obus(data):
            if t == obu_mod.OBU_SEQUENCE_HEADER:
                sp = obu_mod.read_sequence_header(payload)
            elif t == obu_mod.OBU_FRAME:
                fp = obu_mod.read_frame_header(BitReader(payload), sp,
                                               ref_hints_by_slot=hints)
                out.append(fp.base_q_idx)
                refresh = fp.refresh_frame_flags
                if fp.frame_type == obu_mod.KEY_FRAME and fp.show_frame:
                    refresh = 0xFF
                for i in range(8):
                    if refresh & (1 << i):
                        hints[i] = fp.order_hint
    return out


def stats_array(pkts):
    """(n, 4) float64 of Packet.stats (NaN rows where a packet has
    none)."""
    return np.array([[p.stats[k] for k in STAT_KEYS] if p.stats else
                     [np.nan] * len(STAT_KEYS) for p in pkts], np.float64)


def decode_port(pkts):
    """The port's decoder over the packets: every shown frame, cropped to
    the render size, must equal Packet.recon (show-existing ones
    included).  Returns (the shown frames, the decoder)."""
    dec = Decoder(device="cpu")
    shown = []
    for p in pkts:
        out = dec.decode_temporal_unit(p.data)
        assert len(out) == int(p.displayed), p.pts
        for r in out:
            for k in "yuv":
                h, w = p.recon[k].shape
                assert np.array_equal(r[k][:h, :w], p.recon[k]), (p.pts, k)
            shown.append(r)
    return shown, dec


def jax_stream(name, frames, port_datas):
    """The JAX package's outputs of a case: packet count, packet bytes,
    the qindex sequence, the stats, the shown recon planes, its decoder's
    frames of the port's stream, the pass-1 blob (empty if none) and the
    recodes it made."""
    from svt_av1_tpu.api.config import EncoderConfig as JConfig
    from svt_av1_tpu.api.encoder import Encoder as JEncoder
    from svt_av1_tpu.codec import obu as jobu
    from svt_av1_tpu.codec.decoder import Decoder as JDecoder
    recodes = []
    orig = JEncoder._encode_frame

    def spy(self, *a, **k):
        if k.get("qindex_override") is not None:
            recodes.append(a[3])
        return orig(self, *a, **k)

    JEncoder._encode_frame = spy
    try:
        _, pkts, blob = encode(JEncoder, JConfig, name, frames)
    finally:
        JEncoder._encode_frame = orig
    shown = [p for p in pkts if p.displayed]
    dec = JDecoder()
    got = [r for d in port_datas for r in dec.decode_temporal_unit(d)]
    out = [np.array([len(pkts)])]
    out += [np.frombuffer(p.data, np.uint8) for p in pkts]
    out += [np.array(qindices(jobu, [p.data for p in pkts]), np.int64),
            stats_array(pkts)]
    out += [np.stack([p.recon[k] for p in shown]) for k in "yuv"]
    out += [np.stack([np.asarray(r[k]) for r in got]) for k in "yuv"]
    out += [np.frombuffer(blob or b"", np.uint8),
            np.array(recodes, np.int64)]
    return out


def stored(name, frames, datas):
    """The JAX package's stored outputs of a case whose port stream is
    ``datas`` (its packets' bytes are part of the fingerprint), unpacked;
    computed live while tools/make_torch_port_refs.py records."""
    ref = port_refs.jax_ref(
        f"rate_control_{name}", lambda: jax_stream(name, frames, datas),
        *[a for f in frames for a in f],
        np.array(sorted(map(str, CASES[name][2:])), str),
        *[np.frombuffer(d, np.uint8) for d in datas])
    n = int(ref[0][0])
    planes = lambda i0: [dict(y=ref[i0][j], u=ref[i0 + 1][j],
                              v=ref[i0 + 2][j])
                         for j in range(len(ref[i0]))]
    return dict(data=[bytes(a) for a in ref[1:1 + n]], qindex=list(ref[1 + n]),
                stats=ref[2 + n], recon=planes(3 + n), decoded=planes(6 + n),
                blob=bytes(ref[9 + n]), recodes=list(ref[10 + n]))


@contextlib.contextmanager
def recode_spy():
    """Yields the list that every recode of the port's Encoder appends
    (pts, the frame's luma shape) to while the block runs."""
    seen, orig = [], Encoder._encode_frame

    def spy(self, y, u, v, pts, qindex_override=None, recode=False):
        if recode:
            seen.append((pts, y.shape))
        return orig(self, y, u, v, pts, qindex_override=qindex_override,
                    recode=recode)

    Encoder._encode_frame = spy
    try:
        yield seen
    finally:
        Encoder._encode_frame = orig


@functools.lru_cache(maxsize=None)
def run_case(name):
    """(frames, the port's packets, its pass-1 blob, the pts of its
    recodes, the JAX package's stored outputs)."""
    frames = CASES[name][0]()
    with recode_spy() as seen:
        _, pkts, blob = encode(Encoder, EncoderConfig, name, frames,
                               device="cpu")
    return frames, pkts, blob, [pts for pts, _ in seen], stored(
        name, frames, [p.data for p in pkts])


@pytest.mark.parametrize("name", sorted(CASES))
def test_stream_matches_jax(name):
    """Bytes, the qindex sequence and (with stat_report) the stats equal
    the JAX package's; both decoders decode the port's stream exactly."""
    frames, pkts, blob, recodes, jax = run_case(name)
    datas = [p.data for p in pkts]
    shown, _ = decode_port(pkts)
    assert len(shown) == len(frames)
    q = qindices(obu, datas)
    print(f"\n{name}: qindex {q}, bytes {[len(d) for d in datas]}, "
          f"recodes at pts {recodes}")
    assert q == jax["qindex"], (q, jax["qindex"])
    assert datas == jax["data"]
    assert len(jax["decoded"]) == len(shown)
    for p, r, j in zip([p for p in pkts if p.displayed], jax["recon"],
                       jax["decoded"]):
        for k in "yuv":
            assert np.array_equal(p.recon[k], r[k]), (p.pts, k)
            assert np.array_equal(p.recon[k], j[k]), (p.pts, k)
    assert np.array_equal(stats_array(pkts), jax["stats"], equal_nan=True)
    assert recodes == jax["recodes"]
    if CASES[name][3].get("two_pass"):
        assert blob == jax["blob"] and len(blob) > 0


def test_recode_loop_recodes_once_and_rewinds():
    """The random frame (pts 5) is the one recode, at a qindex above the
    first pick; rate control and the first-pass stats see each frame
    once; the frames after it code as the JAX package's do."""
    frames, pkts, _, recodes, jax = run_case("recode")
    assert recodes == [5] == jax["recodes"]
    q = qindices(obu, [p.data for p in pkts])
    assert len(q) == len(frames)
    assert q[5] > q[4], q


def test_rate_control_moves_qindex():
    """The controllers act: CBR and VBR qindex sequences are not flat,
    capped CRF raises the qindex above CRF's once the cap's buffer fills,
    and the second reconfigure case's qindex changes at frame 4."""
    for name in ("cbr_picture", "vbr_picture", "cbr_gop", "vbr_gop"):
        q = qindices(obu, [p.data for p in run_case(name)[1]])
        assert len(set(q)) > 1, (name, q)
    capped = qindices(obu, [p.data for p in run_case(
        "capped_crf_picture")[1]])
    assert capped[0] == 80 and max(capped) > 80, capped
    q = qindices(obu, [p.data for p in run_case("reconfigure_qp")[1]])
    assert q == [120] * 4 + [180] * 4, q


def test_first_pass_stats_and_stream_info():
    """The pass-1 blob holds (bits, qindex, is_key) per coded frame in
    decode order; get_stream_info(0) returns it, another id raises."""
    from svt_av1_tpu_torch.pipeline import rate_control as rc_mod
    frames = clips.natural_clip(3, 64, 64, seed=1)
    enc = Encoder(EncoderConfig(source_width=64, source_height=64, qp=40,
                                pass_=1), device="cpu")
    pkts = drive(enc, "picture", frames)
    assert enc.get_stream_info(0) == enc.get_stats()
    st = rc_mod.unpack_first_pass_stats(enc.get_stats())
    assert st.shape == (3, 3)
    assert np.array_equal(st[:, 0], [len(p.data) * 8 for p in pkts])
    assert np.array_equal(st[:, 1], [160] * 3)
    assert np.array_equal(st[:, 2], [1.0] * 3)
    with pytest.raises(ValueError):
        enc.get_stream_info(3)
    with pytest.raises(AssertionError, match="pass-1"):
        Encoder(EncoderConfig(source_width=64, source_height=64),
                device="cpu").get_stats()


def test_recode_of_a_frame_not_a_multiple_of_16():
    """The recode codes the frame as given once more (padded and
    downscaled again from the source).  The reference passes its padded
    planes back in, pads them a second time and fails on a 120x88 frame
    (ROADMAP.md queue C item 4 (e)); the port's stream decodes exactly."""
    frames = [tuple(p[:88, :120] if i == 0 else p[:44, :60]
                    for i, p in enumerate(f)) for f in _recode_clip()]
    with recode_spy() as recodes:
        pkts = drive(Encoder(EncoderConfig(
            source_width=120, source_height=88, qp=30, rate_control_mode=2,
            target_bit_rate=150_000), device="cpu"), "picture", frames)
    assert recodes == [(5, (88, 120))]
    shown, _ = decode_port(pkts)
    assert len(shown) == len(frames)
    assert all(p.recon["y"].shape == (88, 120) for p in pkts)
