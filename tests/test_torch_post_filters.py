"""The port's key-frame post-filter and quantizer tools through the
Encoder against the JAX package on the CPU: loop restoration, superres,
film grain and adaptive quantization (AQ 1: a variance qindex map coded
as delta-q; AQ 2: the same deltas as SEG_LVL_ALT_Q segments).

- Each stream is byte-identical to the JAX package's stored stream
  (tests/golden/torch_port_refs.npz): M10 + DLF + CDEF + LR at 128x96,
  superres + LR at 160x96, film grain with estimated parameters on a noisy
  64x64 picture, AQ 1 at 128x96, AQ 2 at M8 (128x96), and a 64x64 x5 M10
  GOP (hierarchical_levels 2) with LR on its key frame; each decodes
  exactly to Packet.recon through the port's decoder, and the JAX
  package's decoder (its stored output) decodes the port's stream of each
  tool to the same planes.
- AQ 2 at M10: the reference codes no segment ids there (its
  TileEncoder.encode takes the C array walk, which has none, for plain
  16x16 DCT frames), so its stream does not decode (ROADMAP.md queue C
  item 4 (d)); the port codes them as the specification reads them, its
  recon equals the reference's, and both decoders decode its stream.
- Where the JAX package ignores a tool the port ignores it the same way:
  a GOP codes without superres and without AQ; send_pictures' array
  route signals RESTORE_NONE and the preset grain; a GOP with film grain
  raises (tests/test_torch_gop.py).
"""
import functools

import numpy as np
import pytest
import torch

import clips
import port_refs
from svt_av1_tpu_torch.api.encoder import Encoder, EncoderConfig
from svt_av1_tpu_torch.codec import lr as lr_mod
from svt_av1_tpu_torch.codec import obu
from svt_av1_tpu_torch.codec.decoder import Decoder
from svt_av1_tpu_torch.pipeline import lr_stage

torch.set_num_threads(2)
FILTERS = dict(enable_dlf_flag=1, cdef_level=1)
GOP = dict(intra_period_length=4, hierarchical_levels=2, enable_tf=0,
           enable_tpl_la=0)

# name: (frames, EncoderConfig fields); qp 35 unless given
CASES = {
    "lr_m10": (lambda: clips.natural_clip(1, 128, 96, seed=4),
               dict(enable_restoration_filtering=1, **FILTERS)),
    "superres_lr": (lambda: clips.natural_clip(1, 160, 96, seed=5),
                    dict(superres_mode=1, enable_restoration_filtering=1,
                         qp=40, **FILTERS)),
    "film_grain": (lambda: [clips.grain_frame()],
                   dict(film_grain_denoise_strength=8, qp=40)),
    "aq1": (lambda: [clips.varpart_frame()],
            dict(enable_adaptive_quantization=1)),
    "aq2_m8": (lambda: [clips.varpart_frame()],
               dict(enable_adaptive_quantization=2, enc_mode=8)),
    "aq2_m10": (lambda: [clips.varpart_frame()],
                dict(enable_adaptive_quantization=2)),
    "gop_lr": (lambda: clips.natural_clip(5, 64, 64, seed=1),
               dict(enable_restoration_filtering=1, **FILTERS, **GOP)),
}
# the reference's stream of this case does not decode (queue C item 4 (d))
REFERENCE_FAULT = ("aq2_m10",)


def _config(cls, name, frames, **extra):
    h, w = frames[0][0].shape
    fields = dict(dict(qp=35), **CASES[name][1], **extra)
    return cls(source_width=w, source_height=h, **fields)


def _encode(enc, frames):
    for f in frames:
        enc.send_picture(*f)
    enc.flush()
    pkts = []
    while (p := enc.get_packet()) is not None:
        pkts.append(p)
    return pkts


def _jax_stream(name, frames, port_datas):
    """The JAX package's stream (packet bytes, shown recon planes) and its
    decoder's shown frames of the port's stream."""
    from svt_av1_tpu.api.config import EncoderConfig as JConfig
    from svt_av1_tpu.api.encoder import Encoder as JEncoder
    from svt_av1_tpu.codec.decoder import Decoder as JDecoder
    pkts = _encode(JEncoder(_config(JConfig, name, frames)), frames)
    shown = [p for p in pkts if p.displayed]
    dec = JDecoder()
    got = [r for d in port_datas for r in dec.decode_temporal_unit(d)]
    out = [np.array([len(pkts)])]
    out += [np.frombuffer(p.data, np.uint8) for p in pkts]
    out += [np.stack([p.recon[k] for p in shown]) for k in "yuv"]
    out += [np.stack([np.asarray(r[k]) for r in got]) for k in "yuv"]
    return out


@functools.lru_cache(maxsize=None)
def _case(name):
    """(frames, the port's packets, the encoder, the JAX package's stored
    stream: packet bytes, shown recon, its decoder's frames of the port's
    stream)."""
    frames = CASES[name][0]()
    enc = Encoder(_config(EncoderConfig, name, frames), device="cpu")
    pkts = _encode(enc, frames)
    datas = [p.data for p in pkts]
    ref = port_refs.jax_ref(
        f"post_filters_{name}", lambda: _jax_stream(name, frames, datas),
        *[a for f in frames for a in f],
        np.array(sorted(CASES[name][1].items()), str),
        *[np.frombuffer(d, np.uint8) for d in datas])
    n = int(ref[0][0])
    planes = lambda i0: [dict(y=ref[i0][j], u=ref[i0 + 1][j],
                              v=ref[i0 + 2][j])
                         for j in range(len(ref[i0]))]
    jax = dict(data=[bytes(a) for a in ref[1:1 + n]], recon=planes(1 + n),
               decoded=planes(4 + n))
    return frames, pkts, enc, jax


def _decode(datas):
    dec = Decoder(device="cpu")
    shown, headers = [], []
    for d in datas:
        shown += dec.decode_temporal_unit(d)
        headers.append(dec.last_frame_header)
    return shown, headers


@pytest.mark.parametrize("name", sorted(set(CASES) - set(REFERENCE_FAULT)))
def test_stream_matches_jax(name):
    frames, pkts, _, jax = _case(name)
    assert [p.data for p in pkts] == jax["data"]


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_decoder_round_trip(name):
    """Every shown frame decodes exactly to Packet.recon; the tool shows
    in the headers (LR units coded, the superres denominator, the grain
    parameters, delta-q or segmentation)."""
    frames, pkts, enc, _ = _case(name)
    shown, headers = _decode([p.data for p in pkts])
    disp = [p for p in pkts if p.displayed]
    assert len(shown) == len(disp) == len(frames)
    for rec, p in zip(shown, disp):
        for k in "yuv":
            np.testing.assert_array_equal(rec[k], p.recon[k],
                                          err_msg=f"{name} {p.pts} {k}")
    key = headers[0]
    fields = CASES[name][1]
    if fields.get("enable_restoration_filtering"):
        assert any(t != lr_mod.RESTORE_NONE for t in key.lr_types)
        assert all(h.lr_types == (0, 0, 0) for h in headers[1:])
    if fields.get("superres_mode"):
        assert key.superres_denom == 16 and shown[0]["y"].shape == (96, 160)
    if fields.get("film_grain_denoise_strength"):
        # estimated from the noisy source, not the strength preset
        assert enc._grain_params is not None
        assert key.film_grain == enc._grain_params
    aq = fields.get("enable_adaptive_quantization")
    if aq:
        assert key.delta_q_present == (aq == 1)
        assert (key.segmentation is not None) == (aq == 2)
        assert len({d.qindex for d in shown[0]["decisions"].values()}) > 1
    print(f"{name}: {sum(len(p.data) for p in pkts)} bytes, lr "
          f"{[h.lr_types for h in headers]}")


@pytest.mark.parametrize("name", ["lr_m10", "superres_lr", "film_grain",
                                  "aq1", "aq2_m10", "gop_lr"])
def test_jax_decoder_decodes_port_stream(name):
    """The JAX package's decoder (its stored output) reproduces the port's
    recon on the port's stream of each tool (on the GOP, every shown
    frame: its inter frames predict from the restored key frame)."""
    _, pkts, _, jax = _case(name)
    disp = [p for p in pkts if p.displayed]
    assert len(jax["decoded"]) == len(disp)
    for rec, p in zip(jax["decoded"], disp):
        for k in "yuv":
            np.testing.assert_array_equal(rec[k], p.recon[k])


def test_aq2_reference_fault():
    """AQ 2 at M10: the reference's stream codes no segment ids, so it
    does not decode (the port's decoder refuses it or reproduces other
    planes); the port's recon equals the reference's (same decisions), and
    its stream differs only by coding them."""
    _, pkts, _, jax = _case("aq2_m10")
    for k in "yuv":
        np.testing.assert_array_equal(pkts[0].recon[k], jax["recon"][0][k])
    assert pkts[0].data != jax["data"][0]
    try:
        shown, _ = _decode(jax["data"])
        ok = all(np.array_equal(shown[0][k], jax["recon"][0][k])
                 for k in "yuv")
    except NotImplementedError:
        ok = False
    assert not ok


def test_gop_key_frame_slot_holds_restored_planes(monkeypatch):
    """On a GOP with LR the key frame's DPB slot holds the planes after
    loop restoration (what every inter frame predicts from, and what the
    decoder stores), not the CDEF output."""
    frames = CASES["gop_lr"][0]()
    enc = Encoder(_config(EncoderConfig, "gop_lr", frames), device="cpu")
    seen = []
    apply = lr_stage.apply_lr

    def spy(recon, deb, info, bd=8):
        out = apply(recon, deb, info, bd)
        seen.append((recon, out))
        return out

    monkeypatch.setattr(lr_stage, "apply_lr", spy)
    enc.send_picture(*frames[0])
    enc.send_picture(*frames[1])   # the key frame is coded
    (before, after), = seen
    assert any(not torch.equal(before[k], after[k]) for k in "yuv")
    for k in "yuv":
        assert torch.equal(enc._slot_recon[0][k], after[k])
    dec = Decoder(device="cpu")
    dec.decode_temporal_unit(enc.get_packet().data)
    for k in "yuv":
        assert torch.equal(dec.slots[0][k], after[k])


@functools.lru_cache(maxsize=None)
def _gop_stream(fields=()):
    frames = clips.natural_clip(5, 64, 64, seed=1)
    cfg = EncoderConfig(source_width=64, source_height=64, qp=35,
                        enc_mode=12, **dict(GOP, **dict(fields)))
    enc = Encoder(cfg, device="cpu")
    return enc, [p.data for p in _encode(enc, frames)]


@pytest.mark.parametrize("fields", [dict(superres_mode=1),
                                    dict(enable_adaptive_quantization=1),
                                    dict(enable_adaptive_quantization=2)])
def test_gop_ignores_superres_and_aq(fields):
    """As in the JAX package, a GOP codes without superres (only
    all-intra streams take it) and without AQ (its key frames take no
    variance map): the stream equals the one without the tool."""
    enc, datas = _gop_stream(tuple(fields.items()))
    assert enc.sr_denom == 8 and not enc.sp.enable_superres
    assert datas == _gop_stream()[1]


def _send_pictures_jax(frames, fields):
    from svt_av1_tpu.api.config import EncoderConfig as JConfig
    from svt_av1_tpu.api.encoder import Encoder as JEncoder
    enc = JEncoder(JConfig(source_width=64, source_height=64, qp=35,
                           **fields))
    enc.send_pictures(frames, eos=True)
    return [np.frombuffer(p.data, np.uint8)
            for p in iter(enc.get_packet, None)]


@pytest.mark.parametrize("fields", [
    dict(enable_restoration_filtering=1, enable_dlf_flag=1),
    dict(film_grain_denoise_strength=8)], ids=["lr", "film_grain"])
def test_send_pictures_array_route(fields):
    """send_pictures with LR takes the per-block route without a source,
    so every plane signals RESTORE_NONE; with film grain the array route
    signals the strength preset (no source is estimated there): both
    byte-identical to the JAX package's stream."""
    frames = clips.natural_clip(2, 64, 64, seed=2)
    enc = Encoder(EncoderConfig(source_width=64, source_height=64, qp=35,
                                **fields), device="cpu")
    enc.send_pictures(frames, eos=True)
    pkts = list(iter(enc.get_packet, None))
    want = port_refs.jax_ref(
        f"post_filters_send_pictures_{'_'.join(sorted(fields))}",
        lambda: _send_pictures_jax(frames, fields),
        *[a for f in frames for a in f], np.array(sorted(fields.items()),
                                                  str))
    assert [p.data for p in pkts] == [bytes(a) for a in want]
    shown, headers = _decode([p.data for p in pkts])
    for rec, p in zip(shown, pkts):
        for k in "yuv":
            np.testing.assert_array_equal(rec[k], p.recon[k])
    assert all(h.lr_types == (0, 0, 0) for h in headers)


def test_superres_send_pictures_is_send_picture():
    """With superres, send_pictures feeds the frames through send_picture
    one at a time, as the reference does."""
    frames = clips.natural_clip(2, 64, 64, seed=6)
    cfg = dict(source_width=64, source_height=64, qp=35, superres_mode=1)
    a = Encoder(EncoderConfig(**cfg), device="cpu")
    a.send_pictures(frames, eos=True)
    b = Encoder(EncoderConfig(**cfg), device="cpu")
    pb = _encode(b, frames)
    pa = list(iter(a.get_packet, None))
    assert [p.data for p in pa] == [p.data for p in pb]
    assert obu.OBU_FRAME in [t for t, _ in obu.parse_obus(pa[0].data)]
    assert a.sr_denom == 16
