"""The key-frame encode of presets M5-M9 through the port's entry points
vs the JAX package, on the CPU at 64x64.

``send_picture`` at M6 (tx-type search, angle deltas, CfL, palette) with
both in-loop filters on (DLF level search, CDEF strength search over the
preset's six candidates): the JAX package's Decoder decodes the port's
stream to exactly the port's recon, so does the port's own decoder, and
against the JAX Encoder on the same frames the parity rule holds: >= 99%
of blocks equal (mode, angle delta, tx type, uv mode, CfL alphas,
palette, levels), Y-PSNR within 0.05 dB, bytes within 1%.  Where the
streams are byte-identical (they are in every CPU run so far) that is
asserted too.
``send_pictures`` at M6 runs the batched program with the preset's eight
plain modes, as the reference's does.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import clips
import port_refs
from svt_av1_tpu.api.config import EncoderConfig as JEncoderConfig
from svt_av1_tpu.api.encoder import Encoder as JEncoder
from svt_av1_tpu.codec import constants as cc
from svt_av1_tpu.codec.decoder import Decoder as JDecoder

from svt_av1_tpu_torch.api.encoder import Encoder, EncoderConfig
from svt_av1_tpu_torch.codec.decoder import Decoder
from svt_av1_tpu_torch.pipeline import intra_encoder as tie
from svt_av1_tpu_torch.pipeline.presets import features_for

torch.set_num_threads(2)

W = H = 64
MIN_AGREE = 0.99
MAX_DPSNR = 0.05
MAX_DBYTES = 0.01
CFG = dict(source_width=W, source_height=H, qp=35, enc_mode=6)
FILTERS = dict(enable_dlf_flag=1, cdef_level=1)


def _frames():
    """A natural frame and a screen-content frame.  The natural frame
    carries one 16x16 two-level patch (a logo in a corner), so that it
    has a palette candidate too: the JAX package then runs both frames
    through one compiled frame program, which keeps this file inside its
    time budget."""
    y, u, v = clips.natural_clip(1, W, H)[0]
    y = y.copy()
    y[48:, 48:] = np.where(np.arange(16) % 4 < 2, 40, 210).astype(np.uint8)
    return [(y, u, v), clips.screen_frame(W, H, seed=1)]


def _drain(enc):
    out = []
    while (p := enc.get_packet()) is not None:
        out.append(p)
    return out


def _send_each(enc, frames):
    for f in frames[:-1]:
        enc.send_picture(*f)
    enc.send_picture(*frames[-1], eos=True)
    assert enc.done is False
    pk = _drain(enc)
    assert enc.done
    return pk


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))


def _same_block(d, e):
    pal_same = ((d.palette is None) == (e.palette is None)
                and (d.palette is None
                     or (np.array_equal(d.palette, e.palette)
                         and np.array_equal(d.palette_map, e.palette_map))))
    return (d.y_mode == e.y_mode and d.uv_mode == e.uv_mode
            and d.tx_type == e.tx_type
            and d.angle_delta_y == e.angle_delta_y
            and d.cfl_alpha_u == e.cfl_alpha_u
            and d.cfl_alpha_v == e.cfl_alpha_v and pal_same
            and all(np.array_equal(getattr(d, q), getattr(e, q))
                    for q in ("qcoeff_y", "qcoeff_u", "qcoeff_v")))


@pytest.fixture(scope="module")
def m6():
    """Both packages' M6 encodes of a natural and a screen-content frame
    through send_picture with DLF and CDEF on, and what three decoders make
    of them."""
    frames = _frames()
    cfg = dict(CFG, **FILTERS)
    pk_j = _send_each(JEncoder(JEncoderConfig(**cfg)), frames)
    pk_t = _send_each(Encoder(EncoderConfig(**cfg), device="cpu"), frames)
    jdec_t, jdec_j, tdec = JDecoder(), JDecoder(), Decoder(device="cpu")
    dec = []
    for a, b in zip(pk_j, pk_t):
        (by_jax,) = jdec_t.decode_temporal_unit(b.data)
        (by_port,) = tdec.decode_temporal_unit(b.data)
        jdec_j.decode_temporal_unit(a.data)
        dec.append(dict(by_jax=by_jax, by_port=by_port,
                        port_decisions=dict(jdec_t.last_decisions),
                        jax_decisions=dict(jdec_j.last_decisions),
                        header=tdec.last_frame_header))
    return dict(frames=frames, pk_j=pk_j, pk_t=pk_t, dec=dec)


def test_m6_filters_engage(m6):
    """The searches picked filter levels and CDEF strengths, and the
    filters lowered the SSE of the natural frame against the unfiltered
    reconstruction of the same decisions."""
    fp = m6["dec"][0]["header"]
    levels = [(d["header"].filter_level, d["header"].filter_level_uv,
               d["header"].cdef_strengths) for d in m6["dec"]]
    print(f"M6 filters (level y, levels uv, CDEF strengths): {levels}")
    assert fp.filter_level[0] > 0 and fp.cdef_strengths != (0, 0, 0, 0)
    assert fp.cdef_damping == 3 + (fp.base_q_idx >> 6) and fp.cdef_bits == 0
    unfiltered = tie.reconstruct_from_decisions(
        m6["dec"][0]["port_decisions"], W, H, fp.base_q_idx, device="cpu")
    sse = lambda a, b: int(((a.astype(np.int64) - b) ** 2).sum())
    src, rec = m6["frames"][0], m6["pk_t"][0].recon
    assert sum(sse(rec[k], s) for k, s in zip("yuv", src)) < sum(
        sse(unfiltered[k].numpy(), s) for k, s in zip("yuv", src))


@pytest.mark.parametrize("i,kind", [(0, "natural"), (1, "screen")])
def test_port_stream_decodes_to_its_recon(m6, i, kind):
    pkt, d = m6["pk_t"][i], m6["dec"][i]
    assert pkt.pts == i and pkt.recon["y"].shape == (H, W)
    for k in "yuv":
        assert np.array_equal(d["by_jax"][k], pkt.recon[k]), (kind, k)
        assert np.array_equal(d["by_port"][k], pkt.recon[k]), (kind, k)


def test_parity_with_the_jax_encoder(m6):
    same = total = 0
    for f, a, b, d in zip(m6["frames"], m6["pk_j"], m6["pk_t"], m6["dec"]):
        for key, blk in d["port_decisions"].items():
            total += 1
            same += _same_block(blk, d["jax_decisions"][key])
        assert abs(_psnr(f[0], a.recon["y"])
                   - _psnr(f[0], b.recon["y"])) <= MAX_DPSNR
    nb_j = sum(len(p.data) for p in m6["pk_j"])
    nb_t = sum(len(p.data) for p in m6["pk_t"])
    identical = all(a.data == b.data
                    for a, b in zip(m6["pk_j"], m6["pk_t"]))
    print(f"M6 send_picture: blocks equal {same}/{total}, bytes {nb_t} vs "
          f"{nb_j}, identical streams: {identical}")
    assert same / total >= MIN_AGREE
    assert abs(nb_t - nb_j) <= MAX_DBYTES * nb_j
    # no float tie has flipped a decision on the CPU so far: the port's
    # copies of the host side then code the same stream
    assert identical


def test_m6_streams_use_the_tools(m6):
    blocks = [b for d in m6["dec"] for b in d["port_decisions"].values()]
    n_tx = sum(b.tx_type != cc.DCT_DCT for b in blocks)
    n_delta = sum(b.angle_delta_y != 0 for b in blocks)
    n_cfl = sum(b.uv_mode == cc.UV_CFL_PRED for b in blocks)
    n_pal = sum(b.palette is not None for b in blocks)
    print(f"M6: {len(blocks)} blocks, {n_tx} non-DCT tx types, {n_delta} "
          f"angle deltas, {n_cfl} CfL, {n_pal} palette")
    assert n_tx > 0 and n_delta > 0 and n_cfl > 0 and n_pal > 0
    nat = m6["dec"][0]["port_decisions"]
    assert not any(b.palette is not None for k, b in nat.items()
                   if k != (12, 12))


def test_send_pictures_m6_matches_jax():
    """The batched program at M6: eight plain luma modes, the array tile
    coder, screen-content tools signaled in the sequence header only.  The
    JAX package's stream is stored (tests/port_refs.py)."""
    frames = clips.natural_clip(2, W, H, seed=4)

    def jax_stream():
        je = JEncoder(JEncoderConfig(**CFG))
        je.send_pictures(frames, eos=True)
        return [np.frombuffer(p.data, np.uint8) for p in _drain(je)]
    pk_j = [SimpleNamespace(data=a.tobytes()) for a in port_refs.jax_ref(
        "send_pictures_m6", jax_stream, np.array(repr(sorted(CFG.items()))),
        *(p for f in frames for p in f))]
    te = Encoder(EncoderConfig(**CFG), device="cpu")
    te.send_pictures(frames, eos=True)
    pk_t = _drain(te)
    assert len(pk_t) == len(pk_j) == 2 and te.done
    tdec, jdec = Decoder(device="cpu"), JDecoder()
    modes = set()
    for a, b in zip(pk_j, pk_t):
        (rec,) = tdec.decode_temporal_unit(b.data)
        (rec_j,) = jdec.decode_temporal_unit(b.data)
        for k in "yuv":
            assert np.array_equal(rec[k], b.recon[k]), k
            assert np.array_equal(rec_j[k], b.recon[k]), k
        modes |= {d.y_mode for d in tdec.last_decisions.values()}
        assert all(d.tx_type == cc.DCT_DCT and d.angle_delta_y == 0
                   and d.uv_mode != cc.UV_CFL_PRED
                   for d in tdec.last_decisions.values())
    assert modes <= set(features_for(6).intra_modes)
    nb_j = sum(len(p.data) for p in pk_j)
    nb_t = sum(len(p.data) for p in pk_t)
    identical = all(a.data == b.data for a, b in zip(pk_j, pk_t))
    print(f"M6 send_pictures: bytes {nb_t} vs {nb_j}, identical: "
          f"{identical}")
    assert abs(nb_t - nb_j) <= MAX_DBYTES * nb_j
    assert identical


@pytest.mark.parametrize("preset", [5, 7, 8, 9])
def test_presets_of_the_slice_encode(preset):
    """M5-M8 share M6's tool set; M9 is the M10 path."""
    f = features_for(preset)
    assert f.tx_search == f.cfl == f.palette == (preset <= 8)
    assert not f.varpart and not f.filter_intra
    assert set(f.intra_modes) <= set(tie.MODES)
    frame = clips.screen_frame(32, 32, seed=2)
    enc = Encoder(EncoderConfig(source_width=32, source_height=32, qp=35,
                                enc_mode=preset), device="cpu")
    enc.send_picture(*frame)
    enc.flush()
    (pkt,) = _drain(enc)
    (rec,) = Decoder(device="cpu").decode_temporal_unit(pkt.data)
    for k in "yuv":
        assert np.array_equal(rec[k], pkt.recon[k]), k
    if preset == 9:
        ref = Encoder(EncoderConfig(source_width=32, source_height=32,
                                    qp=35, enc_mode=10), device="cpu")
        ref.send_picture(*frame, eos=True)
        assert ref.get_packet().data == pkt.data


@pytest.mark.parametrize("preset", [5, 9, 12, 13])
def test_presets_encode_with_filters(preset):
    """DLF and CDEF through send_picture and send_pictures at the presets
    whose filter settings differ from M6's: DLF search at M5-M8, the
    heuristic level from M9; 4, 3 and 2 CDEF candidates at M9-M11, M12
    and M13.  The port's decoder reproduces every recon."""
    f = features_for(preset)
    assert f.dlf_search == (preset <= 8) and not f.cdef_sb
    assert f.cdef_candidates == {5: 6, 9: 4, 12: 3, 13: 2}[preset]
    frames = [clips.screen_frame(32, 32, seed=2),
              clips.natural_clip(1, 32, 32, seed=6)[0]]
    cfg = EncoderConfig(source_width=32, source_height=32, qp=35,
                        enc_mode=preset, **FILTERS)
    one = Encoder(cfg, device="cpu")
    pk = _send_each(one, frames)
    batch = Encoder(cfg, device="cpu")
    batch.send_pictures(frames, eos=True)
    pk += _drain(batch)
    dec = Decoder(device="cpu")
    for i, p in enumerate(pk):
        if i == len(frames):
            dec = Decoder(device="cpu")
        (rec,) = dec.decode_temporal_unit(p.data)
        for k in "yuv":
            assert np.array_equal(rec[k], p.recon[k]), (i, k)
        assert dec.sp.enable_cdef and dec.last_frame_header.filter_level[0]


@pytest.mark.parametrize("field,value,item", [
    # an IPPP GOP (hierarchical_levels 0): the hierarchical GOP is ported
    # at M10-M13, low-delay and IPPP structures are not
    ("intra_period_length", 15, "item 7")])
def test_out_of_slice_still_raises(field, value, item):
    cfg = EncoderConfig(**CFG)
    setattr(cfg, field, value)
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md.*{item}"):
        Encoder(cfg, device="cpu")


def test_encode_intra_frame_refuses_aq_and_other_modes():
    """RDOQ (with or without the qmap of a TPL delta-q key frame, which is
    ported) raises, naming its ROADMAP.md item; an id that is no luma mode
    (nor a filter-intra pseudo-mode) and a bit depth other than 8 or 10
    are refused.  (The luma modes of M0-M4, D45/D67/D203 and
    filter-intra, are ported, at 10 bits too.)"""
    y, u, v = clips.natural_clip(1, 32, 32)[0]
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tie.encode_intra_frame(y, u, v, 140, qmap=np.full((1, 1), 120),
                               rdoq=True, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tie.encode_intra_frame(y, u, v, 140, rdoq=True, device="cpu")
    with pytest.raises(ValueError, match="bit depth"):
        tie.encode_intra_frame(y, u, v, 140, modes=(cc.DC_PRED,
                                                    cc.D45_PRED), bd=12,
                               device="cpu")
    _, rec = tie.encode_intra_frame(*(p.astype(np.uint16) * 4
                                      for p in (y, u, v)), 140,
                                    modes=(cc.DC_PRED, cc.D45_PRED), bd=10,
                                    device="cpu")
    assert rec["y"].dtype == torch.int16 and int(rec["y"].max()) > 255
    with pytest.raises(ValueError, match="not luma intra modes"):
        tie.encode_intra_frame(y, u, v, 140,
                               modes=(cc.DC_PRED, cc.UV_CFL_PRED),
                               device="cpu")


@pytest.mark.parametrize("bad", ["shape", "chroma", "dtype"])
def test_send_picture_checks_geometry_and_dtype(bad):
    enc = Encoder(EncoderConfig(**CFG), device="cpu")
    y = np.zeros((H, W), np.uint8)
    c = np.zeros((H // 2, W // 2), np.uint8)
    args = dict(shape=(y[:-2], c, c), chroma=(y, c, c[:, :-1]),
                dtype=(y.astype(np.uint16), c, c))[bad]
    with pytest.raises(ValueError, match="geometry|dtype"):
        enc.send_picture(*args)
    assert enc.get_packet() is None


def test_flush_ends_the_stream_and_pads_odd_sizes():
    """40x24 codes as 48x32; the recon comes back at the render size."""
    w, h = 40, 24
    y, u, v = clips.screen_frame(w, h, seed=5)
    enc = Encoder(EncoderConfig(source_width=w, source_height=h, qp=35,
                                enc_mode=6), device="cpu")
    enc.send_picture(y, u, v)
    assert not enc.done
    enc.flush()
    (pkt,) = _drain(enc)
    assert enc.done and pkt.recon["y"].shape == (h, w)
    (rec,) = Decoder(device="cpu").decode_temporal_unit(pkt.data)
    assert np.array_equal(rec["y"][:h, :w], pkt.recon["y"])
    assert "host_ec" in enc.stage_stats()
