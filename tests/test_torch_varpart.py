"""The port's all-intra encode at presets M0-M4 against the JAX package on
the CPU:

- the variable-partition program (pipeline/varpart.py) on the 128x96
  picture of the reference's varpart tests at M4's modes with the
  filter-intra pseudo-modes: decisions (leaf sizes, modes, levels) and
  recon exact against the JAX program's stored outputs, and the port's
  reconstruction from those decisions equal to the encoder's;
- send_picture at M4 on that picture with DLF + CDEF (varpart, the
  mask-aware DLF level search, the per-SB CDEF search), at M2 on a 64x64
  screen-content picture (filter-intra blocks, D45 / D203) with DLF +
  CDEF, and send_pictures at M4 on two 64x64 pictures (the batched
  program with the five filter-intra pseudo-modes), against the JAX
  package's stored streams: byte-identical, the port's decoder equal to
  the recon, and the JAX decoder's frames of the (identical) JAX stream
  equal to the port's recon;
- per-SB CDEF strengths forced on (cdef_bits 1, alternating SB indices,
  as tests/test_cdef_sb.py forces them) on the all-intra path round-trip
  through the port's decoder;
- a 64x64 leaf whose top-right superblock sticks out of a 160-wide
  frame predicts (D45) from the samples inside the frame and repeats the
  last one past it (spec 7.11.2; ROADMAP.md queue C item 4 (c)), and a
  160x96 M4 frame (partial superblocks) round-trips.

Each case prints the blocks that use each M0-M4 tool (and asserts the
case's tools are used).
"""
import functools
from collections import Counter

import numpy as np
import pytest
import torch

import clips
import port_refs
from svt_av1_tpu_torch.api.encoder import Encoder, EncoderConfig
from svt_av1_tpu_torch.codec import constants as cc
from svt_av1_tpu_torch.codec.decoder import Decoder
from svt_av1_tpu_torch.ops import intra as intra_ops
from svt_av1_tpu_torch.pipeline import cdef_stage
from svt_av1_tpu_torch.pipeline import intra_encoder as tie
from svt_av1_tpu_torch.pipeline import varpart
from svt_av1_tpu_torch.pipeline.presets import features_for

torch.set_num_threads(2)
FILT = dict(enable_dlf_flag=1, cdef_level=1)


def tool_counts(decisions):
    """Blocks by M0-M4 tool: leaf sizes, filter-intra, D45 / D67 / D203."""
    ds = list(decisions.values())
    return dict(
        leaf16=sum(d.bsize == cc.BLOCK_16X16 for d in ds),
        leaf32=sum(d.bsize == cc.BLOCK_32X32 for d in ds),
        leaf64=sum(d.bsize == cc.BLOCK_64X64 for d in ds),
        filter_intra=sum(d.filter_intra_mode >= 0 for d in ds),
        d45=sum(d.y_mode == cc.D45_PRED for d in ds),
        d67=sum(d.y_mode == cc.D67_PRED for d in ds),
        d203=sum(d.y_mode == cc.D203_PRED for d in ds))


def _m4_modes():
    return features_for(4).intra_modes + tie.FI_MODES


@functools.lru_cache(maxsize=None)
def _varpart_pair():
    y, u, v = clips.varpart_frame()
    qidx = 160

    def jax_varpart():
        from svt_av1_tpu.pipeline import varpart as jvp
        dj, rj = jvp.encode_intra_frame_varpart(y, u, v, qidx,
                                                modes=_m4_modes())
        keys = sorted(dj)
        d = [dj[k] for k in keys]
        return (np.array(keys), np.array([b.bsize for b in d]),
                np.array([b.y_mode for b in d]),
                np.array([b.filter_intra_mode for b in d]),
                np.array([b.uv_mode for b in d]),
                np.concatenate([b.qcoeff_y.reshape(-1) for b in d]),
                np.concatenate([b.qcoeff_u.reshape(-1) for b in d]),
                np.concatenate([b.qcoeff_v.reshape(-1) for b in d]),
                rj["y"], rj["u"], rj["v"])

    want = port_refs.jax_ref("varpart_frame_m4", jax_varpart, y, u, v,
                             np.array(_m4_modes()))
    got = varpart.encode_intra_frame_varpart(y, u, v, qidx,
                                             modes=_m4_modes(), device="cpu")
    return (y, u, v), qidx, got, want


def test_varpart_frame_matches_jax():
    _, _, (dec, rec), want = _varpart_pair()
    keys = sorted(dec)
    np.testing.assert_array_equal(np.array(keys), want[0])
    d = [dec[k] for k in keys]
    for i, f in ((1, "bsize"), (2, "y_mode"), (3, "filter_intra_mode"),
                 (4, "uv_mode")):
        np.testing.assert_array_equal(np.array([getattr(b, f) for b in d]),
                                      want[i], err_msg=f)
    for i, f in ((5, "qcoeff_y"), (6, "qcoeff_u"), (7, "qcoeff_v")):
        np.testing.assert_array_equal(
            np.concatenate([getattr(b, f).reshape(-1) for b in d]), want[i],
            err_msg=f)
    for i, p in enumerate("yuv"):
        np.testing.assert_array_equal(rec[p].numpy(), want[8 + i])
    n = tool_counts(dec)
    print(f"varpart 128x96 M4: {n}")
    assert n["leaf16"] and n["leaf32"] and n["leaf64"]


def test_varpart_reconstruct_from_decisions():
    """The decoder's reconstruction (superblock waves, leaves in z-order)
    of the program's decisions equals the program's recon."""
    (y, _, _), qidx, (dec, rec), _ = _varpart_pair()
    h, w = y.shape
    got = tie.reconstruct_from_decisions(dec, w, h, qidx, device="cpu")
    for p in "yuv":
        np.testing.assert_array_equal(got[p].numpy(), rec[p].numpy())


def _packets(enc, frames, batched):
    if batched:
        enc.send_pictures(frames, eos=True)
    else:
        for f in frames:
            enc.send_picture(*f)
        enc.flush()
    out = []
    while (p := enc.get_packet()) is not None:
        out.append(p)
    return out


def _config(pkg_cfg, frames, preset, fields):
    h, w = frames[0][0].shape
    return pkg_cfg(source_width=w, source_height=h, qp=35, enc_mode=preset,
                   **fields)


def _jax_stream(frames, preset, fields, batched):
    """The JAX package's packets (bytes), recon and its decoder's frames
    of that stream, as arrays."""
    from svt_av1_tpu.api.config import EncoderConfig as JConfig
    from svt_av1_tpu.api.encoder import Encoder as JEncoder
    from svt_av1_tpu.codec.decoder import Decoder as JDecoder
    pkts = _packets(JEncoder(_config(JConfig, frames, preset, fields)),
                    frames, batched)
    dec = JDecoder()
    got = [r for p in pkts for r in dec.decode_temporal_unit(p.data)]
    out = [np.frombuffer(p.data, np.uint8) for p in pkts]
    out += [np.stack([p.recon[k] for p in pkts]) for k in "yuv"]
    out += [np.stack([r[k] for r in got]) for k in "yuv"]
    return out


STREAMS = {
    # name: (frames, preset, config fields, send_pictures)
    "m4_varpart": (lambda: [clips.varpart_frame()], 4, FILT, False),
    "m2_screen": (lambda: [clips.screen_frame(64, 64, seed=5)], 2, FILT,
                  False),
    "m4_batch": (lambda: [clips.screen_frame(64, 64, seed=s)
                          for s in (5, 6)], 4, {}, True),
}


@functools.lru_cache(maxsize=None)
def _stream(name):
    make, preset, fields, batched = STREAMS[name]
    frames = make()
    pkts = _packets(Encoder(_config(EncoderConfig, frames, preset, fields),
                            device="cpu"), frames, batched)
    ref = port_refs.jax_ref(
        f"intra_stream_{name}",
        lambda: _jax_stream(frames, preset, fields, batched),
        *[a for f in frames for a in f], np.array([preset]),
        np.array(sorted(fields.items())), np.array([batched]))
    n = len(frames)
    return frames, pkts, ref[:n], ref[n:n + 3], ref[n + 3:n + 6]


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_intra_stream_matches_jax(name):
    """Byte-identical to the JAX package's stream; the port's decoder
    reproduces the port's recon, and the JAX decoder's frames of the JAX
    stream (the same bytes) equal it too."""
    frames, pkts, data, recon, jdec = _stream(name)
    assert len(pkts) == len(frames)
    identical = [p.data == bytes(d) for p, d in zip(pkts, data)]
    dec = Decoder(device="cpu")
    counts = Counter()
    for i, p in enumerate(pkts):
        (rec,) = dec.decode_temporal_unit(p.data)
        for j, k in enumerate("yuv"):
            np.testing.assert_array_equal(rec[k], p.recon[k],
                                          err_msg=f"{name} {i} {k}")
            np.testing.assert_array_equal(recon[j][i], p.recon[k])
            np.testing.assert_array_equal(jdec[j][i], p.recon[k])
        counts.update(tool_counts(dec.last_decisions))
        fp = dec.last_frame_header
        print(f"{name} frame {i}: {len(p.data)} bytes, DLF "
              f"{fp.filter_level}/{fp.filter_level_uv}, cdef_bits "
              f"{fp.cdef_bits}")
    print(f"{name}: byte-identical {identical}; tools {dict(counts)}")
    assert all(identical)
    need = dict(m4_varpart=("leaf16", "leaf32", "leaf64", "filter_intra"),
                m2_screen=("filter_intra", "d45", "d203", "leaf32"),
                m4_batch=("filter_intra",))[name]
    for k in need:
        assert counts[k] > 0, f"{name}: no {k} block"


def test_forced_per_sb_cdef_round_trips(monkeypatch):
    """cdef_bits 1 with alternating SB indices on the all-intra path: the
    tile codes each SB's index and the port's decoder applies the per-SB
    strengths to the encoder's recon."""
    def forced(src, recon, skip16, qindex, bd=8, max_candidates=8):
        gr, gc = (skip16.shape[0] + 3) // 4, (skip16.shape[1] + 3) // 4
        idx = (np.indices((gr, gc)).sum(axis=0) % 2).astype(np.int32)
        return 1, ((4, 1, 4, 1), (0, 0, 0, 0)), idx

    monkeypatch.setattr(cdef_stage, "cdef_search_sb", forced)
    frames = [clips.varpart_frame()]
    (pkt,) = _packets(Encoder(_config(EncoderConfig, frames, 4, FILT),
                              device="cpu"), frames, False)
    dec = Decoder(device="cpu")
    (rec,) = dec.decode_temporal_unit(pkt.data)
    assert dec.last_frame_header.cdef_bits == 1
    for k in "yuv":
        np.testing.assert_array_equal(rec[k], pkt.recon[k])


def test_partial_superblock_top_right_repeats_frame_edge():
    """A 64x64 D45 leaf in the last whole superblock column of a 160-wide
    frame: its top-right superblock is half outside the frame, so (spec
    7.11.2) the top-right is available and the samples past the frame's
    last column repeat it.  The decoder's reconstruction of that leaf
    equals zone-1 prediction over that edge."""
    from svt_av1_tpu_torch.codec.syntax import BlockDecision
    rng = np.random.default_rng(4)
    w, h = 160, 128
    z = lambda n: np.zeros((n, n), np.int32)

    def leaf(r4, c4, n, mode=cc.DC_PRED, textured=True):
        qy = (rng.integers(-20, 21, (32, 32)).astype(np.int32) if textured
              else z(32))
        bs = cc.BLOCK_64X64 if n == 64 else cc.BLOCK_32X32
        return BlockDecision(r4=r4, c4=c4, bsize=bs, y_mode=mode,
                             uv_mode=cc.DC_PRED, tx_type=cc.DCT_DCT,
                             qcoeff_y=qy, qcoeff_u=z(n // 2),
                             qcoeff_v=z(n // 2))

    ds = [leaf(0, 0, 64), leaf(0, 16, 64), leaf(0, 32, 32), leaf(8, 32, 32),
          leaf(16, 0, 64), leaf(16, 16, 64, cc.D45_PRED, textured=False),
          leaf(16, 32, 32), leaf(24, 32, 32)]
    rec = tie.reconstruct_from_decisions({(d.r4, d.c4): d for d in ds}, w,
                                         h, 120, device="cpu")
    y = rec["y"].numpy().astype(np.int32)
    row = y[63]
    ext = np.concatenate([row[64:160], np.full(33, row[159])])[None]
    want = intra_ops.z1_pred(torch.as_tensor(ext), 64, 64, 45)[0].numpy()
    np.testing.assert_array_equal(y[64:128, 64:128], want)
    assert len(set(row[128:160].tolist())) > 1      # a textured edge


def test_varpart_partial_superblocks_round_trip():
    """A 160x96 frame (a half superblock column and row past the whole
    ones) at M4 with the filters: the varpart program's leaves there and
    the decoder's reconstruction agree exactly."""
    frames = [clips.varpart_frame(h=96, w=160, seed=3)]
    (pkt,) = _packets(Encoder(_config(EncoderConfig, frames, 4, FILT),
                              device="cpu"), frames, False)
    dec = Decoder(device="cpu")
    (rec,) = dec.decode_temporal_unit(pkt.data)
    for k in "yuv":
        np.testing.assert_array_equal(rec[k], pkt.recon[k])
    n = tool_counts(dec.last_decisions)
    print(f"varpart 160x96 M4: {n}")
    assert n["leaf32"] + n["leaf64"] > 0
