"""The rest of the port's API surface against the JAX package on the CPU:
HDR metadata OBUs, stat reports, tile columns on the all-intra batch,
and the settings the JAX package ignores.

- The metadata temporal unit (content light level + mastering display
  after the sequence header) and the tiled ``send_pictures`` streams (the
  cases of tests/test_tiles.py: 128x64 with tile_columns=1, 352x64 with
  tile_columns=2) are byte-identical to the JAX package's stored streams
  (tests/golden/torch_port_refs.npz); each decodes exactly to Packet.recon
  through the port's decoder (the tiled decoder for the tiled ones), and
  the JAX package's decoder (its stored output) decodes the port's
  streams to the same planes and metadata.
- Packet.stats equals the JAX package's exactly on ``send_picture`` (the
  metadata case) and on the tiled ``send_pictures`` route (the GOP route:
  tests/test_torch_rate_control.py).
- The tiled native coder gives the same bytes however its threads run
  (one frame coded 20 times).
- As in the JAX package: ``tile_rows``, and ``tile_columns`` on
  ``send_picture`` or on the per-block route of ``send_pictures``, code
  one tile; a GOP whose width gives more than one tile column codes one
  tile on the stage path, and one that gives a single column codes it on
  the fast path; malformed metadata strings raise ConfigError.
"""
import functools

import numpy as np
import pytest
import torch

import clips
import port_refs
from svt_av1_tpu_torch.api.config import ConfigError
from svt_av1_tpu_torch.api.encoder import Encoder, EncoderConfig
from svt_av1_tpu_torch.codec import obu
from svt_av1_tpu_torch.pipeline import intra_encoder
from test_torch_rate_control import decode_port, drive, stats_array

torch.set_num_threads(2)
MDCV = ("G(0.2649,0.6900)B(0.1500,0.0600)R(0.6800,0.3200)"
        "WP(0.3127,0.3290)L(1000.0,0.0001)")


def _random_frames(n, w, h, seed=5):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (h, w)).astype(np.uint8),
             rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8),
             rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8))
            for _ in range(n)]


# name: (frames, route of tests/test_torch_rate_control.drive,
# EncoderConfig fields); qp 35 unless given
CASES = {
    "metadata": (lambda: clips.natural_clip(2, 64, 64, seed=1), "picture",
                 dict(qp=40, content_light="1000,400",
                      mastering_display=MDCV, stat_report=1)),
    "tiles_128x64": (lambda: _random_frames(3, 128, 64), "pictures",
                     dict(tile_columns=1, stat_report=1)),
    "tiles_352x64": (lambda: _random_frames(3, 352, 64), "pictures",
                     dict(tile_columns=2)),
}


def _config(cls, name, frames, **extra):
    h, w = frames[0][0].shape
    return cls(source_width=w, source_height=h,
               **dict(dict(dict(qp=35), **CASES[name][2]), **extra))


def _jax_stream(name, frames, port_datas):
    """The JAX package's packet bytes, stats, recon, its decoder's frames
    of the port's stream and the metadata it parsed there."""
    from svt_av1_tpu.api.config import EncoderConfig as JConfig
    from svt_av1_tpu.api.encoder import Encoder as JEncoder
    from svt_av1_tpu.codec.decoder import Decoder as JDecoder
    pkts = drive(JEncoder(_config(JConfig, name, frames)), CASES[name][1],
                 frames)
    dec = JDecoder()
    got = [r for d in port_datas for r in dec.decode_temporal_unit(d)]
    meta = [np.array(sorted(map(str, dec.metadata.items())), str)]
    out = [np.array([len(pkts)])]
    out += [np.frombuffer(p.data, np.uint8) for p in pkts]
    out += [stats_array(pkts)]
    out += [np.stack([p.recon[k] for p in pkts]) for k in "yuv"]
    out += [np.stack([np.asarray(r[k]) for r in got]) for k in "yuv"]
    return out + meta


def encode(name, frames, device="cpu"):
    """The port's packets of a case on ``device``."""
    return drive(Encoder(_config(EncoderConfig, name, frames),
                         device=device), CASES[name][1], frames)


def stored(name, frames, datas):
    """The JAX package's stored outputs of a case whose port stream is
    ``datas``, unpacked (see tests/test_torch_rate_control.py)."""
    ref = port_refs.jax_ref(
        f"api_surface_{name}", lambda: _jax_stream(name, frames, datas),
        *[a for f in frames for a in f],
        np.array(sorted(map(str, CASES[name][1:])), str),
        *[np.frombuffer(d, np.uint8) for d in datas])
    n = int(ref[0][0])
    planes = lambda i0: [dict(y=ref[i0][j], u=ref[i0 + 1][j],
                              v=ref[i0 + 2][j])
                         for j in range(len(ref[i0]))]
    return dict(data=[bytes(a) for a in ref[1:1 + n]], stats=ref[1 + n],
                recon=planes(2 + n), decoded=planes(5 + n),
                meta=list(ref[8 + n]))


@functools.lru_cache(maxsize=None)
def _case(name):
    frames = CASES[name][0]()
    pkts = encode(name, frames)
    return frames, pkts, stored(name, frames, [p.data for p in pkts])


@pytest.mark.parametrize("name", sorted(CASES))
def test_stream_matches_jax(name):
    frames, pkts, jax = _case(name)
    shown, dec = decode_port(pkts)
    assert len(shown) == len(frames)
    assert [p.data for p in pkts] == jax["data"]
    for p, r, j in zip(pkts, jax["recon"], jax["decoded"]):
        for k in "yuv":
            assert np.array_equal(p.recon[k], r[k]), (p.pts, k)
            assert np.array_equal(p.recon[k], j[k]), (p.pts, k)
    assert np.array_equal(stats_array(pkts), jax["stats"], equal_nan=True)
    assert sorted(map(str, dec.metadata.items())) == jax["meta"]
    if CASES[name][2].get("stat_report"):
        assert all(p.stats is not None for p in pkts)


def test_metadata_rides_the_first_temporal_unit():
    """Sequence header, then the CLL and MDCV metadata OBUs, then the
    frame; later temporal units carry neither; the port's decoder parses
    the values back."""
    _, pkts, _ = _case("metadata")
    types = [[t for t, _ in obu.parse_obus(p.data)] for p in pkts]
    assert types[0] == [obu.OBU_TEMPORAL_DELIMITER, obu.OBU_SEQUENCE_HEADER,
                        obu.OBU_METADATA, obu.OBU_METADATA, obu.OBU_FRAME]
    assert types[1] == [obu.OBU_TEMPORAL_DELIMITER, obu.OBU_FRAME]
    _, dec = decode_port(pkts)
    assert dec.metadata[obu.METADATA_TYPE_HDR_CLL] == dict(max_cll=1000,
                                                           max_fall=400)
    mdcv = dec.metadata[obu.METADATA_TYPE_HDR_MDCV]
    assert abs(mdcv["white_point"][0] - 0.3127) < 1e-4
    assert abs(mdcv["max_luma"] - 1000.0) < 0.01


@pytest.mark.parametrize("field,value", [
    ("content_light", "1000"), ("content_light", "a,b"),
    ("mastering_display", "G(0.2649,0.6900)B(0.1500,0.0600)")])
def test_bad_metadata_string_raises(field, value):
    y, u, v = clips.natural_clip(1, 32, 32)[0]
    enc = Encoder(EncoderConfig(source_width=32, source_height=32,
                                **{field: value}), device="cpu")
    with pytest.raises(ConfigError, match="bad"):
        enc.send_picture(y, u, v)


def test_tiles_code_tile_columns_and_clamp_availability():
    """The tiled streams signal their tile columns and differ from the
    one-tile stream of the same frames; the wave schedule's availability
    is clamped at each tile's first column."""
    frames, pkts, _ = _case("tiles_352x64")
    _, dec = decode_port(pkts[:1])
    assert dec.last_frame_header.log2_tile_cols == 2
    one = drive(Encoder(_config(EncoderConfig, "tiles_352x64", frames,
                                tile_columns=0), device="cpu"), "pictures",
                frames[:1])
    assert one[0].data != pkts[0].data
    starts = (0, 8, 16)
    _, bys, bxs, valid, trs, bls, hls = intra_encoder._schedule_arrays(
        4, 22, 2, starts)
    at_start = valid & np.isin(bxs, starts)
    before = valid & np.isin(bxs, [s - 1 for s in starts])
    assert at_start.any() and not hls[at_start].any()
    assert not bls[at_start].any() and not trs[before].any()


def test_tiled_coder_is_deterministic():
    """One frame's tiled packetization (a thread per tile) 20 times: the
    same bytes every time."""
    frames = _random_frames(1, 352, 64, seed=8)
    enc = Encoder(EncoderConfig(source_width=352, source_height=64, qp=35,
                                tile_columns=2), device="cpu")
    launched = intra_encoder.encode_intra_frames_launch(
        frames, 140, modes=enc._feat.intra_modes,
        tile_starts=enc._tile_starts, device="cpu")
    (bundle, recon), = intra_encoder.encode_intra_frames_finish(launched)
    datas = set()
    for _ in range(20):
        enc._seq_hdr_sent = True
        datas.add(enc._packetize_arrays(bundle, recon, 140, 0).data)
    assert len(datas) == 1


@pytest.mark.parametrize("fields,route", [
    (dict(tile_rows=1), "pictures"), (dict(tile_columns=1), "picture"),
    (dict(tile_columns=1, cdef_level=1), "pictures")])
def test_settings_that_code_one_tile(fields, route):
    """tile_rows, tile_columns on send_picture and on the per-block route
    of send_pictures (CDEF on) code one tile: the same stream as without
    them."""
    frames = _random_frames(2, 128, 64, seed=6)
    base = {k: v for k, v in fields.items() if k.startswith("cdef")}

    def run(extra):
        return [p.data for p in drive(Encoder(EncoderConfig(
            source_width=128, source_height=64, qp=35, **extra),
            device="cpu"), route, frames)]

    assert run(fields) == run(base)


def test_gop_tile_columns():
    """A GOP whose width gives two tile columns codes on the stage path
    with one tile, as the reference's per-block packetization does (equal
    to the JAX package's stored stream, decoded exactly by the port's
    decoder); at 64 px wide the layout has one column, and the fast path
    codes one tile, as in the JAX package."""
    import test_torch_stage_path as tsp
    gop = dict(intra_period_length=15, hierarchical_levels=2, enable_tf=0,
               enable_tpl_la=0)
    tsp.check_stream("api_gop_tile_columns", dict(tile_columns=1, **gop),
                     clips.natural_clip(3, 128, 64, seed=16))
    frames = clips.natural_clip(3, 64, 64, seed=1)

    def run(cols):
        return [p.data for p in drive(Encoder(EncoderConfig(
            source_width=64, source_height=64, tile_columns=cols, **gop),
            device="cpu"), "gop", frames)]

    assert run(1) == run(0)


def _mixed_decisions(syntax, cc):
    """A 128x64 key frame's leaves: the left superblock as four 32x32
    leaves (V, D45, H, D67), the right one as sixteen 16x16 leaves whose
    modes cycle through the zone-1 / zone-3 ones; DC and near-DC levels
    from a seed, so that every prediction shows in the recon."""
    rng = np.random.default_rng(11)
    out = {}

    def leaf(r4, c4, bsize, n, mode):
        qy = np.zeros((n, n), np.int32)
        qy[:2, :2] = rng.integers(-6, 7, (2, 2))
        qu = np.zeros((n // 2, n // 2), np.int32)
        qu[0, 0] = rng.integers(-4, 5)
        out[(r4, c4)] = syntax.BlockDecision(
            r4=r4, c4=c4, bsize=bsize, y_mode=mode, uv_mode=cc.DC_PRED,
            tx_type=cc.DCT_DCT, qcoeff_y=qy, qcoeff_u=qu,
            qcoeff_v=-qu)

    for i, mode in enumerate((cc.V_PRED, cc.D45_PRED, cc.H_PRED,
                              cc.D67_PRED)):
        leaf((i // 2) * 8, (i % 2) * 8, cc.BLOCK_32X32, 32, mode)
    modes = (cc.D45_PRED, cc.D203_PRED, cc.D67_PRED, cc.DC_PRED)
    for i in range(16):
        leaf((i // 4) * 4, 16 + (i % 4) * 4, cc.BLOCK_16X16, 16,
             modes[(i + i // 4) % 4])
    return out


def test_tiled_mixed_reconstruction_matches_jax():
    """Reconstruction of a frame with 32x32 and 16x16 leaves and two tile
    columns (starts 0 and 64 px): the tile clamps the left, top-right and
    bottom-left availability as the JAX package's does (its output
    stored), and differs from the one-tile reconstruction."""
    from svt_av1_tpu_torch.codec import constants as cc
    from svt_av1_tpu_torch.codec import syntax
    dec = _mixed_decisions(syntax, cc)
    got = intra_encoder.reconstruct_from_decisions(
        dec, 128, 64, 140, device="cpu", tile_starts=(0, 4))
    one = intra_encoder.reconstruct_from_decisions(dec, 128, 64, 140,
                                                   device="cpu")

    def jax_recon():
        from svt_av1_tpu.codec import constants as jcc
        from svt_av1_tpu.codec import syntax as jsyntax
        from svt_av1_tpu.pipeline import intra_encoder as jie
        rec = jie.reconstruct_from_decisions(
            _mixed_decisions(jsyntax, jcc), 128, 64, 140, tile_starts=(0, 4))
        return [np.asarray(rec[k]) for k in "yuv"]

    ref = port_refs.jax_ref(
        "api_surface_tiled_mixed_recon", jax_recon,
        *[d.qcoeff_y for d in dec.values()],
        np.array([(d.r4, d.c4, d.bsize, d.y_mode) for d in dec.values()]))
    for k, r in zip("yuv", ref):
        assert np.array_equal(got[k].numpy(), r), k
    assert not np.array_equal(got["y"].numpy(), one["y"].numpy())
