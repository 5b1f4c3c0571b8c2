"""The port's stage path against the JAX package on the CPU: the inter
frames the reference codes off its fast GOP path (IPPP and low-delay
GOPs, S-frames, 10-bit GOPs, film grain and tile columns in a GOP).

- The global-motion fits (host numpy float64, copied verbatim): the
  reference's cases (tests/test_global_motion.py) and seeded pan, zoom,
  rotation and random fields, equal.
- ``pipeline/me.hierarchical_me`` and ``pipeline/tpl.tpl_frame_stats``
  at 8 and 10 bits, exact (MVs, SSDs, SATD costs, the winning
  reference).
- 10-bit MC: ``mc_blocks`` (three filter kinds, luma and chroma),
  ``mc_blocks_compound`` and ``warp_plane``, exact.
- ``encode_inter_frame`` (every block's decision, MVs, references, warp
  and compound flags, levels; the recon, the gm models, the interp
  filter) on LAST alone, on LAST + ALTREF (the reference's
  test_hier_uses_backward_ref case: ALTREF wins), on a pan that codes
  GLOBALMV, at 10 bits, and without the subpel ring, exact.
- Whole streams through ``Encoder.send_picture`` / ``flush``: IPPP
  128x96 x4 M10 with DLF + CDEF, low delay (pred_structure 1), S-frames
  96x64 x5, a CBR IPPP stream that recodes an inter frame, 10-bit IPPP
  64x64, a 10-bit levels-2 GOP with CDEF + LR + MCTF + TPL, a film-grain
  GOP and a 128x64 GOP asking for two tile columns (one tile coded, as in
  the reference): byte-identical to the JAX package's stream, and the
  port's decoder reproduces every shown frame's recon exactly (10-bit
  inter frames included).
- hp_mv (1/8-pel MVs, off at every preset): the reference reads it on
  its fast path only, so an IPPP stream with the override is the stream
  without it.
- The reference's MCTF clips 10-bit planes at 255 (a fault the port
  keeps, ROADMAP.md queue C item 10).

The JAX outputs are stored in tests/golden/torch_port_refs.npz, each with
the fingerprint of its inputs (tests/port_refs.py); remake them with
``JAX_PLATFORMS=cpu python tools/make_torch_port_refs.py
tests/test_torch_stage_path.py``.  Nothing here encodes with JAX live.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import clips
import port_refs
from svt_av1_tpu_torch.api import encoder as enc_mod
from svt_av1_tpu_torch.api.encoder import Encoder, EncoderConfig
from svt_av1_tpu_torch.codec import mv_pred, obu
from svt_av1_tpu_torch.codec.decoder import Decoder
from svt_av1_tpu_torch.ops import mc
from svt_av1_tpu_torch.ops import warp as twarp
from svt_av1_tpu_torch.pipeline import inter_encoder as tie
from svt_av1_tpu_torch.pipeline import me as tme
from svt_av1_tpu_torch.pipeline import tpl as ttpl
from svt_av1_tpu_torch.pipeline.presets import features_for

torch.set_num_threads(2)
T = lambda a: torch.from_numpy(np.ascontiguousarray(a))
FILTERS = dict(enable_dlf_flag=1, cdef_level=1)


def _model_array(m):
    """A gm model (None, a 2-tuple or a 6-tuple) as an int64 array."""
    return np.zeros(0, np.int64) if m is None else np.array(m, np.int64)


# ----------------------------------------------------- global motion ---

def _gm_fields():
    """name -> (mv_y, mv_x): the reference's translation cases, then
    seeded fields on a 6x8 block grid."""
    out = {}
    mv_y = np.full((8, 8), 3.0)
    mv_x = np.full((8, 8), -5.0)
    mv_y[0, 0] = 20
    out["ref_outlier"] = (mv_y, mv_x)
    out["ref_static"] = (np.zeros((8, 8)), np.zeros((8, 8)))
    rng = np.random.default_rng(0)
    out["ref_no_consensus"] = (rng.integers(-20, 20, (8, 8)).astype(float),
                               rng.integers(-20, 20, (8, 8)).astype(float))
    rng = np.random.default_rng(21)
    gh, gw = 6, 8
    yy, xx = np.mgrid[0:gh, 0:gw] * 16 + 8
    cy, cx = gh * 8, gw * 8
    out["pan"] = (-2 + rng.integers(-1, 2, (gh, gw)),
                  6 + rng.integers(-1, 2, (gh, gw)))
    out["zoom"] = (np.round((yy - cy) * 0.06).astype(np.int32),
                   np.round((xx - cx) * 0.06).astype(np.int32))
    out["rotate"] = (np.round((xx - cx) * 0.05).astype(np.int32),
                     np.round(-(yy - cy) * 0.05).astype(np.int32))
    out["random"] = (rng.integers(-30, 30, (gh, gw)),
                     rng.integers(-30, 30, (gh, gw)))
    return out


GM_FIELDS = _gm_fields()
GM_FITS = {"translation": tie.estimate_global_translation,
           "rotzoom": tie.estimate_global_rotzoom}


def _jax_gm(fit, field):
    from svt_av1_tpu.pipeline import inter_encoder as jie
    f = dict(translation=jie.estimate_global_translation,
             rotzoom=jie.estimate_global_rotzoom)[fit]
    return (_model_array(f(*field)),)


@pytest.mark.parametrize("fit", sorted(GM_FITS))
@pytest.mark.parametrize("name", sorted(GM_FIELDS))
def test_gm_fit_matches_jax(fit, name):
    field = GM_FIELDS[name]
    (ref,) = port_refs.jax_ref(f"stage_gm_{fit}_{name}",
                               lambda: _jax_gm(fit, field), *field)
    got = GM_FITS[fit](*field)
    assert np.array_equal(_model_array(got), ref), (got, ref)
    if name in ("zoom", "rotate") and fit == "rotzoom":
        assert got is not None and len(got) == 6
    if name.startswith("ref_") and fit == "translation":
        # the reference's own expectations (tests/test_global_motion.py)
        assert got == {"ref_outlier": (24, -40), "ref_static": None,
                       "ref_no_consensus": None}[name]


# --------------------------------------------------------- HME and TPL ---

def _pair(bd, seed):
    frames = (clips.natural_clip(3, 96, 64, seed=seed) if bd == 8
              else clips.natural_clip10(3, 96, 64, seed=seed))
    return [f[0] for f in frames]


def _jax_hme(src, ref):
    from svt_av1_tpu.pipeline import me as jme
    return jme.hierarchical_me(src, ref)


@pytest.mark.parametrize("bd", [8, 10])
def test_hierarchical_me_matches_jax(bd):
    """MVs and SSDs per 16x16 block, exact (the level searches' float32
    SSD cross term passes 2^24 at 10 bits; their argmins agree here)."""
    y0, y1, _ = _pair(bd, 3 + bd)
    ref = port_refs.jax_ref(f"stage_hme_{bd}", lambda: _jax_hme(y1, y0),
                            y1, y0)
    got = tme.hierarchical_me(y1, y0, device="cpu")
    for name, a, b in zip(("mv_y", "mv_x", "ssd"), got, ref):
        assert np.array_equal(a, b), name
    assert np.abs(got[0]).max() + np.abs(got[1]).max() > 0


def _stats_arrays(st):
    return (st["intra"], st["inter"], st["mv"], st["ref_sel"])


def _jax_tpl(src, refs):
    from svt_av1_tpu.pipeline import tpl as jtpl
    return (_stats_arrays(jtpl.tpl_frame_stats(src, refs))
            + _stats_arrays(jtpl.tpl_frame_stats(src, None)))


@pytest.mark.parametrize("bd", [8, 10])
def test_tpl_frame_stats_matches_jax(bd):
    """The stage path's per-frame TPL dispenser against two references and
    as an intra-only anchor: SATD costs, MVs and the winning reference,
    exact."""
    y0, y1, y2 = _pair(bd, 11 + bd)
    ref = port_refs.jax_ref(f"stage_tpl_{bd}", lambda: _jax_tpl(y1, [y0, y2]),
                            y1, y0, y2)
    got = (_stats_arrays(ttpl.tpl_frame_stats(y1, [y0, y2], device="cpu"))
           + _stats_arrays(ttpl.tpl_frame_stats(y1, None, device="cpu")))
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a.shape == b.shape and np.array_equal(a, b), i
    assert 0 < got[3].sum() < got[3].size    # both references win blocks


# ------------------------------------------------------------ 10-bit MC ---

def _mc_inputs(seed=31):
    rng = np.random.default_rng(seed)
    h, w = 64, 96
    planes = [rng.integers(0, 1024, s).astype(np.int32)
              for s in ((h, w), (h // 2, w // 2)) * 2]
    nb = 24
    ys = (rng.integers(0, h // 16, nb) * 16).astype(np.int32)
    xs = (rng.integers(0, w // 16, nb) * 16).astype(np.int32)
    mv0 = mc.clamp_mvs_for_pad(rng.integers(-120, 121, (nb, 2)), ys, xs, 16,
                               h, w)
    mv1 = mc.clamp_mvs_for_pad(rng.integers(-120, 121, (nb, 2)), ys, xs, 16,
                               h, w)
    return planes, ys, xs, mv0, mv1


WARP_MAT = (3 << 14, -(5 << 12), 65536 + 1200, 700, -700, 65536 + 1200)


def _jax_mc10(what):
    import jax.numpy as jnp
    from svt_av1_tpu.ops import mc as jmc
    from svt_av1_tpu.ops import warp as jwarp
    (y0, c0, y1, c1), ys, xs, mv0, mv1 = _mc_inputs()
    out = []
    for plane0, plane1, blk, ss in ((y0, y1, 16, 0), (c0, c1, 8, 1)):
        p0 = jnp.asarray(jmc.pad_plane(plane0, mc.PAD >> ss))
        p1 = jnp.asarray(jmc.pad_plane(plane1, mc.PAD >> ss))
        cys, cxs = ys >> ss, xs >> ss
        if what == "single":
            out += [np.asarray(jmc.mc_blocks(p0, cys, cxs, mv0, blk, mc.PAD,
                                             ss, 10, kind=k))
                    for k in (0, 1, 2)]
        elif what == "compound":
            out += [np.asarray(jmc.mc_blocks_compound(
                p0, p1, cys, cxs, mv0, mv1, blk, mc.PAD, ss, 10, kind=k))
                for k in (0, 2)]
        else:
            h, w = plane0.shape
            out.append(np.asarray(jwarp.warp_plane(plane0, WARP_MAT, w, h,
                                                   bd=10, subsampling=ss)))
    return out


def _port_mc10(what):
    (y0, c0, y1, c1), ys, xs, mv0, mv1 = _mc_inputs()
    out = []
    for plane0, plane1, blk, ss in ((y0, y1, 16, 0), (c0, c1, 8, 1)):
        p0 = mc.pad_plane(T(plane0), mc.PAD >> ss)
        p1 = mc.pad_plane(T(plane1), mc.PAD >> ss)
        cys, cxs = T(ys >> ss), T(xs >> ss)
        if what == "single":
            out += [mc.mc_blocks(p0, cys, cxs, T(mv0), blk, mc.PAD, ss, 10,
                                 kind=k).numpy() for k in (0, 1, 2)]
        elif what == "compound":
            out += [mc.mc_blocks_compound(p0, p1, cys, cxs, T(mv0), T(mv1),
                                          blk, mc.PAD, ss, 10,
                                          kind=k).numpy() for k in (0, 2)]
        else:
            h, w = plane0.shape
            out.append(twarp.warp_plane(T(plane0), WARP_MAT, w, h, bd=10,
                                        subsampling=ss).numpy())
    return out


@pytest.mark.parametrize("what", ["single", "compound", "warp"])
def test_mc_10bit_matches_jax(what):
    """Inter prediction at 10 bits: the clip at 1023, the compound
    rounding and the warp filter, exact against the JAX ops."""
    planes, ys, xs, mv0, mv1 = _mc_inputs()
    ref = port_refs.jax_ref(f"stage_mc10_{what}", lambda: _jax_mc10(what),
                            *planes, ys, xs, mv0, mv1)
    got = _port_mc10(what)
    assert len(got) == len(ref)
    for i, (a, b) in enumerate(zip(got, ref)):
        assert np.array_equal(a, b), i
    assert max(int(a.max()) for a in got) > 255


# --------------------------------------------------- encode_inter_frame ---

def _backward_ref_case():
    """tests/test_gop_hierarchical.py::test_hier_uses_backward_ref: the
    future reference matches the source, the past one is noise."""
    rng = np.random.default_rng(0)
    src = rng.integers(0, 255, (64, 64)).astype(np.uint8)
    su = rng.integers(0, 255, (32, 32)).astype(np.uint8)
    noise = rng.integers(0, 255, (64, 64)).astype(np.uint8)
    return ((src, su, su), {mv_pred.LAST_FRAME: dict(y=noise, u=su, v=su),
                            mv_pred.ALTREF_FRAME: dict(y=src, u=su, v=su)},
            120, {})


def _pan_case():
    """tests/test_global_motion.py's pan: 4 px a frame to the left."""
    rng = np.random.default_rng(9)
    base = rng.integers(0, 255, (64, 128)).astype(np.uint8)
    u = np.full((32, 64), 110, np.uint8)
    v = np.full((32, 64), 120, np.uint8)
    return ((np.roll(base, -4, axis=1), u, v), dict(y=base, u=u, v=v), 120,
            {})


def _clip_case(bd, two, **kw):
    fr = (clips.natural_clip(3, 64, 64, seed=3) if bd == 8
          else clips.natural_clip10(3, 64, 64, seed=3))
    ref = dict(zip("yuv", fr[0]))
    if two:
        ref = {mv_pred.LAST_FRAME: ref,
               mv_pred.ALTREF_FRAME: dict(zip("yuv", fr[2]))}
    return fr[1], ref, 140, dict(bd=bd, **kw)


EIF_CASES = {
    "last": lambda: _clip_case(8, False),
    "last_altref": _backward_ref_case,
    "pan_globalmv": _pan_case,
    "ten_bit": lambda: _clip_case(10, True),
    "no_ring": lambda: _clip_case(8, False, subpel_ring=False,
                                  modes=(0, 1, 2, 9)),
}


def _decision_arrays(decisions, recon, gm, interp):
    """Every block's fields in raster order, the recon, the gm models of
    the seven references and the interp filter, as arrays."""
    keys = sorted(decisions)
    ds = [decisions[k] for k in keys]
    ints = np.array([[d.is_inter, d.y_mode, d.uv_mode, d.ref, d.ref2,
                      d.use_warp, *d.mv, *d.mv2] for d in ds], np.int64)
    out = [ints] + [np.stack([np.asarray(getattr(d, f"qcoeff_{p}"),
                                         np.int32) for d in ds])
                    for p in "yuv"]
    out += [np.asarray(recon[p]) for p in "yuv"]
    out += [_model_array(gm.get(e)) for e in range(1, 8)]
    return out + [np.array([interp])]


def _flat_refs(ref):
    refs = {mv_pred.LAST_FRAME: ref} if "y" in ref else ref
    return [np.asarray(r[p]) for e in sorted(refs) for r in [refs[e]]
            for p in "yuv"]


def _jax_eif(src, ref, qindex, kw):
    from svt_av1_tpu.pipeline import inter_encoder as jie
    return _decision_arrays(*jie.encode_inter_frame(*src, ref, qindex, **kw))


@functools.lru_cache(maxsize=None)
def _eif(name):
    src, ref, qindex, kw = EIF_CASES[name]()
    d, rec, gm, interp = tie.encode_inter_frame(*src, ref, qindex,
                                                device="cpu", **kw)
    got = _decision_arrays(d, {p: r.numpy() for p, r in rec.items()}, gm,
                           interp)
    stored = port_refs.jax_ref(
        f"stage_eif_{name}", lambda: _jax_eif(src, ref, qindex, kw),
        *src, *_flat_refs(ref), np.array([qindex]),
        np.array(sorted((k, str(v)) for k, v in kw.items()), str))
    return d, rec, got, stored


@pytest.mark.parametrize("name", sorted(EIF_CASES))
def test_encode_inter_frame_matches_jax(name):
    d, rec, got, ref = _eif(name)
    names = (["blocks"] + [f"q{p}" for p in "yuv"] + [f"recon {p}"
                                                       for p in "yuv"]
             + [f"gm {e}" for e in range(1, 8)] + ["interp"])
    for n, a, b in zip(names, got, ref):
        assert a.shape == b.shape and np.array_equal(a, b), n
    inter = [x for x in d.values() if x.is_inter]
    print(f"{name}: {len(inter)} of {len(d)} blocks inter, "
          f"{sum(bool(x.ref2) for x in inter)} compound, "
          f"{sum(x.use_warp for x in inter)} warped, refs "
          f"{sorted({x.ref for x in inter})}")
    assert inter
    if name == "last_altref":
        assert mv_pred.ALTREF_FRAME in {x.ref for x in inter}
    if name == "pan_globalmv":
        gm = got[7]      # LAST's model: a translation, the MV of blocks
        assert len(gm) == 2
        assert sum(x.mv == tuple(gm) for x in inter) > len(d) // 2
    if name == "ten_bit":
        assert rec["y"].dtype == torch.int16 and int(rec["y"].max()) > 255
        assert any(x.ref2 for x in inter)
    if name == "no_ring":
        assert all(x.mv[0] % 8 == 0 and x.mv[1] % 8 == 0 for x in inter
                   if not x.use_warp)


# ----------------------------------------------------------- streams ---

def _shuffled_clip():
    """Eight smooth 64x64 frames, then the last one with its samples
    shuffled inside each region of the scene-cut detector (the same
    per-region histograms: no scene cut, so the frame codes as an inter
    frame, far over its CBR budget once the controller has lowered the
    qindex over the smooth frames)."""
    frames = clips.natural_clip(8, 64, 64, seed=9)
    rng = np.random.default_rng(5)
    y = frames[-1][0].copy()
    for r in range(4):
        for c in range(4):
            blk = y[r * 16:(r + 1) * 16, c * 16:(c + 1) * 16]
            y[r * 16:(r + 1) * 16, c * 16:(c + 1) * 16] = rng.permutation(
                blk.reshape(-1)).reshape(16, 16)
    return frames + [(y, frames[-1][1], frames[-1][2])]


TEN = dict(encoder_bit_depth=10)
# name: (frames, EncoderConfig fields; qp 35 unless given)
STREAMS = {
    "ippp": (lambda: clips.natural_clip(4, 128, 96, seed=2),
             dict(intra_period_length=15, **FILTERS)),
    "low_delay": (lambda: clips.natural_clip(4, 64, 64, seed=3),
                  dict(intra_period_length=15, hierarchical_levels=3,
                       pred_structure=1)),
    "sframes": (lambda: clips.natural_clip(5, 96, 64, seed=4),
                dict(intra_period_length=-1, sframe_dist=2)),
    "cbr_recode": (_shuffled_clip,
                   dict(intra_period_length=15, rate_control_mode=2,
                        target_bit_rate=60_000)),
    "ten_bit_ippp": (lambda: clips.natural_clip10(3, 64, 64, seed=5),
                     dict(intra_period_length=15, **TEN)),
    "ten_bit_gop": (lambda: clips.natural_clip10(5, 64, 64, seed=6),
                    dict(intra_period_length=15, hierarchical_levels=2,
                         cdef_level=1, enable_restoration_filtering=1,
                         enable_tf=1, enable_tpl_la=1, **TEN)),
    "film_grain_gop": (lambda: clips.natural_clip(3, 64, 64, seed=7),
                       dict(intra_period_length=15, hierarchical_levels=1,
                            film_grain_denoise_strength=8)),
    "tile_columns_gop": (lambda: clips.natural_clip(5, 128, 64, seed=8),
                         dict(intra_period_length=15, hierarchical_levels=2,
                              tile_columns=1, enable_tf=0)),
}


def config(cls, fields, frames):
    h, w = frames[0][0].shape
    return cls(source_width=w, source_height=h,
               **dict(dict(qp=35), **fields))


def drive(enc, frames):
    for f in frames:
        enc.send_picture(*f)
    enc.flush()
    return list(iter(enc.get_packet, None))


def jax_stream(fields, frames):
    """The JAX package's stream of a configuration: packet count, the
    packets' bytes and displayed flags, the shown recon planes."""
    from svt_av1_tpu.api.config import EncoderConfig as JConfig
    from svt_av1_tpu.api.encoder import Encoder as JEncoder
    pkts = drive(JEncoder(config(JConfig, fields, frames)), frames)
    shown = [p for p in pkts if p.displayed]
    return ([np.array([len(pkts)]),
             np.array([p.displayed for p in pkts])]
            + [np.frombuffer(p.data, np.uint8) for p in pkts]
            + [np.stack([p.recon[k] for p in shown]) for k in "yuv"])


def stored_stream(key, fields, frames):
    """The JAX package's stored stream of a configuration: dict(data,
    displayed, recon)."""
    ref = port_refs.jax_ref(key, lambda: jax_stream(fields, frames),
                            *[a for f in frames for a in f],
                            np.array(sorted((k, str(v))
                                            for k, v in fields.items()), str))
    n = int(ref[0][0])
    return dict(data=[bytes(a) for a in ref[2:2 + n]],
                displayed=[bool(x) for x in ref[1]],
                recon=[dict(y=ref[2 + n][j], u=ref[3 + n][j],
                            v=ref[4 + n][j]) for j in range(len(ref[2 + n]))])


def port_stream(fields, frames, device="cpu"):
    """The port's packets of a configuration, and the qindex of every
    _encode_frame call that recoded (the recode loop's second attempts)."""
    recodes = []
    orig = Encoder._encode_frame

    def spy(self, *a, **kw):
        if kw.get("recode"):
            recodes.append(kw.get("qindex_override"))
        return orig(self, *a, **kw)

    Encoder._encode_frame = spy
    try:
        pkts = drive(Encoder(config(EncoderConfig, fields, frames),
                             device=device), frames)
    finally:
        Encoder._encode_frame = orig
    return pkts, recodes


@functools.lru_cache(maxsize=None)
def run_stream(name):
    """(frames, the port's packets, its recodes, the JAX stream)."""
    make, fields = STREAMS[name]
    frames = make()
    pkts, recodes = port_stream(fields, frames)
    return frames, pkts, recodes, stored_stream(f"stage_stream_{name}",
                                                fields, frames)


def decode_check(pkts, label):
    """The port's decoder over a stream: every shown frame equals its
    Packet.recon (uint8, or uint16 at 10 bits).  Returns the frame
    headers of the coded frames."""
    dec = Decoder(device="cpu")
    headers = []
    shown = [p for p in pkts if p.displayed]
    got = []
    for p in pkts:
        got += dec.decode_temporal_unit(p.data)
        if obu.OBU_FRAME in [t for t, _ in obu.parse_obus(p.data)]:
            headers.append(dec.last_frame_header)
    assert len(got) == len(shown)
    for r, p in zip(got, shown):
        for k in "yuv":
            assert r[k].dtype == p.recon[k].dtype
            np.testing.assert_array_equal(r[k], p.recon[k],
                                          err_msg=f"{label} poc {p.pts} {k}")
    return headers


def check_stream(key, fields, frames):
    """A configuration's stream through the port on the CPU: equal to the
    JAX package's stored stream (key ``key``) byte for byte, and decoded
    by the port's decoder to every shown frame's recon.  Returns the
    packets (for the tests of the settings that the port refused before
    the stage path)."""
    pkts, _ = port_stream(fields, frames)
    jax = stored_stream(key, fields, frames)
    assert [p.data for p in pkts] == jax["data"], key
    decode_check(pkts, key)
    assert sum(p.displayed for p in pkts) == len(frames)
    return pkts


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_stream_matches_jax(name):
    """Byte-identical to the JAX package's stream, the same displayed
    flags and shown recon."""
    _, pkts, recodes, jax = run_stream(name)
    assert [p.data for p in pkts] == jax["data"]
    assert [p.displayed for p in pkts] == jax["displayed"]
    for p, r in zip([p for p in pkts if p.displayed], jax["recon"]):
        for k in "yuv":
            assert np.array_equal(p.recon[k], r[k]), (p.pts, k)
    print(f"{name}: {len(pkts)} packets, {sum(map(len, jax['data']))} "
          f"bytes, recodes at qindex {recodes}")


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_stream_decodes_to_recon(name):
    """The port's decoder reproduces every shown frame, and each stream
    codes what its configuration asks for."""
    frames, pkts, recodes, _ = run_stream(name)
    headers = decode_check(pkts, name)
    types = [h.frame_type for h in headers]
    assert types[0] == obu.KEY_FRAME and obu.KEY_FRAME not in types[1:]
    if name == "sframes":
        assert types.count(obu.S_FRAME) == 2
        for h in headers:
            if h.frame_type == obu.S_FRAME:
                assert h.error_resilient_mode and h.refresh_frame_flags == 0xFF
                assert h.primary_ref_frame == obu.PRIMARY_REF_NONE
    if name == "cbr_recode":
        assert len(recodes) == 1, recodes
    if name in ("ippp", "cbr_recode", "ten_bit_ippp"):
        # IPPP chains through slot 0
        assert all(h.refresh_frame_flags == 0x01 and h.primary_ref_frame == 0
                   for h in headers[1:])
    if name.startswith("ten_bit"):
        assert pkts[0].recon["y"].dtype == np.uint16
    if name == "film_grain_gop":
        assert all(h.film_grain is not None for h in headers
                   if h.show_frame)
    if name == "tile_columns_gop":
        assert all(h.log2_tile_cols == 0 for h in headers)
    assert sum(p.displayed for p in pkts) == len(frames)


def test_mctf_clips_10bit_planes_as_the_reference():
    """A reference fault the port keeps byte for byte (ROADMAP.md queue C
    item 10): the reference's MCTF predicts at 8 bits and clips its
    output at 255 whatever the samples' depth, so a 10-bit key frame or
    mini-GoP base that MCTF filters codes a picture clipped at 255 (the
    ten_bit_gop stream above codes its base so, byte-identical to the
    JAX package's)."""
    from svt_av1_tpu_torch.pipeline import tf_stage
    frames = clips.natural_clip10(3, 64, 64, seed=17)
    out = tf_stage.mctf_filter_frame(frames[1], [frames[0], frames[2]],
                                     device="cpu")
    assert all(p.dtype == np.uint16 for p in out)
    assert max(int(p.max()) for p in out) <= 255 < int(frames[1][0].max())


def test_hp_mv_override_codes_ippp(monkeypatch):
    """The reference reads hp_mv on its fast path only: with the override
    an IPPP encoder is made and codes the stream it codes without it (a
    hierarchical GOP on the fast path codes 1/8-pel MVs:
    tests/test_torch_feature_overrides.py)."""
    frames = clips.natural_clip(2, 64, 64, seed=12)
    fields = dict(intra_period_length=15)
    plain, _ = port_stream(fields, frames)
    monkeypatch.setattr(enc_mod, "features_for", lambda m: dataclasses.replace(
        features_for(m), hp_mv=True))
    enc = Encoder(config(EncoderConfig, fields, frames), device="cpu")
    assert enc._feat.hp_mv and not enc._fast
    assert [p.data for p in drive(enc, frames)] == [p.data for p in plain]
