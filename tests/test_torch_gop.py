"""The port's hierarchical-GOP slice (presets M10-M13) against the JAX
package on the CPU.

- P1 and P2 of one inter frame (R = 1 and R = 2 references) against the
  JAX programs' outputs, stored in tests/golden/torch_port_refs.npz (a live
  P1 compile costs the JAX package tens of seconds; see tests/port_refs.py
  and tools/make_torch_port_refs.py): decisions by the parity rule, the GM
  model and the interp pick by their tie rules, P2 exact on the same
  inputs.
- The whole slice through Encoder.send_picture / flush: a 5-frame GOP at
  64x64 (hierarchical_levels 2, keyint 4) at M10 and M12, the wedge
  (wipe) and diffwtd (iris) clips of tests/test_wedge.py at M10, and a
  96x128 zoom + rotate clip at M10 (warped blocks), with MCTF and TPL
  off, and a 7-frame 128x96 GOP at M12 with the lookahead on (MCTF +
  TPL, a delta-q key frame; tests/test_torch_lookahead.py holds it at
  M10), against the stored JAX streams and recon by the parity rule
  (>= 99% of blocks equal, Y-PSNR within 0.05 dB, bytes within 1%; byte
  identity printed); every stream round-trips through the port's decoder,
  and the JAX package's decoder decodes the port's M10 stream to the
  port's recon (its output stored, fingerprinted by the port's packets).
- send_pictures(frames, eos=True) shows every frame (the last partial
  mini-GoP included), in the JAX package's send_picture + flush stream;
  recon_enabled=False leaves the packets as they were and skips the recon
  copies of shown inter and show-existing frames.
- The GOP settings the reference codes on its stage path (S-frames, low
  delay, IPPP, 10 bits, tile columns, film grain) encode there, equal to
  the JAX streams (tests/test_torch_stage_path.py has more); P1 with
  1/8-pel MVs (the hp_mv override) against the JAX P1.  (Presets M5-M9:
  tests/test_torch_gop_m6.py; the overrides:
  tests/test_torch_feature_overrides.py.)
"""
import functools

import numpy as np
import pytest
import torch

import clips
import port_refs
from svt_av1_tpu_torch.api.encoder import Encoder, EncoderConfig
from svt_av1_tpu_torch.codec import obu
from svt_av1_tpu_torch.codec.decoder import Decoder
from svt_av1_tpu_torch.codec.rate_est import md_rate_args
from svt_av1_tpu_torch.ops import quant
from svt_av1_tpu_torch.pipeline import cdef_stage
from svt_av1_tpu_torch.pipeline import gop_fast as tgf
from svt_av1_tpu_torch.pipeline.intra_encoder import UV_MODES
from svt_av1_tpu_torch.pipeline.presets import features_for

torch.set_num_threads(2)
CPU = torch.device("cpu")
QINDEX = 140
P1_OUT = ("ry", "ru", "rv", "ymode", "umode", "choose", "skip", "mv", "mv2",
          "ref_idx", "comp", "warp", "wedge", "obmc", "ii", "qy", "qu", "qv",
          "gm_mats", "gm_trans", "gm_kinds", "interp", "merge32", "merge64",
          "itx", "split", "smv", "ssk", "mergeh", "mergev")
BLOCK_FIELDS = ("ymode", "umode", "choose", "skip", "mv", "mv2", "ref_idx",
                "comp", "warp", "wedge", "qy", "qu", "qv")


def _p1_inputs(R):
    """64x96 frames of the natural clip: frame 2 is coded from frame 1
    (R = 1), or from frames 1 and 3 as LAST and ALTREF (R = 2)."""
    fr = clips.natural_clip(4, 96, 64, seed=7)
    y, u, v = fr[2]
    src_pack = np.concatenate([y, np.concatenate([u, v], 1)], 0)
    refs = [fr[1]] if R == 1 else [fr[1], fr[3]]
    return src_pack, tuple(np.stack([r[i] for r in refs]).astype(np.int32)
                           for i in range(3))


def _jax_p1(src_pack, refs, R, feat):
    from svt_av1_tpu.codec.rate_est import md_rate_args as jrate
    from svt_av1_tpu.ops import quant as jq
    from svt_av1_tpu.pipeline import gop_fast as jgf
    modes = tuple(feat.intra_modes)
    rt = jrate(QINDEX, modes, UV_MODES, None, inter_frame=True,
               exact=feat.exact_rates)
    p1 = jgf._jit_p1(64, 96, R, modes, 8, feat.subpel_ring, R >= 2,
                     feat.hme_rad2, feat.hme_rad0, False, False, False, True,
                     False, False)
    return p1(src_pack, *refs, *jq.make_quant_params(QINDEX),
              tgf.frame_lambda(QINDEX), *rt[:7])


def _port_p1(src_pack, refs, R, feat):
    modes = tuple(feat.intra_modes)
    rt = md_rate_args(QINDEX, modes, UV_MODES, inter_frame=True,
                      exact=feat.exact_rates, device=CPU)
    p1 = tgf.build_p1(64, 96, R, modes, 8, feat.subpel_ring, R >= 2,
                      feat.hme_rad2, feat.hme_rad0, skip_mode=True)
    src = tgf._src_planes(src_pack, 64, 96, CPU)
    outs = p1(*src, *(torch.as_tensor(r) for r in refs),
              quant.params_on(QINDEX, CPU),
              torch.tensor(tgf.frame_lambda(QINDEX)), rt)
    return [o.numpy() for o in outs]


@functools.lru_cache(maxsize=None)
def _p1_pair(R):
    feat = features_for(10)
    src_pack, refs = _p1_inputs(R)
    ref = port_refs.jax_ref(f"gop_p1_r{R}",
                            lambda: _jax_p1(src_pack, refs, R, feat),
                            src_pack, *refs)
    return src_pack, refs, _port_p1(src_pack, refs, R, feat), ref


def _agreement(got, ref):
    """Share of 16x16 blocks whose decisions (modes, references, MVs,
    compound code, levels) are equal."""
    o = dict(zip(P1_OUT, got))
    r = dict(zip(P1_OUT, ref))
    nb = o["choose"].shape[0]
    same = np.ones(nb, bool)
    for k in BLOCK_FIELDS:
        a = o[k].reshape(nb, -1).astype(np.int64)
        b = r[k].reshape(nb, -1).astype(np.int64)
        same &= (a == b).all(axis=1)
    return same.mean()


@pytest.mark.parametrize("R", [1, 2])
def test_p1_matches_jax(R):
    src_pack, refs, got, ref = _p1_pair(R)
    assert len(got) == len(ref) == 30
    agree = _agreement(got, ref)
    o, r = dict(zip(P1_OUT, got)), dict(zip(P1_OUT, ref))
    # tie rules: the GM model (float32 least squares) and the interp pick
    # (the reference's float32 frame SSE)
    gm_same = all(np.array_equal(o[k], r[k])
                  for k in ("gm_mats", "gm_trans", "gm_kinds"))
    interp_same = int(o["interp"]) == int(r["interp"])
    print(f"P1 R={R}: {agree:.2%} of {o['choose'].size} blocks equal; "
          f"inter {int(o['choose'].sum())}, compound {int(o['comp'].sum())}, "
          f"gm kinds {o['gm_kinds'].tolist()} (equal: {gm_same}), interp "
          f"{int(o['interp'])} (equal: {interp_same}), merge32 "
          f"{int(o['merge32'].sum())}")
    assert agree >= 0.99
    assert gm_same and interp_same, "a GM / interp tie: check its rule"
    if agree == 1.0:
        for k in ("ry", "ru", "rv", "merge32", "merge64", "mergeh",
                  "mergev"):
            np.testing.assert_array_equal(o[k], r[k], err_msg=k)
    assert o["choose"].any()
    if R == 2:
        assert o["comp"].any()


@pytest.mark.parametrize("R", [1, 2])
def test_p2_matches_jax(R):
    """P2 (masked DLF search + apply, CDEF search + frame-uniform pick +
    apply) on the JAX P1's outputs, exact."""
    src_pack, _, _, ref = _p1_pair(R)
    r = dict(zip(P1_OUT, ref))
    skip16 = ((np.abs(r["qy"]).max(1) == 0) & (np.abs(r["qu"]).max(1) == 0)
              & (np.abs(r["qv"]).max(1) == 0)).reshape(4, 6)
    cands = np.asarray(cdef_stage.SEARCH_SET[:4], np.int32)
    args = (src_pack, r["ry"], r["ru"], r["rv"], skip16,
            tgf.dlf_ladder_params(QINDEX, False),
            tgf.dlf_ladder_params(QINDEX, True), cands,
            np.int32(cdef_stage.cdef_damping(QINDEX)), r["merge32"],
            r["choose"].reshape(4, 6), r["merge64"])

    def jax_p2():
        from svt_av1_tpu.pipeline import gop_fast as jgf
        p2 = jgf._jit_p2(64, 96, 8, len(cands), True, True, masked=True)
        return p2(*args, mergeh=r["mergeh"], mergev=r["mergev"])

    want = port_refs.jax_ref(f"gop_p2_r{R}", jax_p2, *args, r["mergeh"],
                             r["mergev"])
    t = lambda a: torch.as_tensor(np.asarray(a))
    got = tgf.p2(*tgf._src_planes(src_pack, 64, 96, CPU), t(r["ry"]),
                 t(r["ru"]), t(r["rv"]), t(skip16),
                 args[5], args[6], cands, int(args[8]),
                 merge32=t(r["merge32"]), inter16=t(args[10]),
                 merge64=t(r["merge64"]), mergeh=t(r["mergeh"]),
                 mergev=t(r["mergev"]))
    for i in range(3):
        np.testing.assert_array_equal(got[i].numpy(), want[i])
    np.testing.assert_array_equal(got[3].numpy(), want[3])
    # per-SB SSEs: exact integers here, float32 sums there (all < 2^24)
    assert want[4].max() < 2 ** 24
    np.testing.assert_array_equal(got[4].numpy().astype(np.float64),
                                  want[4].astype(np.float64))
    assert int(got[5]) == int(want[5])
    print(f"P2 R={R}: DLF levels {got[3].tolist()}, CDEF candidate "
          f"{int(got[5])}, pixels changed by the filters "
          f"{int((got[0].numpy() != r['ry']).sum())}")


# ------------------------------------------------------------- the slice ---

CLIPS = {
    # name: (frames, config fields, preset)
    "m10": (lambda: clips.natural_clip(5, 64, 64, seed=1),
            dict(qp=35, intra_period_length=4), 10),
    "m12": (lambda: clips.natural_clip(5, 64, 64, seed=1),
            dict(qp=35, intra_period_length=4), 12),
    "m12_lookahead": (lambda: clips.split_motion_clip(7),
                      dict(qp=35, intra_period_length=4, enable_tf=1,
                           enable_tpl_la=1), 12),
    **{name: (clip, fields, 10)
       for name, (clip, fields, _) in clips.TOOL_CLIPS.items()},
}


def _config(pkg_cfg, spec, frames):
    """The EncoderConfig (of either package) of a clip spec (frames,
    config fields, preset): hierarchical_levels 2, DLF and CDEF on, the
    lookahead off unless the fields say otherwise."""
    _, fields, preset = spec
    h, w = frames[0][0].shape
    return pkg_cfg(source_width=w, source_height=h, enc_mode=preset,
                   **dict(dict(hierarchical_levels=2, enable_dlf_flag=1,
                               cdef_level=1, enable_tf=0, enable_tpl_la=0),
                          **fields))


def _run(enc, name, frames, gop_fast):
    with clips.tool_setting(name, enc, gop_fast):
        for f in frames:
            enc.send_picture(*f)
        enc.flush()
    pkts = []
    while (p := enc.get_packet()) is not None:
        pkts.append(p)
    return pkts


def _jax_stream(name, spec, frames, decode=False):
    """The JAX package's stream of a clip as arrays: the packet count, the
    displayed flags, each packet's bytes, the shown recon planes, and with
    ``decode`` the JAX decoder's shown frames of that stream."""
    from svt_av1_tpu.api.config import EncoderConfig as JConfig
    from svt_av1_tpu.api.encoder import Encoder as JEncoder
    from svt_av1_tpu.pipeline import gop_fast as jgf
    pkts = _run(JEncoder(_config(JConfig, spec, frames)), name, frames, jgf)
    shown = [p for p in pkts if p.displayed]
    out = [np.array([len(pkts)]),
           np.array([p.displayed for p in pkts])]
    out += [np.frombuffer(p.data, np.uint8) for p in pkts]
    out += [np.stack([p.recon[k] for p in shown]) for k in "yuv"]
    if decode:
        from svt_av1_tpu.codec.decoder import Decoder as JDecoder
        dec = JDecoder()
        got = [r for p in pkts for r in dec.decode_temporal_unit(p.data)]
        out += [np.stack([r[k] for r in got]) for k in "yuv"]
    return out


def stream_slice(name, spec, extra=(), decode=False, device="cpu"):
    """(frames, the port's packets on ``device``, the JAX package's stored
    stream: the packets' bytes and displayed flags, the shown recon
    planes, and with ``decode`` the JAX decoder's shown frames) of the
    clip spec ``name``; ``extra``: more inputs of the stored stream's
    fingerprint."""
    frames = spec[0]()
    pkts = _run(Encoder(_config(EncoderConfig, spec, frames), device=device),
                name, frames, tgf)
    ref = port_refs.jax_ref(f"gop_stream_{name}",
                            lambda: _jax_stream(name, spec, frames, decode),
                            *[a for f in frames for a in f],
                            np.array([spec[2]]), *extra)
    n = int(ref[0][0])
    planes = lambda i0, j: dict(y=ref[i0][j], u=ref[i0 + 1][j],
                                v=ref[i0 + 2][j])
    jax = dict(data=[bytes(a) for a in ref[2:2 + n]],
               displayed=list(ref[1]),
               recon=[planes(2 + n, i) for i in range(len(ref[2 + n]))])
    if decode:
        jax["decoded"] = [planes(5 + n, i) for i in range(len(ref[5 + n]))]
    return frames, pkts, jax


@functools.lru_cache(maxsize=None)
def _slice(name):
    return stream_slice(name, CLIPS[name])


def _decode(datas):
    """The port's decoder on the CPU: (shown frames, decisions of every
    coded frame)."""
    dec = Decoder(device="cpu")
    shown, decisions = [], []
    for d in datas:
        shown += dec.decode_temporal_unit(d)
        if obu.OBU_FRAME in [t for t, _ in obu.parse_obus(d)]:
            decisions.append(dec.last_decisions)
    return shown, decisions


def _same_block(a, b):
    return (a.bsize == b.bsize and a.is_inter == b.is_inter
            and a.y_mode == b.y_mode and a.uv_mode == b.uv_mode
            and a.ref == b.ref and a.ref2 == b.ref2 and a.mv == b.mv
            and a.mv2 == b.mv2 and a.use_warp == b.use_warp
            and a.comp_type == b.comp_type and a.wedge_idx == b.wedge_idx
            and a.wedge_sign == b.wedge_sign and a.tx_type == b.tx_type
            and a.motion_mode == b.motion_mode
            and a.interintra_mode == b.interintra_mode
            and np.array_equal(a.qcoeff_y, b.qcoeff_y)
            and np.array_equal(a.qcoeff_u, b.qcoeff_u)
            and np.array_equal(a.qcoeff_v, b.qcoeff_v))


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 99.0 if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


@pytest.mark.parametrize("name", sorted(CLIPS))
def test_gop_round_trip(name):
    """The port's decoder reproduces every shown frame of the port's
    stream exactly, show-existing frames included; the stream has key,
    inter and show-existing packets."""
    frames, pkts, _ = _slice(name)
    shown, decisions = _decode([p.data for p in pkts])
    disp = [p for p in pkts if p.displayed]
    assert len(shown) == len(disp) == len(frames)
    for rec, p in zip(shown, disp):
        for k in "yuv":
            np.testing.assert_array_equal(rec[k], p.recon[k],
                                          err_msg=f"{name} poc {p.pts} {k}")
    kinds = {p.frame_type for p in pkts}
    assert {obu.KEY_FRAME, obu.INTER_FRAME} <= kinds
    assert any(len(p.data) < 8 for p in pkts)          # show-existing
    assert any(not p.displayed for p in pkts)          # hidden base frame
    blocks = [b for d in decisions for b in d.values()]
    comp = [b for b in blocks if b.is_inter and b.ref2]
    assert any(b.is_inter for b in blocks) and comp
    if name == "wipe":
        assert any(b.comp_type == 1 for b in comp), "no wedge block"
    if name == "iris":
        assert any(b.comp_type == 2 for b in comp), "no diffwtd block"
    if name == "rotzoom":
        assert any(b.use_warp for b in blocks), "no warped block"
    if name == "m12_lookahead":
        assert len({b.qindex for b in decisions[0].values()}) > 1, \
            "the key frame codes no delta-q"


def parity(name, frames, pkts, jax):
    """The port's stream against the JAX package's: (share of leaf blocks
    equal, the number that differ, mean Y-PSNR of each, bytes of each,
    whether the streams are identical, whether the JAX stream decodes
    through the port's decoder to the JAX recon).  Printed."""
    _, dec_port = _decode([p.data for p in pkts])
    shown_jax, dec_jax = _decode(jax["data"])
    jax_rt = all(np.array_equal(rec[k], want[k])
                 for rec, want in zip(shown_jax, jax["recon"]) for k in "yuv")
    same = tot = 0
    for a, b in zip(dec_port, dec_jax):
        for k, blk in a.items():
            tot += 1
            same += k in b and _same_block(blk, b[k])
    disp = [p for p in pkts if p.displayed]
    p_port = np.mean([_psnr(f[0], p.recon["y"]) for f, p in zip(frames,
                                                                  disp)])
    p_jax = np.mean([_psnr(f[0], r["y"]) for f, r in zip(frames,
                                                          jax["recon"])])
    b_port = sum(len(p.data) for p in pkts)
    b_jax = sum(len(d) for d in jax["data"])
    identical = [p.data for p in pkts] == jax["data"]
    print(f"{name}: {same / tot:.2%} of {tot} blocks equal ({tot - same} "
          f"differ), Y-PSNR {p_port:.4f} vs {p_jax:.4f} dB, bytes {b_port} "
          f"vs {b_jax}, streams identical: {identical}, JAX stream "
          f"round-trips: {jax_rt}")
    return same / tot, tot - same, p_port, p_jax, b_port, b_jax, identical, \
        jax_rt


@pytest.mark.parametrize("name", sorted(CLIPS))
def test_gop_parity_with_jax(name):
    """Against the JAX package's stream (which round-trips for these
    clips): >= 99% of blocks equal, Y-PSNR within 0.05 dB, bytes within
    1%; byte identity is reported."""
    agree, _, p_port, p_jax, b_port, b_jax, _, jax_rt = parity(
        name, *_slice(name))
    assert jax_rt
    assert agree >= 0.99
    assert abs(p_port - p_jax) <= 0.05
    assert abs(b_port - b_jax) <= 0.01 * b_jax


def _jax_decoded(datas):
    """The JAX package's decoder's shown frames of ``datas``, stacked per
    plane."""
    from svt_av1_tpu.codec.decoder import Decoder as JDecoder
    dec = JDecoder()
    shown = [r for d in datas for r in dec.decode_temporal_unit(d)]
    return tuple(np.stack([np.asarray(r[k]) for r in shown]) for k in "yuv")


def test_jax_decoder_decodes_port_stream():
    """The JAX package's decoder on the port's M10 stream (its output
    stored, fingerprinted by the port's packets) reproduces every shown
    frame of the port's recon."""
    _, pkts, _ = _slice("m10")
    datas = [p.data for p in pkts]
    shown = port_refs.jax_ref("gop_m10_jax_decoder",
                              lambda: _jax_decoded(datas),
                              *[np.frombuffer(d, np.uint8) for d in datas])
    disp = [p for p in pkts if p.displayed]
    assert len(shown[0]) == len(disp)
    for j, p in enumerate(disp):
        for k, planes in zip("yuv", shown):
            np.testing.assert_array_equal(planes[j], p.recon[k])


# ------------------------------------------- send_pictures, recon copies ---

EOS_CFG = dict(source_width=64, source_height=64, enc_mode=12,
               hierarchical_levels=2, intra_period_length=15, enable_tf=0,
               enable_tpl_la=0)


def _eos_frames():
    return clips.natural_clip(6, 64, 64, seed=3)


def _eos_jax_stream():
    """The JAX package's send_picture + flush stream of the 6 frames."""
    from svt_av1_tpu.api.config import EncoderConfig as JConfig
    from svt_av1_tpu.api.encoder import Encoder as JEncoder
    enc = JEncoder(JConfig(**EOS_CFG))
    for f in _eos_frames():
        enc.send_picture(*f)
    enc.flush()
    pkts = []
    while (p := enc.get_packet()) is not None:
        pkts.append(p)
    return [np.array([p.displayed for p in pkts])] + [
        np.frombuffer(p.data, np.uint8) for p in pkts]


@functools.lru_cache(maxsize=None)
def _send_pictures_eos(recon_enabled):
    enc = Encoder(EncoderConfig(**EOS_CFG), device="cpu")
    enc.recon_enabled = recon_enabled
    enc.send_pictures(_eos_frames(), eos=True)
    assert enc.done is False
    pkts = []
    while (p := enc.get_packet()) is not None:
        pkts.append(p)
    assert enc.done
    return pkts


def test_send_pictures_eos_shows_every_frame():
    """send_pictures(frames, eos=True) drains the last partial mini-GoP:
    all 6 frames are shown, in the JAX package's send_picture + flush
    stream (whose own send_pictures drops the last partial mini-GoP)."""
    frames = _eos_frames()
    ref = port_refs.jax_ref("gop_eos_stream", _eos_jax_stream,
                            *[a for f in frames for a in f])
    pkts = _send_pictures_eos(True)
    assert sum(p.displayed for p in pkts) == len(frames) == 6
    assert sorted(p.pts for p in pkts if p.displayed) == list(range(6))
    assert [p.displayed for p in pkts] == list(ref[0])
    assert [p.data for p in pkts] == [bytes(a) for a in ref[1:]]


def test_recon_enabled_off_skips_recon_copies():
    """recon_enabled=False: the same packets, and no recon on the shown
    inter and show-existing frames (key frames keep theirs, as in the
    reference)."""
    on, off = _send_pictures_eos(True), _send_pictures_eos(False)
    assert [p.data for p in off] == [p.data for p in on]
    assert [p.displayed for p in off] == [p.displayed for p in on]
    inter = [p for p in off if p.frame_type != obu.KEY_FRAME]
    assert inter and all(p.recon is None for p in inter)
    assert all(p.recon is not None for p in off
               if p.frame_type == obu.KEY_FRAME)
    assert all(p.recon is not None for p in on if p.displayed)


# -------------------------------------- settings of the stage path ---

GOP = dict(intra_period_length=15, hierarchical_levels=3, enable_tf=0,
           enable_tpl_la=0)


@pytest.mark.parametrize("fields,item", [
    (dict(sframe_dist=2), "item 7"),
    (dict(pred_structure=1), "item 7"),
    (dict(hierarchical_levels=0), "item 7"),
    (dict(encoder_bit_depth=10), "item 7"),
    # two tile columns (at 64 px wide the layout has one, which the GOP
    # codes, as the reference does: tests/test_torch_api_surface.py)
    (dict(tile_columns=1, source_width=128), "item 7"),
    (dict(film_grain_denoise_strength=8), "item 7"),
])
def test_out_of_scope_gop_settings_raise(fields, item):
    """The GOP settings that the port refused until the stage path came
    (ROADMAP.md queue A item 7, step 8) now encode, each on the stage
    path as in the reference: S-frames, low delay, IPPP, 10 bits, two
    tile columns (one tile coded), film grain.  Three frames of each,
    byte-identical to the JAX package's stored stream and decoded exactly
    by the port's decoder (tests/test_torch_stage_path.py has more)."""
    import test_torch_stage_path as tsp
    cfg = dict(dict(source_width=64, source_height=64, **GOP), **fields)
    w = cfg.pop("source_width")
    cfg.pop("source_height")
    frames = (clips.natural_clip10(3, w, 64, seed=13)
              if cfg.get("encoder_bit_depth") == 10
              else clips.natural_clip(3, w, 64, seed=13))
    enc = Encoder(tsp.config(EncoderConfig, cfg, frames), device="cpu")
    assert not enc._fast, item
    tsp.check_stream("gop_scope_" + "_".join(
        f"{k}{v}" for k, v in sorted(fields.items())), cfg, frames)


@pytest.mark.parametrize("tool", ["hp"])
def test_m5_m9_inter_tools_raise(tool):
    """1/8-pel MVs (hp_mv, off at every preset), which P1 refused until
    they were ported (the name is kept): P1 at M10 with hp on the R = 2
    inputs of test_p1_matches_jax against the JAX P1 with hp, by its
    parity rule."""
    from svt_av1_tpu.codec.rate_est import md_rate_args as jrate
    from svt_av1_tpu.ops import quant as jq
    from svt_av1_tpu.pipeline import gop_fast as jgf
    feat = features_for(10)
    modes = tuple(feat.intra_modes)
    src_pack, refs = _p1_inputs(2)
    args = (64, 96, 2, modes, 8, feat.subpel_ring, True, feat.hme_rad2,
            feat.hme_rad0, tool == "hp")

    def jax_run():
        rt = jrate(QINDEX, modes, UV_MODES, None, inter_frame=True,
                   exact=feat.exact_rates)
        return jgf._jit_p1(*args, skip_mode=True)(
            src_pack, *refs, *jq.make_quant_params(QINDEX),
            tgf.frame_lambda(QINDEX), *rt[:7])

    ref = port_refs.jax_ref(f"gop_p1_{tool}_r2", jax_run, src_pack, *refs,
                            np.array([tool]))
    rt = md_rate_args(QINDEX, modes, UV_MODES, inter_frame=True,
                      exact=feat.exact_rates, device=CPU)
    p1 = tgf.build_p1(*args, skip_mode=True)
    got = [o.numpy() for o in p1(
        *tgf._src_planes(src_pack, 64, 96, CPU),
        *(torch.as_tensor(r) for r in refs), quant.params_on(QINDEX, CPU),
        torch.tensor(tgf.frame_lambda(QINDEX)), rt)]
    agree = _agreement(got, ref)
    o, r = dict(zip(P1_OUT, got)), dict(zip(P1_OUT, ref))
    mv = o["mv"][o["choose"].astype(bool)]
    print(f"P1 {tool} R=2: {agree:.2%} of {o['choose'].size} blocks equal; "
          f"odd MVs {int(((mv[:, 0] | mv[:, 1]) & 1).astype(bool).sum())}")
    assert agree >= 0.99
    for k in ("gm_mats", "gm_trans", "gm_kinds", "interp"):
        np.testing.assert_array_equal(o[k], r[k], err_msg=k)
    if agree == 1.0:
        for k in P1_OUT:
            np.testing.assert_array_equal(o[k], r[k], err_msg=k)
