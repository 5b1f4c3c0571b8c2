"""The port's GOP encode at presets M5-M9 against the JAX package on the
CPU: the inter tx-type search, the 8x8 split, OBMC, inter-intra and TMVP.

- P1 of one inter frame with each M5-M8 tool and with all four (R = 1
  and 2 references) against the JAX program's outputs stored in
  tests/golden/torch_port_refs.npz: decisions by the parity rule, and
  where every block agrees the recon, the tx indices, the splits and the
  motion modes exactly.  P2 with 8x8 leaves (split8) exact on the JAX
  P1's outputs.
- The port's reconstruction from decisions (what its decoder runs) on
  the JAX P1's decisions of the all-tools frame: 8x8 leaves, OBMC and
  inter-intra blocks reproduce the JAX encoder's recon exactly.
- The whole slice through Encoder.send_picture / flush (tests/clips.py
  clips, tests/test_torch_gop.py helpers): every stream round-trips
  through the port's decoder; it meets the parity rule against the JAX
  package's stored stream, byte identity printed; the clip's tool fires.
- The reference's M5-M8 round-trip fault (ROADMAP.md queue C item 4),
  shown on the clips where it fires.
- M9 is M10: the port's M9 stream equals its M10 stream byte for byte.
"""
import functools

import numpy as np
import pytest
import torch

import clips
import port_refs
import test_torch_gop as tg
from svt_av1_tpu_torch.api.encoder import Encoder, EncoderConfig
from svt_av1_tpu_torch.codec import constants as cc
from svt_av1_tpu_torch.codec.rate_est import md_rate_args
from svt_av1_tpu_torch.ops import quant
from svt_av1_tpu_torch.pipeline import cdef_stage
from svt_av1_tpu_torch.pipeline import gop_fast as tgf
from svt_av1_tpu_torch.pipeline import inter_encoder as tie
from svt_av1_tpu_torch.pipeline.intra_encoder import UV_MODES
from svt_av1_tpu_torch.pipeline.presets import features_for

torch.set_num_threads(2)
CPU = torch.device("cpu")
QINDEX = tg.QINDEX
P1_OUT = tg.P1_OUT
# P1 tool sets: name -> (obmc, interintra, tx_search, split8)
TOOLS = {
    "tx": (False, False, True, False),
    "split8": (False, False, False, True),
    "alts": (True, True, False, False),
    "all": (True, True, True, True),
}
# fields compared per block beyond tests/test_torch_gop.py's
M6_FIELDS = tg.BLOCK_FIELDS + ("obmc", "ii", "itx", "split", "smv", "ssk")


def _p1_inputs(R):
    """64x96 frames: frame 2 of the fault clip coded from frame 1 (R = 1;
    the tx search, the split, OBMC and inter-intra all fire), or frame 2
    of the OBMC seam texture from frames 1 and 3 as LAST and ALTREF
    (R = 2; splits and OBMC fire beside compound blocks)."""
    fr = (clips.fault_clip(4, 64, 96) if R == 1
          else clips.seam_clip(4, 64, 96))
    y, u, v = fr[2]
    src_pack = np.concatenate([y, np.concatenate([u, v], 1)], 0)
    refs = [fr[1]] if R == 1 else [fr[1], fr[3]]
    return src_pack, tuple(np.stack([r[i] for r in refs]).astype(np.int32)
                           for i in range(3))


def _jax_p1(src_pack, refs, R, tools):
    from svt_av1_tpu.codec.rate_est import md_rate_args as jrate
    from svt_av1_tpu.ops import quant as jq
    from svt_av1_tpu.pipeline import gop_fast as jgf
    feat = features_for(6)
    modes = tuple(feat.intra_modes)
    obmc, ii, txs, sp8 = TOOLS[tools]
    rt = jrate(QINDEX, modes, UV_MODES, None, inter_frame=True,
               exact=feat.exact_rates)
    p1 = jgf._jit_p1(64, 96, R, modes, 8, feat.subpel_ring, R >= 2,
                     feat.hme_rad2, feat.hme_rad0, False, obmc, ii, True,
                     txs, sp8)
    return p1(src_pack, *refs, *jq.make_quant_params(QINDEX),
              tgf.frame_lambda(QINDEX), *rt[:7])


def _port_p1(src_pack, refs, R, tools):
    feat = features_for(6)
    modes = tuple(feat.intra_modes)
    obmc, ii, txs, sp8 = TOOLS[tools]
    rt = md_rate_args(QINDEX, modes, UV_MODES, inter_frame=True,
                      exact=feat.exact_rates, device=CPU)
    p1 = tgf.build_p1(64, 96, R, modes, 8, feat.subpel_ring, R >= 2,
                      feat.hme_rad2, feat.hme_rad0, False, obmc, ii, True,
                      txs, sp8)
    src = tgf._src_planes(src_pack, 64, 96, CPU)
    outs = p1(*src, *(torch.as_tensor(r) for r in refs),
              quant.params_on(QINDEX, CPU),
              torch.tensor(tgf.frame_lambda(QINDEX)), rt)
    return [o.numpy() for o in outs]


@functools.lru_cache(maxsize=None)
def _p1_pair(R, tools):
    src_pack, refs = _p1_inputs(R)
    ref = port_refs.jax_ref(f"gop_m6_p1_{tools}_r{R}",
                            lambda: _jax_p1(src_pack, refs, R, tools),
                            src_pack, *refs, np.array(TOOLS[tools]))
    return src_pack, refs, _port_p1(src_pack, refs, R, tools), ref


def _block_diff(got, ref):
    """(nb,) bool: the blocks whose decisions differ in any M6 field."""
    o, r = dict(zip(P1_OUT, got)), dict(zip(P1_OUT, ref))
    nb = o["choose"].shape[0]
    diff = np.zeros(nb, bool)
    for k in M6_FIELDS:
        a = o[k].reshape(nb, -1).astype(np.int64)
        b = r[k].reshape(nb, -1).astype(np.int64)
        diff |= (a != b).any(axis=1)
    return diff


def _first_difference(diff, o, r, gh=4, gw=6):
    """The first block in pass B's 2:1 wave order whose decisions differ,
    and whether an OBMC choice next to an 8x8 split neighbour explains
    it: the port prices such a candidate with the neighbour's sub MVs, as
    a decoder blends it, where the reference leaves that neighbour out
    (ROADMAP.md queue C item 4).  Blocks after it in wave order may differ
    as its consequences (their intra neighbours, OBMC sources)."""
    order = sorted(range(gh * gw), key=lambda b: (2 * (b // gw) + b % gw,
                                                  b // gw))
    first = next(b for b in order if diff[b])
    by, bx = divmod(first, gw)
    split = r["split"].reshape(gh, gw)
    nbr = (by > 0 and split[by - 1, bx]) or (bx > 0 and split[by, bx - 1])
    return first, bool(nbr and (o["obmc"][first] or r["obmc"][first]))


@pytest.mark.parametrize("R", [1, 2])
@pytest.mark.parametrize("tools", sorted(TOOLS))
def test_p1_tools_match_jax(tools, R):
    """P1 with the M5-M8 tools against the JAX P1: every block's
    decisions equal, and then the recon and merges exactly; or, with the
    8x8 split and OBMC both on, the first differing block in wave order
    is an OBMC choice next to a split neighbour (_first_difference),
    counted and printed.  The tools that fire are printed."""
    src_pack, refs, got, ref = _p1_pair(R, tools)
    assert len(got) == len(ref) == 30
    o, r = dict(zip(P1_OUT, got)), dict(zip(P1_OUT, ref))
    diff = _block_diff(got, ref)
    cause = ""
    if diff.any():
        first, explained = _first_difference(diff, o, r)
        cause = (f"; first at block {first}, an OBMC choice next to a "
                 f"split: {explained}")
    print(f"P1 {tools} R={R}: {int((~diff).sum())} of {diff.size} blocks "
          f"equal{cause}; inter {int(r['choose'].sum())}, non-DCT tx "
          f"{int((r['itx'] > 0).sum())}, split {int(r['split'].sum())}, "
          f"OBMC {int(r['obmc'].sum())}, inter-intra "
          f"{int((r['ii'] >= 0).sum())}")
    for k in ("gm_mats", "gm_trans", "gm_kinds", "interp"):
        np.testing.assert_array_equal(o[k], r[k], err_msg=k)
    if diff.any():
        assert tools == "all" and explained, cause
        return
    for k in ("ry", "ru", "rv", "merge32", "merge64", "mergeh", "mergev"):
        np.testing.assert_array_equal(o[k], r[k], err_msg=k)


def test_p1_tools_fire():
    """The P1 unit inputs code every M5-M8 tool somewhere."""
    fired = {k: 0 for k in ("itx", "split", "obmc", "ii")}
    for R in (1, 2):
        for tools in TOOLS:
            r = dict(zip(P1_OUT, _p1_pair(R, tools)[3]))
            fired["itx"] += int((r["itx"] > 0).sum())
            fired["split"] += int(r["split"].sum())
            fired["obmc"] += int(r["obmc"].sum())
            fired["ii"] += int((r["ii"] >= 0).sum())
    print("P1 tool counts over the eight cases:", fired)
    assert all(fired.values()), fired


@pytest.mark.parametrize("R", [1, 2])
def test_p2_split8_matches_jax(R):
    """P2 with 8x8 leaves (per-8x8 skips, DLF at 8-px granularity, CDEF
    on the 8x8 skip map) on the JAX all-tools P1's outputs, exact."""
    src_pack, _, _, ref = _p1_pair(R, "all")
    r = dict(zip(P1_OUT, ref))
    gh, gw = 4, 6
    skip16 = ((np.abs(r["qy"]).max(1) == 0) & (np.abs(r["qu"]).max(1) == 0)
              & (np.abs(r["qv"]).max(1) == 0)).reshape(gh, gw)
    split16 = r["split"].reshape(gh, gw)
    t = lambda a: torch.as_tensor(np.asarray(a))
    skip8 = tgf._derive_skip8(t(r["qy"]), t(r["qu"]), t(r["qv"]),
                              t(skip16), t(split16), gh, gw).numpy()
    cands = np.asarray(cdef_stage.SEARCH_SET[:6], np.int32)
    args = (src_pack, r["ry"], r["ru"], r["rv"], skip16,
            tgf.dlf_ladder_params(QINDEX, False),
            tgf.dlf_ladder_params(QINDEX, True), cands,
            np.int32(cdef_stage.cdef_damping(QINDEX)), r["merge32"],
            r["choose"].reshape(gh, gw), r["merge64"], split16, skip8)

    def jax_p2():
        from svt_av1_tpu.pipeline import gop_fast as jgf
        jskip8 = jgf._derive_skip8(r["qy"], r["qu"], r["qv"], skip16,
                                   split16, gh, gw)
        p2 = jgf._jit_p2(64, 96, 8, len(cands), True, True, masked=True,
                         split8=True)
        return p2(*args[:12], split16, jskip8, mergeh=r["mergeh"],
                  mergev=r["mergev"]) + (jskip8,)

    want = port_refs.jax_ref(f"gop_m6_p2_r{R}", jax_p2, *args, r["mergeh"],
                             r["mergev"])
    np.testing.assert_array_equal(skip8, want[6])
    got = tgf.p2(*tgf._src_planes(src_pack, 64, 96, CPU), t(r["ry"]),
                 t(r["ru"]), t(r["rv"]), t(skip16), args[5], args[6], cands,
                 int(args[8]), merge32=t(r["merge32"]), inter16=t(args[10]),
                 merge64=t(r["merge64"]), mergeh=t(r["mergeh"]),
                 mergev=t(r["mergev"]), split16=t(split16), skip8m=t(skip8))
    for i in range(4):
        np.testing.assert_array_equal(got[i].numpy(), want[i])
    assert want[4].max() < 2 ** 24
    np.testing.assert_array_equal(got[4].numpy().astype(np.float64),
                                  want[4].astype(np.float64))
    assert int(got[5]) == int(want[5])
    print(f"P2 split8 R={R}: {int(split16.sum())} split blocks, DLF levels "
          f"{got[3].tolist()}, CDEF candidate {int(got[5])}")


def _decisions_of(outs, refs_enums, h=64, w=96):
    """The port's collect_inter_frame on P1 outputs (numpy), P2 unused."""
    pend = tgf.PendingInterFrame.__new__(tgf.PendingInterFrame)
    pend.h, pend.w, pend.ref_enums = h, w, refs_enums
    pend.cdef_on = False
    pend.recon = dict(y=torch.as_tensor(outs[0]))
    pend.host = [torch.as_tensor(np.asarray(a)) for a in outs[3:]] + [
        torch.zeros(3, dtype=torch.int32), torch.zeros((), dtype=torch.int64)]
    return tgf.collect_inter_frame(pend)


@pytest.mark.parametrize("R", [1, 2])
def test_recon_from_decisions_matches_jax_encoder(R):
    """The port's reconstruction from the JAX all-tools P1's decisions (8x8
    leaves, OBMC, inter-intra, non-DCT inter tx types) equals the JAX
    encoder's own pre-filter recon, wherever that encoder follows the
    specification (OBMC blocks next to a split neighbour excepted and
    counted)."""
    src_pack, refs, _, ref = _p1_pair(R, "all")
    r = dict(zip(P1_OUT, ref))
    enums = [1] if R == 1 else [1, 7]
    decisions, _, header = _decisions_of(ref, enums)
    kinds = {"split": sum(d.bsize == cc.BLOCK_8X8 for d in decisions.values()),
             "obmc": sum(d.motion_mode == 1 for d in decisions.values()),
             "ii": sum(d.interintra_mode >= 0 for d in decisions.values()),
             "itx": sum(d.is_inter and d.tx_type != cc.DCT_DCT
                        for d in decisions.values())}
    rec = tie.reconstruct_inter_from_decisions(
        decisions, {e: dict(y=refs[0][i], u=refs[1][i], v=refs[2][i])
                    for i, e in enumerate(enums)}, 96, 64, QINDEX,
        gm=header["gm"], interp=header["interp"], device="cpu")
    gh, gw = 4, 6
    split = r["split"].reshape(gh, gw)
    bad16 = np.zeros((gh, gw), bool)
    for k, want in zip("yuv", (r["ry"], r["ru"], r["rv"])):
        n = 16 if k == "y" else 8
        d = rec[k].numpy() != want
        bad16 |= d.reshape(gh, n, gw, n).any(axis=(1, 3))
    near_split = np.zeros((gh, gw), bool)
    near_split[1:] |= split[:-1]
    near_split[:, 1:] |= split[:, :-1]
    obmc = r["obmc"].reshape(gh, gw)
    print(f"recon R={R}: {kinds}; blocks differing {int(bad16.sum())} "
          f"(OBMC next to a split: {int((obmc & near_split).sum())})")
    assert not (bad16 & ~(obmc & near_split)).any(), np.nonzero(bad16)


# ------------------------------------------------------------- the slice ---

CLIPS = {
    # name: (frames, config fields, preset); tests/test_torch_gop.py's
    # _config adds hierarchical_levels 2, DLF + CDEF on, the lookahead off
    "m6": (lambda: clips.natural_clip(5, 64, 64, seed=1),
           dict(qp=35, intra_period_length=4), 6),
    "m8": (lambda: clips.natural_clip(5, 64, 64, seed=1),
           dict(qp=35, intra_period_length=4), 8),
    # the clips and settings of tests/test_obmc.py, test_interintra.py
    # and test_part8.py (tool isolation: tests/clips.py PINNED_FEATURES)
    "obmc_m6": (clips.seam_clip, dict(qp=50, intra_period_length=31,
                                      enable_dlf_flag=0, cdef_level=0), 6),
    "ii_m6": (clips.gradient_wipe_clip,
              dict(qp=45, intra_period_length=31, enable_dlf_flag=0,
                   cdef_level=0), 6),
    "part8_tmvp_m6": (clips.boundary_clip,
                      dict(qp=40, intra_period_length=15), 6),
    "m6_lookahead": (lambda: clips.split_motion_clip(7),
                     dict(qp=35, intra_period_length=4, enable_tf=1,
                          enable_tpl_la=1), 6),
    # the reference's round-trip fault (ROADMAP.md queue C item 4), with
    # all M6 tools and with the tx search pinned off
    "m6_fault": (clips.fault_clip, dict(qp=35, intra_period_length=15,
                                        enable_tf=1), 6),
    "m6_fault_notx": (clips.fault_clip, dict(qp=35, intra_period_length=15,
                                             enable_tf=1), 6),
}
FAULTS = ("m6_fault", "m6_fault_notx")


@functools.lru_cache(maxsize=None)
def _slice(name):
    pins = clips.PINNED_FEATURES.get(name, {})
    return tg.stream_slice(name, CLIPS[name],
                           extra=(np.array(sorted(pins.items()), str),),
                           decode=name in FAULTS)


def _tool_counts(decisions, headers):
    """Per-tool block counts over a stream's coded frames."""
    inter = [b for d in decisions for b in d.values() if b.is_inter]
    return dict(
        split8=sum(b.bsize == cc.BLOCK_8X8 for b in inter),
        itx=sum(b.tx_type != cc.DCT_DCT and bool(np.any(b.qcoeff_y))
                for b in inter),
        obmc=sum(b.motion_mode == 1 for b in inter),
        ii=sum(b.interintra_mode >= 0 for b in inter),
        compound=sum(bool(b.ref2) for b in inter),
        tmvp_frames=sum(bool(h.use_ref_frame_mvs) for h in headers),
        obmc_frames=sum(bool(h.is_motion_mode_switchable) for h in headers),
        dq_key=int(len({b.qindex for b in decisions[0].values()}) > 1))


def _decode_with_headers(datas):
    dec = tg.Decoder(device="cpu")
    shown, decisions, headers = [], [], []
    for d in datas:
        shown += dec.decode_temporal_unit(d)
        if tg.obu.OBU_FRAME in [t for t, _ in tg.obu.parse_obus(d)]:
            decisions.append(dec.last_decisions)
            headers.append(dec.last_frame_header)
    return shown, decisions, headers


# the tool each clip must code on the port's stream
FIRES = {"m6": ("itx", "tmvp_frames", "obmc_frames"), "m8": ("itx",),
         "obmc_m6": ("obmc",), "ii_m6": ("ii",),
         "part8_tmvp_m6": ("split8", "tmvp_frames"),
         "m6_lookahead": ("dq_key", "tmvp_frames"),
         "m6_fault": ("ii", "itx"), "m6_fault_notx": ("obmc", "split8")}


@pytest.mark.parametrize("name", sorted(CLIPS))
def test_m6_round_trip(name):
    """The port's decoder reproduces every shown frame of the port's M6 /
    M8 stream exactly; the clip's tool fires (counts printed)."""
    frames, pkts, _ = _slice(name)
    shown, decisions, headers = _decode_with_headers([p.data for p in pkts])
    disp = [p for p in pkts if p.displayed]
    assert len(shown) == len(disp) == len(frames)
    for rec, p in zip(shown, disp):
        for k in "yuv":
            np.testing.assert_array_equal(rec[k], p.recon[k],
                                          err_msg=f"{name} poc {p.pts} {k}")
    counts = _tool_counts(decisions, headers)
    print(f"{name}: {counts}")
    for tool in FIRES[name]:
        assert counts[tool] > 0, f"{name}: no {tool}"


@pytest.mark.parametrize("name", sorted(CLIPS))
def test_m6_parity_with_jax(name):
    """Against the JAX package's stream: the parity rule (>= 99% of blocks
    equal, Y-PSNR within 0.05 dB, bytes within 1%), and byte identity
    where the JAX stream decodes to its own recon through a decoder that
    follows the specification (the port's), unless a frame's global-
    motion model differs: the GM fit is float32 least squares, held to a
    tie rule (tests/test_torch_motion.py, chip_smoke phase 17), and a
    model quantized the other way changes that frame's warp and its MV
    coding.  Such frames are counted and printed."""
    frames, pkts, jax = _slice(name)
    agree, ndiff, p_port, p_jax, b_port, b_jax, identical, jax_rt = \
        tg.parity(name, frames, pkts, jax)
    _, _, h_port = _decode_with_headers([p.data for p in pkts])
    _, _, h_jax = _decode_with_headers(jax["data"])
    gm_ties = sum(a.gm_trans != b.gm_trans for a, b in zip(h_port, h_jax))
    print(f"{name}: frames whose GM model differs (float32 ties) {gm_ties}")
    assert agree >= 0.99
    assert abs(p_port - p_jax) <= 0.05
    assert abs(b_port - b_jax) <= 0.01 * b_jax
    if jax_rt and not gm_ties:
        assert identical
    if not jax_rt:
        assert name in FAULTS, "the JAX stream fails the round trip"


@pytest.mark.parametrize("name", FAULTS)
def test_reference_round_trip_fault(name):
    """The reference's M6 fault, shown (ROADMAP.md queue C item 4): its
    decoder does not reproduce its encoder's recon on these clips (the
    stored output of svt_av1_tpu/codec/decoder.py), while the port's
    stream decodes exactly through the port's decoder.
    - m6_fault: an inter-intra (or OBMC) block coded with a non-DCT tx
      type, which the reference's decoder inverts as DCT_DCT.  Its
      encoder follows the specification there: the streams are
      identical, and the port's decoder decodes the reference's stream
      to the reference's recon.
    - m6_fault_notx: an OBMC block next to an 8x8 split neighbour, which
      the reference's encoder leaves out of the blend and its decoder
      blends with the wrong sub's MV; the port blends it per 8-px segment
      with the touching subs' MVs (spec 7.11.3.10), so its stream
      differs there."""
    frames, pkts, jax = _slice(name)
    bad = [tuple(int((np.asarray(d[k]) != np.asarray(r[k])).sum())
                 for k in "yuv")
           for d, r in zip(jax["decoded"], jax["recon"])]
    print(f"{name}: reference decoder vs reference recon, pixels differing "
          f"per shown frame (y, u, v): {bad}")
    assert any(sum(b) for b in bad)
    shown, _ = tg._decode([p.data for p in pkts])
    for rec, p in zip(shown, [p for p in pkts if p.displayed]):
        for k in "yuv":
            np.testing.assert_array_equal(rec[k], p.recon[k])
    shown_jax, _ = tg._decode(jax["data"])
    jax_rt = all(np.array_equal(a[k], b[k]) for a, b in
                 zip(shown_jax, jax["recon"]) for k in "yuv")
    assert jax_rt == (name == "m6_fault")


def test_jax_decoder_decodes_port_stream():
    """One live cross-run on the first packets of the port's OBMC stream
    (the key frame and the hidden base frame, whose blocks include OBMC
    and inter-intra ones at DCT_DCT and no 8x8 split: where the JAX
    package's decoder follows the specification): that decoder's DPB
    slots hold exactly the port's decoder's planes.  (Not on m6: that
    stream codes OBMC and inter-intra blocks with non-DCT tx types, which
    the reference's decoder inverts as DCT_DCT; see
    test_reference_round_trip_fault.)"""
    from svt_av1_tpu.codec.decoder import Decoder as JDecoder
    _, pkts, _ = _slice("obmc_m6")
    jdec, tdec = JDecoder(), tg.Decoder(device="cpu")
    modes = []
    for p in pkts[:2]:
        jdec.decode_temporal_unit(p.data)
        tdec.decode_temporal_unit(p.data)
        modes += [(b.motion_mode, b.interintra_mode)
                  for b in tdec.last_decisions.values() if b.is_inter]
        for i in range(8):
            for k in "yuv":
                np.testing.assert_array_equal(
                    np.asarray(jdec.slots[i][k]),
                    tdec.slots[i][k].cpu().numpy(), err_msg=f"slot {i} {k}")
    assert any(m == 1 for m, _ in modes) and any(i >= 0 for _, i in modes)


def test_m9_stream_is_m10_stream():
    """M9 takes the M10 ladder entry (features_for(9) == features_for(10),
    and the encoder reads enc_mode only through it): the port's M9 stream
    of the m10 clip is its M10 stream."""
    assert features_for(9) == features_for(10)
    frames, m10, _ = tg._slice("m10")
    spec = (tg.CLIPS["m10"][0], tg.CLIPS["m10"][1], 9)
    m9 = tg._run(Encoder(tg._config(EncoderConfig, spec, frames),
                         device="cpu"), "m9", frames, tgf)
    assert [p.data for p in m9] == [p.data for p in m10]


@pytest.mark.parametrize("feature", ["hp_mv", "mref"])
def test_feature_overrides_outside_the_slice_raise(monkeypatch, feature):
    """1/8-pel MVs and the third reference stay refused at M6 when a
    feature override turns them on, naming queue A item 7."""
    import dataclasses

    from svt_av1_tpu_torch.api import encoder as enc_mod
    monkeypatch.setattr(enc_mod, "features_for", lambda m: dataclasses.replace(
        features_for(m), **{feature: True}))
    cfg = EncoderConfig(source_width=64, source_height=64, enc_mode=6,
                        intra_period_length=15, hierarchical_levels=2)
    with pytest.raises(NotImplementedError, match="queue A item 7"):
        Encoder(cfg, device="cpu")


@pytest.mark.xfail(strict=True, reason=(
    "ROADMAP.md queue C item 4: on the clip of tests/test_rect_partition.py "
    "no block codes as skip at qp 35 (the rolled, low-passed texture leaves "
    "a residual after MC), so no skip pair merges into a 32x16 / 16x32 leaf "
    "at any preset, in either package; the reference's test fails on it"))
def test_rect_clip_codes_rect_leaves():
    """The reference's rect-partition clip at M6 (intra_period_length 31:
    its -1 is not ported, queue A item 7; the same 5 frames under one key
    frame) codes a rect skip leaf."""
    frames = clips.two_motion_clip(True)
    enc = Encoder(EncoderConfig(source_width=96, source_height=96, qp=35,
                                intra_period_length=31,
                                hierarchical_levels=2, enc_mode=6),
                  device="cpu")
    pkts = tg._run(enc, "rect", frames, tgf)
    _, decisions = tg._decode([p.data for p in pkts])
    assert any(b.bsize in (cc.BLOCK_32X16, cc.BLOCK_16X32)
               for d in decisions for b in d.values())
