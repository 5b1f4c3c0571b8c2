"""The port's hierarchical GOP at presets M0-M4 against the JAX package
on the CPU:

- a 64x64 x5 GOP at M2 (hierarchical_levels 1, keyint 8, DLF + CDEF,
  MCTF and TPL off): key frames with the filter-intra pseudo-modes, the
  tx search, angle deltas and CfL (no palette at the varpart presets, as
  in the reference), inter frames with the M5-M8 tools and the third
  (GOLDEN-role) reference: the second mini-GoP's base searches the first
  mini-GoP's anchor, which the DPB keeps alive one mini-GoP longer.  The
  key frames' per-SB CDEF pick (cdef_stage.select_sb_sets) is forced to
  two strength sets in both packages (one 64x64 superblock never pays
  for them), as tests/test_cdef_sb.py forces the reference's.  The
  stream is byte-identical to the JAX package's stored stream, and the
  port's decoder reproduces every shown frame; the JAX decoder's frames
  of that stream are compared where the reference decoder follows the
  spec (ROADMAP.md queue C item 4);
- the DPB: every inter frame's references by order hint, and the GOLDEN
  slot still holding the previous anchor when the base that refers to it
  is decoded;
- a 64x64 x17 GOP at M4 with hierarchical_levels 3 (two 8-frame
  mini-GoPs, TMVP on): the second base's GOLDEN is the key frame, kept
  through the first mini-GoP by keep_poc; every reference slot of every
  inter frame holds its frame's picture when the frame is decoded, and
  the stream is byte-identical to the JAX package's stored stream;
- every preset M0-M4 is accepted on the all-intra and the GOP routes.
"""
import functools
from collections import Counter

import numpy as np
import pytest
import torch

import clips
import test_torch_gop as tg
from svt_av1_tpu_torch.api.encoder import Encoder, EncoderConfig
from svt_av1_tpu_torch.codec import mv_pred, obu
from svt_av1_tpu_torch.codec import constants as cc
from svt_av1_tpu_torch.pipeline import cdef_stage

torch.set_num_threads(2)
SPEC = (lambda: clips.natural_clip(5, 64, 64, seed=1),
        dict(qp=35, intra_period_length=8, hierarchical_levels=1), 2)
# the main path's GOP shape: the rows shift out and back, so that poc 16
# repeats poc 0 and its base codes from GOLDEN
SPEC3 = (lambda: clips.seam_clip(17, back=True),
         dict(qp=35, intra_period_length=32, hierarchical_levels=3), 4)


def _forced_sets(sse, coded, lam, cands, max_bits=3):
    """Two strength sets, every coded superblock on the second."""
    return 1, (tuple(cands[1]), tuple(cands[3])), \
        np.where(coded, 1, -1).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _m2_gop():
    from svt_av1_tpu.pipeline import cdef_stage as jcdef
    mp = pytest.MonkeyPatch()
    mp.setattr(cdef_stage, "select_sb_sets", _forced_sets)
    mp.setattr(jcdef, "select_sb_sets", _forced_sets)
    try:
        return tg.stream_slice("m2_gop", SPEC, extra=(np.array([1]),),
                               decode=True)
    finally:
        mp.undo()


def test_m2_gop_matches_jax():
    frames, pkts, jax = _m2_gop()
    identical = [p.data for p in pkts] == jax["data"]
    shown, decisions = tg._decode([p.data for p in pkts])
    disp = [p for p in pkts if p.displayed]
    assert len(shown) == len(disp) == len(frames)
    for rec, p in zip(shown, disp):
        for k in "yuv":
            np.testing.assert_array_equal(rec[k], p.recon[k],
                                          err_msg=f"poc {p.pts} {k}")
    blocks = [b for d in decisions for b in d.values()]
    n = dict(golden=sum(b.is_inter and b.ref == mv_pred.GOLDEN_FRAME
                        for b in blocks),
             compound=sum(b.is_inter and b.ref2 > 0 for b in blocks),
             obmc=sum(b.is_inter and b.motion_mode == 1 for b in blocks),
             interintra=sum(b.is_inter and b.interintra_mode >= 0
                            for b in blocks),
             d45_d67_d203=sum(not b.is_inter and b.y_mode in (
                 cc.D45_PRED, cc.D67_PRED, cc.D203_PRED) for b in blocks))
    dec = tg.Decoder(device="cpu")
    bits = []
    for p in pkts:
        dec.decode_temporal_unit(p.data)
        if obu.OBU_FRAME in [t for t, _ in obu.parse_obus(p.data)]:
            bits.append(dec.last_frame_header.cdef_bits)
    # the reference decoder inverts OBMC / inter-intra blocks at DCT_DCT
    # (queue C item 4 (a)): its frames are held to the recon only where
    # no such block carries another tx type
    fault = sum(b.is_inter and (b.motion_mode == 1 or b.interintra_mode >= 0)
                and b.tx_type != cc.DCT_DCT and np.any(b.qcoeff_y)
                for b in blocks)
    jax_rt = all(np.array_equal(j[k], p.recon[k])
                 for j, p in zip(jax["decoded"], disp) for k in "yuv")
    print(f"M2 GOP 64x64 x5: byte-identical {identical}; blocks {n}; "
          f"cdef_bits per coded frame {bits}; JAX decoder equal "
          f"{jax_rt} (blocks of the reference's decoder fault {fault})")
    assert identical
    assert n["golden"] > 0 and n["d45_d67_d203"] > 0
    assert bits[0] > 0
    if fault == 0:
        assert jax_rt


def test_m2_gop_golden_dpb():
    """Each inter frame refers to the frames its mini-GoP schedule names
    (by order hint: LAST, ALTREF and, for the second mini-GoP's base (poc
    4), GOLDEN = the first anchor, the key frame, in a slot of its own),
    and the GOLDEN slot still holds the key frame's picture when poc 4 is
    decoded: keep_poc kept it past its mini-GoP."""
    _, pkts, _ = _m2_gop()
    dec = tg.Decoder(device="cpu")
    key = pkts[0].recon
    refs = {}
    for p in pkts:
        slots = list(dec.slots)
        dec.decode_temporal_unit(p.data)
        if (p.frame_type != obu.INTER_FRAME
                or obu.OBU_FRAME not in [t for t, _ in obu.parse_obus(
                    p.data)]):
            continue
        fp = dec.last_frame_header
        hint = lambda e: fp.ref_hints[e - 1]
        refs[p.pts] = (hint(mv_pred.LAST_FRAME), hint(mv_pred.ALTREF_FRAME),
                       hint(mv_pred.GOLDEN_FRAME))
        g = fp.ref_frame_idx[mv_pred.GOLDEN_FRAME - 1]
        if g != fp.ref_frame_idx[mv_pred.LAST_FRAME - 1]:
            for k in "yuv":
                np.testing.assert_array_equal(slots[g][k].numpy(), key[k])
    # poc: (LAST, ALTREF, GOLDEN) order hints; an unused role maps to LAST
    assert refs == {2: (0, 0, 0), 1: (0, 2, 0), 4: (2, 2, 0), 3: (2, 4, 2)}


def test_m4_gop_levels3_golden_dpb():
    """Two 3-level mini-GoPs: each inter frame refers to the frames of
    its schedule (by order hint: the mids of a mini-GoP take its anchor
    as GOLDEN, the second base (poc 16) the first anchor, the key frame),
    TMVP is on, and every slot a frame refers to holds that reference's
    picture when the frame is decoded, so the DPB freed no slot that a
    role still names; byte-identical to the JAX stream, the port's
    decoder equal to the recon."""
    frames, pkts, jax = tg.stream_slice("m4_gop_levels3", SPEC3,
                                        decode=True)
    identical = [p.data for p in pkts] == jax["data"]
    recon = {p.pts: p.recon for p in pkts if p.displayed}
    assert sorted(recon) == list(range(len(frames)))
    dec = tg.Decoder(device="cpu")
    roles = (mv_pred.LAST_FRAME, mv_pred.ALTREF_FRAME, mv_pred.GOLDEN_FRAME)
    refs, tmvp, shown, blocks = {}, [], [], []
    for p in pkts:
        slots = list(dec.slots)
        shown += dec.decode_temporal_unit(p.data)
        if (p.frame_type != obu.INTER_FRAME
                or obu.OBU_FRAME not in [t for t, _ in obu.parse_obus(
                    p.data)]):
            continue
        fp = dec.last_frame_header
        refs[p.pts] = tuple(fp.ref_hints[e - 1] for e in roles)
        tmvp.append(fp.use_ref_frame_mvs)
        blocks += list(dec.last_decisions.values())
        for e, hint in zip(roles, refs[p.pts]):
            s = slots[fp.ref_frame_idx[e - 1]]
            for k in "yuv":
                np.testing.assert_array_equal(
                    s[k].numpy(), recon[hint][k],
                    err_msg=f"poc {p.pts} ref {e} (poc {hint}) {k}")
    for rec, p in zip(shown, [p for p in pkts if p.displayed]):
        for k in "yuv":
            np.testing.assert_array_equal(rec[k], p.recon[k],
                                          err_msg=f"poc {p.pts} {k}")
    golden = sum(b.is_inter and b.ref == mv_pred.GOLDEN_FRAME
                 for b in blocks)
    fault = sum(b.is_inter and (b.motion_mode == 1 or b.interintra_mode >= 0)
                and b.tx_type != cc.DCT_DCT and np.any(b.qcoeff_y)
                for b in blocks)
    jax_rt = all(np.array_equal(j[k], recon[i][k])
                 for i, j in enumerate(jax["decoded"]) for k in "yuv")
    print(f"M4 GOP 64x64 x17 levels 3: byte-identical {identical}; GOLDEN "
          f"blocks {golden}; refs (LAST, ALTREF, GOLDEN) {refs}; JAX "
          f"decoder equal {jax_rt} (blocks of the reference's decoder "
          f"fault {fault})")
    assert identical
    assert all(tmvp) and golden > 0
    assert refs == {8: (0, 0, 0), 4: (0, 8, 0), 2: (0, 4, 0), 1: (0, 2, 0),
                    3: (2, 4, 0), 6: (4, 8, 0), 5: (4, 6, 0), 7: (6, 8, 0),
                    16: (8, 8, 0), 12: (8, 16, 8), 10: (8, 12, 8),
                    9: (8, 10, 8), 11: (10, 12, 8), 14: (12, 16, 8),
                    13: (12, 14, 8), 15: (14, 16, 8)}
    if fault == 0:
        assert jax_rt


@pytest.mark.parametrize("preset", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("gop", [False, True])
def test_m0_m4_accepted(preset, gop):
    """Presets M0-M4 build on both routes: the filter-intra pseudo-modes
    join the MD modes (11 luma modes at M0-M2, 10 at M3-M4) and the
    sequence header announces filter-intra."""
    fields = (dict(intra_period_length=15, hierarchical_levels=3)
              if gop else {})
    enc = Encoder(EncoderConfig(source_width=64, source_height=64,
                                enc_mode=preset, **fields), device="cpu")
    assert len(enc._md_modes) == (16 if preset <= 2 else 15)
    assert enc.sp.enable_filter_intra and enc._feat.mref
    assert Counter(m >= cc.FI_MODE_BASE for m in enc._md_modes)[True] == 5
