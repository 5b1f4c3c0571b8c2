#!/usr/bin/env python3
"""Locate where the JAX package's GOP stream stops decoding to its own
recon (ROADMAP.md queue C item 4), read-only: nothing in svt_av1_tpu/
changes, the encoder's and the decoder's intermediate results are caught
by wrapping their functions.

    JAX_PLATFORMS=cpu python tools/roundtrip_fault.py [--preset 6]
        [--feat part8=0,tmvp=0] [--dlf 1] [--cdef 1] [--frames 6]
    JAX_PLATFORMS=cpu python tools/roundtrip_fault.py --clip NAME

Without --clip: encodes tests/clips.py ``fault_clip`` (64x64,
hierarchical_levels 2, intra_period_length 15, qp 35, MCTF on, TPL off)
and decodes it with svt_av1_tpu/codec/decoder.py.  Prints, per shown
frame, the pixels where the decoded frame differs from Packet.recon, then,
per inter frame in decode order, where the encoder's and the decoder's
views part:
  - the leaf decisions (block size, skip, tx type, motion mode, MVs,
    coefficients);
  - the pre-filter recon (P1's output against the decoder's
    reconstruction from its parsed decisions), per 16x16 block with its
    leaf (and an OBMC block's neighbours);
  - the skip maps the filters read (P2's skip16 against the decoder's
    ``_skip_map`` / ``_skip_map8``).
``--feat`` pins preset features through the reference's own A/B hook
(SVT_TPU_FEAT).

With --clip: one clip of the reference's failing round-trip tests, or
``fault`` / ``fault_notx`` (the fault clip with all M6 tools / with the
tx search off), at that test's setting, through both packages' encoders
on the CPU: whether the JAX stream decodes to its recon through the JAX
decoder and through the port's (which follows the specification where
the two differ), whether the port's stream decodes to its recon through
the port's decoder, and how many leaf blocks differ between the streams.
"""
import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))


def _clip_case(name):
    """(frames, EncoderConfig fields, tests/clips.py tool_setting name) of
    a clip: the reference test's clip and setting."""
    import clips
    m6 = dict(enc_mode=6, hierarchical_levels=2)
    fault = dict(m6, qp=35, intra_period_length=15, enable_dlf_flag=1,
                 cdef_level=1)
    wedge = dict(m6, qp=45, intra_period_length=31, enable_tf=0)
    return {
        "fault": (clips.fault_clip(), fault, None),
        "fault_notx": (clips.fault_clip(), fault, "m6_fault_notx"),
        "compound": (clips.blend_b_clip(), dict(qp=40, enc_mode=8,
                                            intra_period_length=16,
                                            hierarchical_levels=1), None),
        "merge32": (clips.square_clip(), dict(m6, qp=40, intra_period_length=31,
                                          enable_dlf_flag=1, cdef_level=1),
                    None),
        "wipe": (clips.wipe_clip(), wedge, None),
        "iris": (clips.iris_clip(), wedge, "iris"),
        "rect_h": (clips.two_motion_clip(True), dict(m6, qp=35,
                                          intra_period_length=-1), None),
        "rect_v": (clips.two_motion_clip(False), dict(m6, qp=35,
                                           intra_period_length=-1), None),
    }[name]


def _encode(enc, frames, setting, gop_fast):
    from clips import tool_setting
    with tool_setting(setting, enc, gop_fast):
        for f in frames:
            enc.send_picture(*f)
        enc.flush()
    pkts = []
    while (p := enc.get_packet()) is not None:
        pkts.append(p)
    return pkts


def _decodes(dec, pkts):
    """(shown frames equal Packet.recon, the coded frames' decisions)."""
    shown, coded = [], []
    for p in pkts:
        shown += dec.decode_temporal_unit(p.data)
        if dec.last_decisions is not None and (not coded or
                                               dec.last_decisions
                                               is not coded[-1]):
            coded.append(dec.last_decisions)
    want = [p.recon for p in pkts if p.displayed]
    ok = len(shown) == len(want) and all(
        np.array_equal(np.asarray(a[k]), np.asarray(b[k]))
        for a, b in zip(shown, want) for k in "yuv")
    return ok, coded


def _same_leaf(a, b):
    fields = ("bsize", "is_inter", "y_mode", "uv_mode", "ref", "ref2", "mv",
              "mv2", "use_warp", "comp_type", "wedge_idx", "wedge_sign",
              "tx_type", "motion_mode", "interintra_mode")
    return (b is not None and all(getattr(a, f) == getattr(b, f)
                                  for f in fields)
            and all(np.array_equal(getattr(a, q), getattr(b, q))
                    for q in ("qcoeff_y", "qcoeff_u", "qcoeff_v")))


def clip_summary(name):
    """One clip through both packages: the round trips and the blocks that
    differ (see the module docstring)."""
    from svt_av1_tpu.api.config import EncoderConfig as JConfig
    from svt_av1_tpu.api.encoder import Encoder as JEncoder
    from svt_av1_tpu.codec.decoder import Decoder as JDecoder
    from svt_av1_tpu.pipeline import gop_fast as jgf
    from svt_av1_tpu_torch.api.encoder import Encoder, EncoderConfig
    from svt_av1_tpu_torch.codec import constants as cc
    from svt_av1_tpu_torch.codec.decoder import Decoder
    from svt_av1_tpu_torch.pipeline import gop_fast as tgf
    frames, fields, setting = _clip_case(name)
    h, w = frames[0][0].shape
    jp = _encode(JEncoder(JConfig(source_width=w, source_height=h,
                                  **fields)), frames, setting, jgf)
    j_rt, _ = _decodes(JDecoder(), jp)
    jn_rt, j_dec = _decodes(Decoder(device="cpu"), jp)
    rect = sum(d.bsize in (cc.BLOCK_32X16, cc.BLOCK_16X32)
               for fr in j_dec for d in fr.values())
    line = (f"{name}: JAX stream round-trips through the JAX decoder: "
            f"{j_rt}, through the port's decoder: {jn_rt}; rect leaves in "
            f"it {rect}")
    try:
        enc = Encoder(EncoderConfig(source_width=w, source_height=h,
                                    **fields), device="cpu")
    except NotImplementedError as e:
        print(f"{line}; the port refuses the setting: {e}")
        return
    pp = _encode(enc, frames, setting, tgf)
    p_rt, p_dec = _decodes(Decoder(device="cpu"), pp)
    tot = sum(len(fr) for fr in p_dec)
    same = sum(_same_leaf(d, fj.get(k)) for fp, fj in zip(p_dec, j_dec)
               for k, d in fp.items())
    print(f"{line}; the port's stream round-trips through the port's "
          f"decoder: {p_rt}; streams identical: "
          f"{[p.data for p in pp] == [p.data for p in jp]}; leaf blocks "
          f"differing {tot - same} of {tot}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--clip", default=None,
                    help="fault, fault_notx, compound, merge32, wipe, iris, "
                         "rect_h, rect_v")
    ap.add_argument("--preset", type=int, default=6)
    ap.add_argument("--feat", default="")
    ap.add_argument("--dlf", type=int, default=1)
    ap.add_argument("--cdef", type=int, default=1)
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--tf", type=int, default=1)
    args = ap.parse_args()
    if args.feat:
        os.environ["SVT_TPU_FEAT"] = args.feat
    if args.clip:
        for name in args.clip.split(","):
            clip_summary(name)
        return 0
    from clips import fault_clip
    from svt_av1_tpu.api.config import EncoderConfig
    from svt_av1_tpu.api import encoder as enc_mod
    from svt_av1_tpu.codec import decoder as dec_mod
    from svt_av1_tpu.pipeline import gop_fast, inter_encoder

    frames = fault_clip(args.frames)
    h, w = frames[0][0].shape
    cfg = EncoderConfig(source_width=w, source_height=h, qp=35,
                        intra_period_length=15, hierarchical_levels=2,
                        enc_mode=args.preset, enable_dlf_flag=args.dlf,
                        cdef_level=args.cdef, enable_tf=args.tf)
    enc_log = []
    orig_collect = gop_fast.collect_inter_frame

    def collect(pend, *a, **k):
        out = orig_collect(pend, *a, **k)
        enc_log.append((pend, out[0]))
        return out

    gop_fast.collect_inter_frame = collect
    enc = enc_mod.Encoder(cfg)
    for i, (y, u, v) in enumerate(frames):
        enc.send_picture(y, u, v, eos=(i == len(frames) - 1))
    pkts = []
    while True:
        p = enc.get_packet()
        if p is None:
            break
        pkts.append(p)

    dec_log = []
    orig_recon = inter_encoder.reconstruct_inter_from_decisions

    def recon(decisions, *a, **k):
        out = orig_recon(decisions, *a, **k)
        dec_log.append(dict(decisions=decisions,
                            pre={c: np.asarray(out[c]).copy()
                                 for c in "yuv"}))
        return out

    inter_encoder.reconstruct_inter_from_decisions = recon
    dec = dec_mod.Decoder()
    shown = []
    for p in pkts:
        for rec in dec.decode_temporal_unit(p.data):
            shown.append(rec)
    recons = [p.recon for p in pkts if p.recon is not None]
    print(f"preset M{args.preset} feat={args.feat or '-'} dlf={args.dlf} "
          f"cdef={args.cdef}: {len(shown)} shown, {len(recons)} recons")
    for i, (r, d) in enumerate(zip(recons, shown)):
        diff = tuple(int((np.asarray(r[c]).astype(int)
                          != np.asarray(d[c]).astype(int)).sum())
                     for c in "yuv")
        print(f"  shown frame {i}: differing pixels (y, u, v) = {diff}")

    fields = ("bsize", "skip", "is_inter", "tx_type", "motion_mode",
              "interintra_mode", "mv", "ref", "ref2", "mv2", "comp_type",
              "y_mode", "uv_mode")
    gh, gw = h // 16, w // 16
    for fi, ((pend, edec), dl) in enumerate(zip(enc_log, dec_log)):
        ddec = dl["decisions"]
        print(f"inter frame {fi} (decode order):")
        if set(edec) != set(ddec):
            print("  leaf keys differ:", sorted(set(edec) ^ set(ddec)))
        nd = 0
        for key in sorted(edec):
            if key not in ddec:
                continue
            a, b = edec[key], ddec[key]
            bad = [f for f in fields
                   if getattr(a, f, None) != getattr(b, f, None)]
            for q in ("qcoeff_y", "qcoeff_u", "qcoeff_v"):
                if not np.array_equal(np.asarray(getattr(a, q)),
                                      np.asarray(getattr(b, q))):
                    bad.append(q)
            if bad:
                nd += 1
                print(f"  leaf {key}: " + ", ".join(
                    f"{f} enc={getattr(a, f, None)!r:.40} "
                    f"dec={getattr(b, f, None)!r:.40}" for f in bad))
        print(f"  {nd} leaves differ")
        pre = [np.asarray(pend.outs[k]).astype(int) for k in range(3)]
        for c, e in zip("yuv", pre):
            bad = e != dl["pre"][c].astype(int)
            print(f"  pre-filter {c}: {int(bad.sum())} pixels differ")
            if c != "y":
                continue
            for by, bx in sorted({(r // 16, q // 16)
                                  for r, q in zip(*np.nonzero(bad))}):
                d = edec[(by * 4, bx * 4)]
                print(f"    16x16 block ({by},{bx}): "
                      f"{int(bad[by * 16:by * 16 + 16, bx * 16:bx * 16 + 16].sum())}"
                      f" pixels; leaf bsize={d.bsize} skip={d.skip} "
                      f"tx_type={d.tx_type} motion_mode={d.motion_mode} "
                      f"interintra_mode={d.interintra_mode} "
                      f"luma coeffs={int(np.count_nonzero(d.qcoeff_y))}")
                if d.motion_mode:
                    # the neighbours an OBMC blend reads (spec 7.11.3.10:
                    # per 8-px segment of the above row / left column)
                    for side, key in (("above", (by * 4 - 4, bx * 4)),
                                      ("left", (by * 4, bx * 4 - 4))):
                        nd = edec.get(key)
                        if nd is not None:
                            print(f"      {side} neighbour: bsize="
                                  f"{nd.bsize} inter={nd.is_inter} "
                                  f"mv={nd.mv}")
        qy, qu, qv = (np.asarray(pend.outs[k]) for k in (15, 16, 17))
        skip16 = ((np.abs(qy).max(1) == 0) & (np.abs(qu).max(1) == 0)
                  & (np.abs(qv).max(1) == 0)).reshape(gh, gw)
        dskip16 = enc_mod._skip_map(ddec, gh, gw)
        dskip8 = enc_mod._skip_map8(ddec, 2 * gh, 2 * gw)
        choose = np.asarray(pend.outs[5]).reshape(gh, gw)
        iskip = np.asarray(pend.outs[6]).reshape(gh, gw)
        itx = np.asarray(pend.outs[24]).reshape(gh, gw)
        iobmc = np.asarray(pend.outs[13]).reshape(gh, gw)
        iim = np.asarray(pend.outs[14]).reshape(gh, gw)
        split = np.asarray(pend.outs[25]).reshape(gh, gw)
        e8 = np.repeat(np.repeat(skip16, 2, 0), 2, 1)
        print(f"  P2 skip16 vs decoder skip16: "
              f"{int((skip16 != dskip16).sum())} cells; split leaves "
              f"{int(split.sum())}; skip8 (unsplit cells): "
              f"{int(((e8 != dskip8) & ~np.repeat(np.repeat(split, 2, 0), 2, 1)).sum())}")
        for by in range(gh):
            for bx in range(gw):
                flag = (skip16[by, bx] != dskip16[by, bx]
                        or iskip[by, bx] != skip16[by, bx])
                if flag and choose[by, bx]:
                    print(f"    block ({by},{bx}): P2 skip16="
                          f"{bool(skip16[by, bx])} iskip="
                          f"{bool(iskip[by, bx])} dec skip="
                          f"{bool(dskip16[by, bx])} itx={int(itx[by, bx])}"
                          f" obmc={bool(iobmc[by, bx])} ii="
                          f"{int(iim[by, bx])} split={bool(split[by, bx])}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
