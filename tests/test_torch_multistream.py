"""The port's multi-stream encoding (svt_av1_tpu_torch/parallel/
multistream.py) against the JAX package's svt_av1_tpu/parallel/
multistream.py on the CPU, at 64x64 with S = 4 streams.

- (a) encode_intra_frames_batched against encode_intra_frames_sharded:
  y modes, levels and recon, exact; with one qindex per stream, each
  stream equals its own one-frame encode.
- (b)-(d) run_inter_frames_batched against run_inter_frames_sharded at
  qindices 100 + 10 * s: the JAX test's inputs with one reference
  (LAST); LAST + ALTREF on inputs that compound pairs win (the skip-mode
  pair, exact rates); the M6 tools (OBMC, inter-intra, tx search, 8x8
  split) on the natural clip, whose streams filter at their own DLF
  levels.  P1 by the parity
  rule of tests/test_torch_gop.py::test_p1_matches_jax (>= 99% of blocks
  equal, the GM model and interp pick equal; forward-transform ties
  counted and printed), recon and P2 exact where every block agrees.
- (e) demo_gop_streams(4) against the JAX demo, frame by frame.
- (f) every batched stream bit for bit equal to its one-stream encode
  (gop_fast.run_inter_frame, the demo's sequence alone).
- (g) the per-stream quantizer (StreamQuant), K1's per-row plain twin and
  the stacked rate tables against their one-stream forms.

The JAX outputs are stored in tests/golden/torch_port_refs.npz (see
tests/port_refs.py); recording runs the JAX module on the conftest's 8
virtual CPU devices with make_mesh(4).
"""
import functools

import numpy as np
import pytest
import torch

import clips
import port_refs
from svt_av1_tpu_torch.codec import constants as cc
from svt_av1_tpu_torch.codec import mv_pred
from svt_av1_tpu_torch.codec.rate_est import md_rate_args, stack_rate_args
from svt_av1_tpu_torch.ops import fused_txq, quant
from svt_av1_tpu_torch.ops import transforms as tf
from svt_av1_tpu_torch.parallel import multistream as ms
from svt_av1_tpu_torch.pipeline import gop_fast as tgf
from svt_av1_tpu_torch.pipeline import intra_encoder as tie
from test_torch_gop import BLOCK_FIELDS, P1_OUT

torch.set_num_threads(2)
CPU = torch.device("cpu")
NS = 4
MODES = tie.MODES[:4]
H = W = 64
INTER = {
    # name: (inputs, run_inter_frames_*'s options)
    "r1": ("shift", {}),
    "r2": ("average", dict(exact_rates=True, skip_mode=True)),
    "m6": ("natural", dict(obmc=True, interintra=True, tx_search=True,
                           split8=True)),
}
DEC_FIELDS = ("r4", "c4", "bsize", "y_mode", "uv_mode", "tx_type",
              "is_inter", "ref", "ref2", "use_warp", "comp_type",
              "wedge_idx", "wedge_sign", "motion_mode", "interintra_mode",
              "angle_delta_y", "filter_intra_mode", "cfl_alpha_u",
              "cfl_alpha_v")


def _jms():
    from svt_av1_tpu.parallel import multistream as jms
    return jms, jms.make_mesh(NS)


def _table(decisions):
    """(blocks, fields) int64 decision table in raster key order and the
    concatenated levels of every block."""
    rows, coefs = [], []
    for k in sorted(decisions):
        d = decisions[k]
        rows.append([int(getattr(d, f)) for f in DEC_FIELDS]
                    + [int(x) for x in d.mv] + [int(x) for x in d.mv2])
        coefs += [np.asarray(c).ravel() for c in
                  (d.qcoeff_y, d.qcoeff_u, d.qcoeff_v)]
    return np.asarray(rows, np.int64), np.concatenate(coefs).astype(np.int64)


def _host(a):
    """A recon plane as a host array (a tensor on any device, or an
    array)."""
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _flat(results):
    """Per-frame results [(decisions, recon)] as arrays: recon y/u/v
    stacked, then each frame's decision table and levels."""
    out = [np.stack([_host(r[1][p]) for r in results]) for p in "yuv"]
    for dec, _ in results:
        out += list(_table(dec))
    return out


# ------------------------------------------------------------ (a) intra ---

def _synth_frame(w, h, seed=0):
    """tests/test_e2e_intra.py's synth_frame (the JAX test's frames), kept
    here so that the file imports nothing of JAX where the card runs its
    cases (chip_smoke.py phase 43)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    y = (96 + 60 * np.sin(xx / 17.0) + 50 * np.cos(yy / 23.0)
         + rng.integers(-6, 7, (h, w)))
    y[h // 3:h // 2, :] = 200
    y[:, w // 4:w // 4 + 6] = 30
    y = np.clip(y, 0, 255).astype(np.uint8)
    u = np.clip(128 + 40 * np.sin(xx[::2, ::2] / 31.0), 0,
                255).astype(np.uint8)
    v = np.clip(128 + 40 * np.cos(yy[::2, ::2] / 29.0), 0,
                255).astype(np.uint8)
    return y, u, v


def _intra_frames():
    return [_synth_frame(W, H, seed=i) for i in range(NS)]


@functools.lru_cache(maxsize=None)
def _intra_pair():
    frames = _intra_frames()

    def jax_run():
        jms, mesh = _jms()
        return _flat(jms.encode_intra_frames_sharded(frames, 140, mesh))

    ref = port_refs.jax_ref("multistream_intra", jax_run,
                            *[p for f in frames for p in f])
    got = _flat(ms.encode_intra_frames_batched(frames, 140, device=CPU))
    return got, ref


def test_intra_batched_matches_jax():
    got, ref = _intra_pair()
    assert len(got) == len(ref)
    for i, (a, b) in enumerate(zip(got, ref)):
        np.testing.assert_array_equal(a, b, err_msg=f"output {i}")


def test_intra_per_stream_qindex_matches_alone():
    """One qindex per stream: the frame program with a StreamQuant (K1's
    per-row form) equals each frame encoded alone at its qindex."""
    frames = _intra_frames()
    qs = [100, 115, 130, 145]
    got = ms.encode_intra_frames_batched(frames, qs, device=CPU)
    for s in (0, 3):
        alone = ms.encode_intra_frames_batched([frames[s]], qs[s],
                                               device=CPU)
        for a, b in zip(_flat([got[s]]), _flat(alone)):
            np.testing.assert_array_equal(a, b, err_msg=f"stream {s}")


# ------------------------------------------------------- (b)-(d) inter ---

def _inter_inputs(kind):
    """(sources, references, qindices) of the S streams.  "shift": the
    JAX test's inputs (tests/test_multistream.py): stream s codes a window
    of a random texture from the window one pixel left (LAST);
    "average": the texture smoothed, ALTREF the window one pixel right
    and the source their average plus noise, so that compound pairs win;
    "natural": frame 2 of the natural clip (seed 1 + s) from frames 1
    (LAST) and 3 (ALTREF)."""
    qs = [100 + 10 * s for s in range(NS)]
    if kind == "natural":
        srcs, refs = [], []
        for s in range(NS):
            fr = clips.natural_clip(4, W, H, seed=1 + s)
            y, u, v = fr[2]
            srcs.append(np.concatenate([y, np.concatenate([u, v], 1)], 0))
            refs.append({mv_pred.LAST_FRAME: dict(zip("yuv", fr[1])),
                         mv_pred.ALTREF_FRAME: dict(zip("yuv", fr[3]))})
        return srcs, refs, qs
    R = 1 if kind == "shift" else 2
    rng = np.random.default_rng(3)
    base = rng.integers(20, 235, (H, W + 64)).astype(np.uint8)
    if R == 2:
        k = np.ones(3, np.float32) / 3
        sm = base.astype(np.float32)
        sm = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, sm)
        base = np.clip(sm, 0, 255).astype(np.uint8)
    srcs, refs = [], []
    for s in range(NS):
        ref_y = base[:, s * 2:s * 2 + W].copy()
        src_y = base[:, s * 2 + 1:s * 2 + 1 + W].copy()
        u = np.full((H // 2, W // 2), 100 + s, np.uint8)
        r = {mv_pred.LAST_FRAME: dict(y=ref_y, u=u.copy(), v=u.copy())}
        if R == 2:
            alt_y = base[:, s * 2 + 2:s * 2 + 2 + W].copy()
            avg = (ref_y.astype(np.int32) + alt_y + 1) // 2
            src_y = np.clip(avg + rng.integers(-3, 4, avg.shape), 0,
                            255).astype(np.uint8)
            v = (u + 10 * s).astype(np.uint8)
            r[mv_pred.ALTREF_FRAME] = dict(y=alt_y, u=u.copy(), v=v)
        refs.append(r)
        srcs.append(np.concatenate(
            [src_y, np.concatenate([u, u], axis=1)], axis=0))
    return srcs, refs, qs


def _stacked(pends):
    """Each of a batch's P1 (30) and P2 (6) outputs stacked over streams."""
    n1 = len(pends[0].outs)
    out = []
    for k in range(n1 + len(pends[0].p2_outs)):
        get = ((lambda p: p.outs[k]) if k < n1
               else (lambda p: p.p2_outs[k - n1]))
        out.append(np.stack([np.asarray(get(p)) for p in pends]))
    return out


@functools.lru_cache(maxsize=None)
def _inter_case(name):
    kind, kw = INTER[name]
    srcs, refs, qs = _inter_inputs(kind)

    def jax_run():
        jms, mesh = _jms()
        return _stacked(jms.run_inter_frames_sharded(srcs, refs, qs, mesh,
                                                     modes=MODES, **kw))

    ref = port_refs.jax_ref(
        f"multistream_inter_{name}", jax_run, *srcs,
        *[r[e][p] for r in refs for e in sorted(r) for p in "yuv"],
        np.asarray(qs), np.asarray(sorted(kw)))
    pends = ms.run_inter_frames_batched(srcs, refs, qs, MODES, device=CPU,
                                        **kw)
    return srcs, refs, qs, pends, ref


@pytest.mark.parametrize("name", list(INTER))
def test_inter_batched_matches_jax(name):
    _, _, qs, pends, ref = _inter_case(name)
    got = [o.numpy() for o in _stacked_t(pends)]
    n1 = len(P1_OUT)
    for s in range(NS):
        o = {k: got[i][s] for i, k in enumerate(P1_OUT)}
        r = {k: ref[i][s] for i, k in enumerate(P1_OUT)}
        nb = o["choose"].shape[0]
        same = np.ones(nb, bool)
        for k in BLOCK_FIELDS:
            same &= (o[k].reshape(nb, -1).astype(np.int64)
                     == r[k].reshape(nb, -1).astype(np.int64)).all(axis=1)
        agree = same.mean()
        print(f"{name} stream {s} (qindex {qs[s]}): {agree:.2%} of {nb} "
              f"blocks equal ({nb - int(same.sum())} ties); inter "
              f"{int(o['choose'].sum())}, compound {int(o['comp'].sum())}, "
              f"split {int(o['split'].sum())}, obmc {int(o['obmc'].sum())}, "
              f"ii {int((o['ii'] >= 0).sum())}, DLF levels "
              f"{got[n1 + 3][s].tolist()}, CDEF pick {int(got[n1 + 5][s])}")
        assert agree >= 0.99
        for k in ("gm_mats", "gm_trans", "gm_kinds", "interp"):
            np.testing.assert_array_equal(o[k], r[k], err_msg=k)
        if agree == 1.0:
            for k in P1_OUT:
                np.testing.assert_array_equal(o[k], r[k], err_msg=k)
            for i in (0, 1, 2, 3, 5):
                np.testing.assert_array_equal(got[n1 + i][s], ref[n1 + i][s])
            # per-SB CDEF SSEs: exact integers here, float32 sums there
            assert ref[n1 + 4][s].max() < 2 ** 24
            np.testing.assert_array_equal(
                got[n1 + 4][s].astype(np.float64),
                ref[n1 + 4][s].astype(np.float64))
    if name != "r1":
        assert got[P1_OUT.index("comp")].any()


def _stacked_t(pends):
    n1 = len(pends[0].outs)
    return [torch.stack([(p.outs[k] if k < n1 else p.p2_outs[k - n1])
                         for p in pends])
            for k in range(n1 + len(pends[0].p2_outs))]


@pytest.mark.parametrize("name", list(INTER))
def test_inter_batched_equals_run_inter_frame(name):
    """(f) Each batched stream equals gop_fast.run_inter_frame of the same
    stream, every P1 and P2 output and the collected decisions."""
    srcs, refs, qs, pends, _ = _inter_case(name)
    _, kw = INTER[name]
    for s in (range(NS) if name != "m6" else (0, 3)):
        one = tgf.run_inter_frame(srcs[s], refs[s], qs[s], H, W, MODES,
                                  device=CPU, **kw)
        for i, (a, b) in enumerate(zip(pends[s].outs + pends[s].p2_outs,
                                       one.outs + one.p2_outs)):
            assert torch.equal(a, b), (name, s, i)
        d1, _, h1 = tgf.collect_inter_frame(pends[s])
        d2, _, h2 = tgf.collect_inter_frame(one)
        assert h1 == h2
        for a, b in zip(_table(d1), _table(d2)):
            np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------- (e) demo ---

@functools.lru_cache(maxsize=None)
def _demo_pair():
    def jax_run():
        jms, _ = _jms()
        res = jms.demo_gop_streams(NS)
        return [a for st in res for a in _flat(st)]

    streams = ms.demo_streams(NS)
    ref = port_refs.jax_ref("multistream_demo_gop", jax_run,
                            *[p for st in streams for f in st for p in f])
    res = ms.demo_gop_streams(NS, device=CPU)
    return streams, res, ref


def test_demo_gop_streams_matches_jax():
    _, res, ref = _demo_pair()
    got = [a for st in res for a in _flat(st)]
    assert len(got) == len(ref)
    for i, (a, b) in enumerate(zip(got, ref)):
        np.testing.assert_array_equal(a, b, err_msg=f"output {i}")
    inter = sum(d.is_inter for st in res for dec, _ in st
                for d in dec.values())
    print(f"demo: {NS} streams x 3 frames equal; inter blocks {inter}")


def test_demo_gop_streams_equal_alone():
    """(f) Streams 0 and 3 of the demo, encoded alone (S = 1) through the
    same sequence, equal their batched encodes."""
    streams, res, _ = _demo_pair()
    for s in (0, 3):
        qs = [[120 + 8 * ((s + t) % 3)] for t in (1, 2)]
        alone, _, _ = ms.encode_gop_streams(
            [streams[s]], 120, qs, device=CPU, modes=tie.MODES[:2],
            ring=False, rad2=4, rad0=2,
            cdef_cands=tgf.cdef_stage.SEARCH_SET[:2])
        for a, b in zip(_flat(res[s]), _flat(alone[0])):
            np.testing.assert_array_equal(a, b, err_msg=f"stream {s}")


# ------------------------------------------------- (g) per-stream tables ---

def test_stream_quantizer_and_k1_rows_twin():
    """StreamQuant rows, K1's per-row plain twin and the stacked rate
    tables give each block what its stream's one-stream form gives it, at
    qindices across 1-255 (both q-context bands) and on flat blocks that
    saturate the quantizer's int16 clamp."""
    qs = [1, 100, 121, 255]
    rng = np.random.default_rng(11)
    b = 24
    resid = rng.integers(-255, 256, (NS * b, 16, 16)).astype(np.int32)
    resid[::b] = 255                  # flat blocks: a DC past the clamp
    resid[1::b] = -255
    resid_t = torch.from_numpy(resid)
    sid = torch.arange(NS).repeat_interleave(b)
    sq = quant.StreamQuant(quant.stream_table(qs, CPU), sid)
    got = fused_txq.fused_txq_rows(resid_t, sq)
    coeffs = tf.fwd_txfm2d(resid_t, cc.DCT_DCT, cc.TX_16X16)
    q_rows, dq_rows = quant.quantize(coeffs, sq, cc.TX_16X16)
    assert int(coeffs.abs().max()) + 1000 > 32767   # past the clamp
    for s, q in enumerate(qs):
        sl = slice(s * b, (s + 1) * b)
        want = fused_txq.fused_txq_plain(resid_t[sl],
                                         quant.params_on(q, CPU))
        for a, w in zip(got, want):
            assert torch.equal(a[sl], w)
        assert torch.equal(q_rows[sl], want[1])
        assert torch.equal(dq_rows[sl], want[2])
    # the stacked rate tables read per block equal each stream's own
    pos = tie._scan_pos_on(cc.TX_16X16, CPU)
    for exact in (False, True):
        rts = [md_rate_args(q, MODES, tie.UV_MODES, inter_frame=True,
                            exact=exact, device=CPU) for q in qs]
        st = stack_rate_args(rts)
        bits = tie._txb_bits(got[1].abs(), st[0], st[2][0], st[5], pos, sid)
        for s in range(NS):
            sl = slice(s * b, (s + 1) * b)
            one = tie._txb_bits(got[1][sl].abs(), rts[s][0], rts[s][2][0],
                                rts[s][5], pos)
            assert torch.equal(bits[sl], one), (exact, s)
