"""Multi-stream encoding on one GPU: N independent streams run through one
batched program per step.

The port of svt_av1_tpu/parallel/multistream.py.  The reference shards a
stream batch over a device mesh: jax.vmap of the frame program and of
one inter frame's P1 + P2, one stream per device.  On one H100 the
counterpart is a stream axis folded into the block axis of the stages
(pipeline/gop_fast.run_inter_frames, intra_encoder.frame_program; the GM
fit, the warp and the wedge pick's matmul still loop over the streams):
one HME level, one pass-B wave, one DLF ladder step or one CDEF
candidate is one set of launches for all N streams, and each stream's
quantizer, lambda and rate tables are read per block through the
block's stream index; the luma wave step's K1 takes one quantizer row
per stream (ops/fused_txq.fused_txq_rows).  Each stream's result equals
what the one-stream path gives that stream.  The stream count is any
N >= 1 (the reference needs a multiple of its mesh).

The JAX functions and their counterparts here (svt_av1_tpu/parallel/
multistream.py):

  make_mesh (:25)                         no counterpart: ``device``
  _sharded_frame_program (:31),           encode_intra_frames_batched
  encode_intra_frames_sharded (:52)
  demo_multi_stream (:81)                 demo_multi_stream
  _sharded_inter_step (:101-155),         run_inter_frames_batched
  run_inter_frames_sharded (:158-237)
  demo_gop_streams (:240-298)             demo_gop_streams (over
                                          encode_gop_streams)

As in the reference, the inter step evaluates the compound pairs where a
frame has exactly two references (``compound = R == 2``, :121-122),
whichever they are; one-stream encodes decide from ALTREF's presence
(gop_fast.run_inter_frame).
"""
from __future__ import annotations

import time
from typing import List, Sequence, Tuple

import numpy as np

from svt_av1_tpu_torch import device as device_mod
from svt_av1_tpu_torch.codec import mv_pred
from svt_av1_tpu_torch.pipeline import cdef_stage
from svt_av1_tpu_torch.pipeline import gop_fast as gf
from svt_av1_tpu_torch.pipeline import intra_encoder as ie


def encode_intra_frames_batched(frames: List[Tuple], qindex,
                                modes=ie.ALL_MODES, device=None):
    """Multi-stream all-intra encode of frames = [(y, u, v), ...] (one per
    stream, same dims) on ``device`` (default: the current CUDA device).
    qindex: one for every frame, as the reference takes it, or a sequence
    with one per frame (each stream at its own quantizer).  Returns
    [(decisions, recon)] per frame: per-block BlockDecisions and dict(y,
    u, v) recon tensors left on the device."""
    return ie.encode_intra_frames_finish(
        _intra_launch(frames, qindex, modes, device), as_arrays=False)


def _intra_launch(frames, qindex, modes, device):
    """Enqueue encode_intra_frames_batched's frame program; returns the
    pending batch for ie.encode_intra_frames_finish."""
    n = len(frames)
    qs = ([int(qindex)] * n if np.ndim(qindex) == 0
          else [int(q) for q in qindex])
    if len(qs) != n:
        raise ValueError(f"{len(qs)} qindices for {n} frames")
    if len(set(qs)) == 1:
        return ie.encode_intra_frames_launch(frames, qs[0], tuple(modes),
                                             device=device)
    h, w = frames[0][0].shape
    ie._check_slice(modes, 8, h, w)
    dev = device_mod.resolve(device)
    qp, lam, rt = ie.stream_params(
        qs, lambda q: ie._rate_args(q, tuple(modes), False, dev), dev)
    planes = ie.source_planes([np.stack([f[p] for f in frames])
                               for p in range(3)], 8, dev)
    out = ie.frame_program(*planes, qp, lam, rt, tuple(modes))
    return (out, h // ie.BLK, w // ie.BLK, n)


def demo_multi_stream(n_streams: int, height: int = 64, width: int = 64,
                      qindex: int = 140, device=None):
    """One multi-stream all-intra step on random frames (the reference's
    demo, same seed)."""
    rng = np.random.default_rng(0)
    frames = []
    for _ in range(n_streams):
        y = rng.integers(0, 256, (height, width)).astype(np.uint8)
        u = rng.integers(0, 256, (height // 2, width // 2)).astype(np.uint8)
        v = rng.integers(0, 256, (height // 2, width // 2)).astype(np.uint8)
        frames.append((y, u, v))
    return encode_intra_frames_batched(frames, qindex, device=device)


def run_inter_frames_batched(src_packs, refs_per_stream, qindices, modes,
                             bd: int = 8, ring: bool = True, rad2: int = 8,
                             rad0: int = 7, cdef_cands=None,
                             dlf_on: bool = True, cdef_on: bool = True,
                             exact_rates: bool = False, hp: bool = False,
                             obmc: bool = False, interintra: bool = False,
                             skip_mode: bool = False,
                             tx_search: bool = False, split8: bool = False,
                             device=None) -> List[gf.PendingInterFrame]:
    """One inter frame for each of N independent GOP streams, as one
    batched P1 + P2 on ``device`` (default: the current CUDA device).
    src_packs: [(H + H/2, W) uint8], luma above U|V; refs_per_stream:
    [{ref_enum: dict(y, u, v)}] with the same reference enums in every
    stream (the same GOP position); qindices: one per stream.  Returns a
    PendingInterFrame per stream; finish each with
    gop_fast.collect_inter_frame (one host copy serves the batch)."""
    h = src_packs[0].shape[0] * 2 // 3
    w = src_packs[0].shape[1]
    R = len(refs_per_stream[0])
    return gf.run_inter_frames(
        src_packs, refs_per_stream, qindices, h, w, tuple(modes), bd, ring,
        rad2, rad0, cdef_cands, dlf_on, cdef_on, hp, obmc, interintra,
        exact_rates, R == 2, skip_mode and R == 2, tx_search, split8,
        device)


def encode_gop_streams(streams: Sequence[Sequence[Tuple]], key_qindex,
                       inter_qindices, device=None, key_modes=ie.ALL_MODES,
                       **inter_kw):
    """N independent GOP streams, each 1 + n_inter frames [(y, u, v)]:
    the key frames as one batched step (key_qindex: one, or one per
    stream), then one batched inter step per frame index, with
    inter_qindices[t - 1] the streams' qindices at step t: step 1 a P
    frame from LAST (the key), step 2 (when there is a third frame) a
    compound B frame from LAST (the key) and ALTREF (step 1), later steps
    a P frame from the previous one.  Recon stays on the device between
    steps.  key_modes: the key frames' luma modes; inter_kw:
    run_inter_frames_batched's options.  Returns per-stream lists of
    (decisions, recon), per-stream lists of the inter frames' headers and
    each step's (dispatch, wall) seconds: the host time until the step's
    programs are issued, and until its decisions are on the host."""
    n_inter = len(streams[0]) - 1
    t0 = time.perf_counter()
    pending = _intra_launch([st[0] for st in streams], key_qindex, key_modes,
                            device)
    t1 = time.perf_counter()
    keys = ie.encode_intra_frames_finish(pending, as_arrays=False)
    timings = [(t1 - t0, time.perf_counter() - t0)]
    results = [[kr] for kr in keys]
    headers = [[] for _ in streams]
    dpb = [{mv_pred.LAST_FRAME: dict(kr[1])} for kr in keys]
    for t in range(1, 1 + n_inter):
        src_packs = []
        for st in streams:
            y, u, v = st[t]
            src_packs.append(np.concatenate(
                [y, np.concatenate([u, v], axis=1)], axis=0))
        t0 = time.perf_counter()
        pends = run_inter_frames_batched(src_packs, dpb,
                                         inter_qindices[t - 1],
                                         device=device, **inter_kw)
        t1 = time.perf_counter()
        for s, pend in enumerate(pends):
            decisions, recon, hdr = gf.collect_inter_frame(pend)
            results[s].append((decisions, recon))
            headers[s].append(hdr)
            planes = {k: recon[k] for k in ("y", "u", "v")}
            if t == 1 and n_inter > 1:
                dpb[s] = {mv_pred.LAST_FRAME: dpb[s][mv_pred.LAST_FRAME],
                          mv_pred.ALTREF_FRAME: planes}
            else:
                dpb[s] = {mv_pred.LAST_FRAME: planes}
        timings.append((t1 - t0, time.perf_counter() - t0))
    return results, headers, timings


def demo_streams(n_streams: int, height: int = 64, width: int = 64,
                 n_inter: int = 2):
    """The reference demo's N streams: a smoothed random texture, each
    stream a window of it shifted by 4 px per stream and 1 px per frame."""
    rng = np.random.default_rng(7)
    base = rng.integers(20, 235, (height, width + 8 * n_streams)
                        ).astype(np.uint8)
    k = np.ones((3, 3)) / 9.0
    from numpy.lib.stride_tricks import sliding_window_view
    sm = sliding_window_view(base.astype(np.float32), (3, 3))
    base = sm.reshape(*sm.shape[:2], 9).dot(k.reshape(9)).astype(np.uint8)
    streams = []
    for s in range(n_streams):
        frames = []
        for t in range(1 + n_inter):
            y = base[:height - 2, s * 4 + t:s * 4 + t + width].copy()
            y = np.pad(y, ((0, 2), (0, 0)), mode="edge")
            u = (y[::2, ::2] // 2 + 60).astype(np.uint8)
            v = np.full((height // 2, width // 2), 128, np.uint8)
            frames.append((y, u, v))
        streams.append(frames)
    return streams


def demo_gop_streams(n_streams: int, height: int = 64, width: int = 64,
                     qindex: int = 120, device=None, n_inter: int = 2):
    """The reference's demo: N GOP streams (demo_streams), batched intra
    keys at ``qindex``, then n_inter batched inter steps (a P step, then a
    compound B step) with DLF + CDEF, stream s at step t coded at qindex +
    8 * ((s + t) % 3), at the reference demo's reduced search effort.
    Returns per-stream lists of (decisions, recon)."""
    streams = demo_streams(n_streams, height, width, n_inter)
    qs = [[qindex + 8 * ((s + t) % 3) for s in range(n_streams)]
          for t in range(1, 1 + n_inter)]
    results, _, _ = encode_gop_streams(
        streams, qindex, qs, device=device, modes=ie.MODES[:2], ring=False,
        rad2=4, rad0=2, cdef_cands=cdef_stage.SEARCH_SET[:2])
    return results
