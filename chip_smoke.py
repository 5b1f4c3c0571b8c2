#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (svt_av1_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, one line each (ending with the seconds since the start); any
failure raises and exits non-zero.  Phases 27 and 26 (this slice) run
right after phase 4, in a fresh process; the rest in order:
  1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
     exits non-zero without CUDA;
  2. build of the CUDA kernels from svt_av1_tpu_torch/csrc (nvcc, sm_90a)
     into build/kernels/;
  3. the fused transform+quantize kernel (K1) on the card, at every batch
     size B that the paths below give it (frames in one program x wave
     slots x luma modes, k1_batches: 528 and 480 for M10 send_pictures at
     CIF x8 and 720p x2, 704 and 640 for M6; 66, 44 and 240 for a
     send_picture key frame or the pass B of one inter frame at CIF M10,
     CIF M12 and 720p M10; 18, 12, 18 and 24 for phase 20's small GOPs;
     88 for pass B at CIF M6, 16 and 32 for phase 27's), qindex 140 and
     255: bit-identical to the first kernel (svt_fused_txq16_v1, kept in
     the same source), the tie rule below against the plain PyTorch
     version, qcoeff/dqcoeff exact on its own coefficients; at each size
     the device time per launch of the kernel, the first kernel and the
     plain version (a CUDA graph of 20 launches on preallocated outputs,
     replayed 50 times between two CUDA events; three rounds in turns)
     beside the launch's bytes, FLOP and bound, and the host time of one
     wrapper call; then the two kernels at B = 135168, a batch far beyond
     the L2 (bound by device memory);
  4. the inverse transform and the DC/V/H/SMOOTH/PAETH predictors on the
     card against the C-reference goldens in tests/golden/ (bit-exact);
  5. the all-intra batch: CIF 352x288, 8 frames, preset M10, qp 35, through
     Encoder(cfg).send_pictures on the default device (the card), once to
     warm and once timed; the kernel's launch count over the timed run
     must be > 0; every packet is decoded by the port's decoder on the
     card and must equal Packet.recon exactly;
  6. the same encode and decode check at 1280x720, 2 frames;
  7. the first 4 CIF frames encoded on the CPU with the plain versions,
     against the card's: >= 99% of blocks equal, |dPSNR| <= 0.05 dB,
     |dbytes| <= 1%;
  8. the zone-1/zone-3 directional predictors, the CfL AC buffer and
     prediction (exact) and the 16x16 ADST_ADST/ADST_DCT/DCT_ADST forward
     transforms (tie rule) on the card against the port's CPU run;
  9. preset M6 (tx-type search, angle deltas, CfL, palette) through
     Encoder(cfg).send_picture / flush on the default device: CIF, 2
     frames of the bench clip and 1 screen-content frame, one warm frame
     then timed; every packet decoded on the card and equal to
     Packet.recon; seconds per frame, bytes, Y-PSNR, the counts of blocks
     with a non-DCT tx type, a non-zero angle delta, CfL and palette
     (each must be > 0) and the host_ec seconds;
 10. the same at 1280x720, 1 clip frame (no warm frame; palette is
     required of phase 9's screen frame only);
 11. M6 through send_pictures (the batched program with the preset's 8
     plain luma modes): CIF x8 and 720p x2, hot fps, bytes, PSNR, K1
     launches > 0, decoder exact;
 12. 1 clip frame and 1 screen-content CIF frame at M6 on the CPU against
     the card's: >= 99% of blocks equal (mode, tx type, delta, uv mode,
     alphas, palette, levels), |dPSNR| <= 0.05 dB, |dbytes| <= 1%;
 13. the in-loop filter ops on the card against the port's CPU run, exact:
     filter_lines for every filter length at levels 4, 12, 32 and 63 over
     the CIF luma edge count of lines, loop_filter_plane_uniform on a
     blocky CIF luma plane (step 16, length 14) and its chroma plane (step
     8, length 6), cdef_find_dir on random and high-contrast blocks (cost
     above 2^24), cdef_filter_block for n = 8 and n = 4 over a strength
     and damping grid with CDEF_VERY_LARGE borders;
 14. M6 with DLF and CDEF on through send_picture / flush: the phase 9 and
     10 frames, timed (phases 9-10 warmed the frame program); seconds per
     frame, the dlf and cdef stage seconds, the chosen levels and
     strengths, bytes, Y-PSNR and the device kernels of one frame's filter
     stage (torch.profiler);
     every packet decoded on the card and equal to Packet.recon, and the
     filtered recon's SSE over Y+U+V not above the unfiltered recon's of
     phases 9-10 (the same decisions: key-frame MD does not see the
     filters, and both searches include "off");
 15. M10 through send_pictures, CIF x8, with DLF only (array route) and
     with DLF + CDEF (per-block route, CDEF signaled at strength 0 as in
     the reference): hot fps, bytes, PSNR, K1 launches > 0, decoder exact;
 16. the first clip frame and the screen-content frame at M6 with both
     filters on the CPU against the card's: >= 99% of blocks equal, the
     same filter levels and CDEF strengths, |dPSNR| <= 0.05 dB,
     |dbytes| <= 1%;
 17. the GOP slice's device ops on the card against the port's CPU run,
     exact: ssd_search, hme_core, the four convolves, _clamp_cands,
     mc_blocks (luma, chroma), mc_blocks_compound(_diffwtd), warp_core;
     _gm_fit under its tie rule (a differing model only where a float64
     value lies within 1e-3 of a rounding boundary) and the wedge pick
     under its own (a differing option only where the float64 SSEs of the
     two picks lie within 1e-6 relative), ties counted;
 18. the hierarchical GOP of the previous slice through send_picture /
     flush on the default device, at a cut depth: CIF x5 (key and a
     mini-GoP of 4), hierarchical_levels 3, keyint 15, M10, qp 35, MCTF
     and TPL off, DLF + CDEF; no warm run: fps, host dispatch seconds per
     inter frame, the host stage seconds, the inter blocks by kind (inter,
     intra, compound, wedge, diffwtd, warp, merged), K1 launches > 0;
     every shown frame (show-existing ones included) decoded on the card
     equal to Packet.recon (one inter frame's device kernels under
     torch.profiler: tools/profile_torch_encode.py --gop);
 19. the same GOP at 1280x720 x3 (warmed on its first 2 frames), the
     decode check over the 3 shown frames;
 20. 5-frame GOPs (hierarchical_levels 2) on the CPU against the card's,
     each decoded on its device and equal to Packet.recon: the natural
     clip at 96x96 (keyint 4), and the clips that code one tool each —
     the wipe (64x64, wedge), the iris (80x80, diffwtd; order hints off
     and wedge priced out, as in the reference's test) and a zoom +
     rotate clip (128x96, warped blocks) — where the card's stream must
     code that tool at least once: >= 99% of blocks equal (modes,
     references, MVs, warp, compound type, wedge option, qcoeff),
     |dPSNR| <= 0.05 dB, |dbytes| <= 1%, identity, and the GM / interp /
     wedge-pick ties printed;
 21. M12 (no subpel ring, 4 intra modes): CIF x5 GOP, timed (no warm
     run), decoded;
 22. the lookahead's device ops on the card against the port's CPU run
     at CIF: satd and TPL's group stats (gop_fast.tpl_group_stats over a
     key's 9-frame IPP chain and over a 3-level mini-GoP with its IPP
     tail) exact; the temporal filter on 99 32x32 blocks (F = 3) and
     mctf_filter_frame (the key's 2 neighbours, the base's 3) under the
     pixel tie rule below, flips counted;
 23. the previous slice's main path: the CIF x17 GOP (key, 15, key) of
     phase 18's structure with the reference's default tools, MCTF and
     TPL on (delta-q key frames), M10, DLF + CDEF, with recon_enabled off
     as bench.py runs it (phases 18-22 ran every program at CIF, so no
     separate warm run): fps, host dispatch seconds per inter frame, the
     seconds of the lookahead stages (key_tf, key_tpl, gop_tf, gop_tpl,
     gop_tpl_synth), the key frames coded with delta-q and their qindex
     range; every shown frame decoded on the card equal to the encoder's
     recon (kept on the card during the run); K1's launches must equal 56
     waves x the frames that are not delta-q key frames (840, 896 or
     952), since a delta-q key frame takes the per-block quantizer and
     the plain transform, as in the reference;
 24. the 7-frame 128x96 lookahead GOP of the CPU tests
     (clips.split_motion_clip, M10, hierarchical_levels 2, keyint 4) on
     the CPU against the card's, as in phase 20, with every MCTF call's
     planes compared under the pixel tie rule (flips printed); the card's
     stream must code a delta-q key frame;
 25. K1 at any batch size the paths launched that phase 3 did not check
     (checked and timed the same way); the sizes are recorded by the
     wrapper (fused_txq.batches) from the end of phase 4 on;
 26. the main path of this slice, bench.py's primary config: the CIF x17
     GOP (key, 15, key) at M6 with MCTF + TPL, DLF + CDEF, hierarchical
     levels 3, keyint 15, qp 35 (run after phase 27); a warm run over a
     3-frame prefix, then the timed run with recon_enabled off: fps, host
     dispatch seconds per inter frame, the lookahead, tmvp_setup and
     save_mvfield stage seconds, bytes, mean Y-PSNR, the inter blocks by
     kind (8x8 split
     leaves, non-DCT inter tx, OBMC, inter-intra, compound, warp) and the
     inter frames with use_ref_frame_mvs; K1's launches must equal the
     waves of the 15 inter frames, all at B = 88 (M6 key frames search
     four tx types and do not take it); every shown frame decoded on the
     card equal to the encoder's recon (kept on the card during the run);
 27. the M5-M9 clips of the CPU tests on the CPU against the card's, as in
     phase 20: OBMC (seam texture) and inter-intra (gradient wipe) at M6
     with part8 and the tx search pinned off as the reference's tests pin
     them, the 8x8 split + TMVP (boundary clip, M6), M8's full tools and
     M9 on the natural clip; the card's stream must code the clip's tool,
     and blocks whose inter tx type alone differs are counted.

K1's launch count is set to 0 before each encode path and read after it;
the send_pictures paths (with and without the filters) and the GOP paths
(pass B of every inter frame, and the M9-M13 key frames without delta-q)
must have launched it; the M6 send_picture paths and the M6 GOP's key
frames do not run it (their luma step searches four tx types, as the
reference's does without its kernel).

Tie rule for the forward transform: the kernel's float32 sums run in
another order than cuBLAS's, so a coefficient may differ from the plain
version's by at most 1, and only where its float64 value lies within 1e-2
of a half-integer; qcoeff/dqcoeff must equal the plain quantizer applied
to the kernel's own coefficients, exactly.  Pixel tie rule of MCTF (a
float32 weighted average with exp weights, which CUDA and the CPU round
differently in the last bit): a filtered pixel may differ by 1 only where
its float64 value lies within 1e-3 of a half-integer.

Bound of a K1 launch: the residual, the matrices and the quantizer
constants read once and the three outputs written once, over 3.35 TB/s,
against 2 x 2 x 16^3 FLOP a block over 67 TFLOP/s (the H100 SXM's
published rates); bytes bound it.  The inputs are timed as the encode
leaves them: just written, so in the 50 MB L2.

The script imports nothing of JAX or of the JAX package (the golden
inputs come from svt_av1_tpu_torch/goldens.py) and checks at its end
that neither was loaded.  The second-to-last line is the kernels' JSON
record, the last line {"ok": true, "device": {...}}.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
CIF = (352, 288)
HD = (1280, 720)
MIN_BLOCK_AGREE = 0.99
MAX_DPSNR = 0.05
MAX_DBYTES = 0.01


T0 = time.perf_counter()


def log(msg):
    """One phase line, with the seconds since the script started."""
    print(f"{msg} [t={time.perf_counter() - T0:.0f} s]", flush=True)


def synth_frames(n, w, h):
    """The bench.py synthetic clip (moving sinusoids + noise), any size."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for t in range(n):
        y = (96 + 60 * np.sin(xx / 17.0 + t * 0.13)
             + 50 * np.cos(yy / 23.0 + t * 0.02)
             + rng.integers(-5, 6, (h, w)))
        y = np.clip(y, 0, 255).astype(np.uint8)
        u = np.clip(128 + 40 * np.sin(xx[::2, ::2] / 31.0 + t * 0.05),
                    0, 255).astype(np.uint8)
        v = np.clip(128 + 40 * np.cos(yy[::2, ::2] / 29.0),
                    0, 255).astype(np.uint8)
        out.append((y, u, v))
    return out


def psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 99.0 if mse == 0 else float(10 * np.log10(255.0 ** 2 / mse))


HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3, published datasheet rate
FP32_FLOP_PER_S = 67e12     # H100 SXM float32 outside the tensor cores
GRAPH_LAUNCHES = 20
GRAPH_REPLAYS = 50
# the depth of the all-intra send_pictures paths of the earlier slices
CIF_FRAMES, HD_FRAMES = 8, 2


def k1_batch(nframes, size, preset):
    """K1's batch B on a path: frames in one program x wave slots (the
    natural wave size of the 16x16 grid) x the preset's luma modes.  A
    send_pictures chunk holds all its frames; a send_picture key frame
    and the pass B of an inter frame hold one."""
    from svt_av1_tpu_torch.pipeline import intra_encoder
    from svt_av1_tpu_torch.pipeline.presets import features_for
    w, h = size
    return (nframes * intra_encoder._natural_maxb(-(-h // 16), -(-w // 16))
            * len(features_for(preset).intra_modes))


def k1_batches():
    """The batch sizes of the paths this script drives."""
    driven = [k1_batch(CIF_FRAMES, CIF, 10), k1_batch(HD_FRAMES, HD, 10),
              k1_batch(CIF_FRAMES, CIF, 6), k1_batch(HD_FRAMES, HD, 6),
              k1_batch(1, CIF, 10), k1_batch(1, CIF, 12),
              k1_batch(1, HD, 10)]
    # the small GOPs of phase 20 (natural 96x96, wipe 64x64, iris 80x80,
    # rotzoom 128x96)
    driven += [k1_batch(1, size, 10)
               for size in ((96, 96), (64, 64), (80, 80), (128, 96))]
    # pass B at M6 / M8 (8 modes): CIF (phase 26) and phase 27's clips
    driven += [k1_batch(1, size, 6) for size in (CIF, (64, 64), (128, 96))]
    return list(dict.fromkeys(driven))


def graph_us(launch, n=GRAPH_LAUNCHES, replays=GRAPH_REPLAYS):
    """Device time per call of ``launch`` in microseconds: n calls
    captured in one CUDA graph, replayed ``replays`` times between two
    CUDA events, the time divided by n * replays.  No host issue time is
    inside the events."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                    # warm-up, caches
        for _ in range(3):
            launch()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            launch()
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(replays):
        g.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) * 1000.0 / (n * replays)


def host_issue_ms(call, n=200):
    """Host time of one call (mean of n back-to-back calls, no
    synchronisation inside the timed loop)."""
    import torch
    for _ in range(10):
        call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        call()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt * 1000.0 / n


def txq_bound(b):
    """(bytes, FLOP, bound in us, bound_by) of one fused_txq launch over b
    blocks: the residual and the matrices and quantizer constants read
    once, the three outputs written once; 2 passes of 16^3 FMAs a
    block."""
    nbytes = b * 1024 + 2 * 1024 + 40 + 3 * b * 1024
    flop = b * 2 * 2 * 16 ** 3
    t_mem = nbytes / HBM_BYTES_PER_S * 1e6
    t_op = flop / FP32_FLOP_PER_S * 1e6
    return nbytes, flop, max(t_mem, t_op), ("bytes" if t_mem >= t_op
                                            else "operations")


class V1:
    """The first kernel (svt_fused_txq16_v1) on preallocated outputs, and
    ``call``, a copy of the first wrapper's host work (checks, three
    allocations, device matrices, thirteen arguments) for its issue
    time."""

    def __init__(self, resid, qp):
        import torch
        from svt_av1_tpu_torch.codec import constants as cc
        from svt_av1_tpu_torch.ops import fused_txq
        from svt_av1_tpu_torch.ops import transforms as tf
        self.fn = fused_txq.entry("svt_fused_txq16_v1")
        self.resid, self.qp = resid, qp
        self.mats = tf.fwd_matrices_on(cc.DCT_DCT, cc.TX_16X16, resid.device)
        self.out = torch.empty((3,) + tuple(resid.shape), dtype=torch.int32,
                               device=resid.device)

    def _launch(self, c, q, d):
        import torch
        r, qp = self.resid, self.qp
        rc = self.fn(r.data_ptr(), r.shape[0], self.mats[0].data_ptr(),
                     self.mats[1].data_ptr(), *(a.data_ptr() for a in qp),
                     c.data_ptr(), q.data_ptr(), d.data_ptr(),
                     torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"fused_txq16_v1 launch failed: CUDA error "
                               f"{rc}")

    def launch(self):
        self._launch(*self.out)
        return self.out

    def call(self):
        import torch
        from svt_av1_tpu_torch.codec import constants as cc
        from svt_av1_tpu_torch.ops import fused_txq
        from svt_av1_tpu_torch.ops import transforms as tf
        fused_txq._check(self.resid, self.qp)
        self.mats = tf.fwd_matrices_on(cc.DCT_DCT, cc.TX_16X16,
                                       self.resid.device)
        outs = [torch.empty_like(self.resid) for _ in range(3)]
        with torch.cuda.device(self.resid.device):
            self._launch(*outs)
        return outs


def v2_launcher(resid, qp):
    """The kernel the encode runs (svt_fused_txq16) on preallocated
    outputs, through its C entry point (not counted as a wrapper
    launch)."""
    import torch
    from svt_av1_tpu_torch.ops import fused_txq
    fn = fused_txq.entry()
    qc = fused_txq.packed_constants(qp)
    fvt, fht = fused_txq.matrices_t(resid.get_device())
    out = torch.empty((3,) + tuple(resid.shape), dtype=torch.int32,
                      device=resid.device)

    def launch():
        rc = fn(resid.data_ptr(), resid.shape[0], fvt.data_ptr(),
                fht.data_ptr(), qc.data_ptr(), out.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"fused_txq16 launch failed: CUDA error {rc}")
        return out
    return launch


def time_txq(resid, card, plain=True, tag="3"):
    """Device time per launch of the kernel, the first kernel and (when
    ``plain``) the plain version at qindex 140, three rounds in turns, and
    the host issue time of the wrapper and of the first wrapper."""
    from svt_av1_tpu_torch.ops import fused_txq, quant
    b = resid.shape[0]
    qp = quant.to_device(quant.make_quant_params(140), "cuda")
    v1 = V1(resid, qp)
    fns = dict(v2=v2_launcher(resid, qp), v1=v1.launch)
    if plain:
        fns["plain"] = lambda: fused_txq.fused_txq_plain(resid, qp)
    times = {k: [] for k in fns}
    for order in (list(fns), list(fns)[::-1], list(fns)):
        for k in order:
            times[k].append(graph_us(fns[k]))
    med = {k: float(np.median(v)) for k, v in times.items()}
    nbytes, flop, bound_us, bound_by = txq_bound(b)
    issue = host_issue_ms(lambda: fused_txq.fused_txq(resid, qp))
    issue_v1 = host_issue_ms(v1.call)
    plain_txt = (f"plain {med['plain']:.3f} us; " if plain else "")
    log(f"phase {tag}: fused_txq B={b} qindex=140 device time per launch "
        f"(CUDA graph of {GRAPH_LAUNCHES} launches x {GRAPH_REPLAYS} "
        f"replays, median of 3 rounds in turns): kernel {med['v2']:.3f} us,"
        f" first kernel {med['v1']:.3f} us, {plain_txt}{nbytes} bytes, "
        f"{flop} FLOP; bound {bound_us:.3f} us ({bound_by}, 3.35 TB/s); "
        f"kernel at {bound_us / med['v2']:.1%} of its bound, first kernel "
        f"at {bound_us / med['v1']:.1%}; host issue per call: wrapper "
        f"{issue:.4f} ms, first wrapper {issue_v1:.4f} ms; {card}")
    return dict(b=b, us=med["v2"], v1_us=med["v1"],
                plain_us=med.get("plain"), bytes=nbytes, flop=flop,
                bound_us=bound_us, bound_by=bound_by,
                share=bound_us / med["v2"], v1_share=bound_us / med["v1"],
                host_issue_ms=issue, v1_host_issue_ms=issue_v1,
                rounds=times)


def check_txq(b, card, rng, rec, driven=True, tag="3"):
    """K1 (fused_txq16) at batch b: bit-identity with the first kernel,
    the tie rule against the plain version, exact quantizer on the
    kernel's own coefficients, at qindex 140 and 255; then its timing
    (time_txq) appended to rec["by_batch"], marked ``driven`` (a size the
    script's paths give K1) or not (timed for comparison only)."""
    import torch
    import tie_rule
    from svt_av1_tpu_torch.codec import constants as cc
    from svt_av1_tpu_torch.ops import fused_txq, quant
    from svt_av1_tpu_torch.ops import transforms as tf
    fv, fh, _, _ = tf._fwd_matrices(cc.DCT_DCT, cc.TX_16X16)
    resid_np = rng.integers(-255, 256, (b, 16, 16)).astype(np.int32)
    exact = tie_rule.exact_coeffs(resid_np, fv, fh)
    resid = torch.from_numpy(resid_np).cuda()
    for qindex in (140, 255):
        qp = quant.to_device(quant.make_quant_params(qindex), "cuda")
        ck, qk, dk = fused_txq.fused_txq(resid, qp)
        v1 = V1(resid, qp).launch()
        cp, _, _ = fused_txq.fused_txq_plain(resid, qp)
        torch.cuda.synchronize()
        n_v1 = sum(int((a != o).sum()) for a, o in zip((ck, qk, dk), v1))
        if n_v1:
            raise AssertionError(f"B={b} qindex={qindex}: {n_v1} values "
                                 "differ between the kernel and the first "
                                 "kernel")
        q_ref, d_ref = quant.quantize(ck, qp, cc.TX_16X16)
        if not (torch.equal(qk, q_ref) and torch.equal(dk, d_ref)):
            raise AssertionError("kernel qcoeff/dqcoeff differ from the "
                                 "quantizer on its own coefficients")
        nmis, maxd = tie_rule.tie_mismatches(ck.cpu().numpy(),
                                             cp.cpu().numpy(), exact)
        rec["max_abs_err"] = max(rec["max_abs_err"], maxd)
        log(f"phase {tag}: fused_txq B={b} qindex={qindex}"
            f"{'' if driven else ' (comparison size)'}: 0 of "
            f"{3 * resid.numel()} coeff/qcoeff/dqcoeff values differ from "
            f"the first kernel; {nmis} of {resid.numel()} coefficients "
            f"differ from the plain version (all on rounding ties, max "
            f"|diff| {maxd}); qcoeff/dqcoeff exact")
    rec["by_batch"].append(dict(time_txq(resid, card, tag=tag),
                                driven=driven))


def phase_kernel(card):
    """K1 at the batch sizes of the driven paths and at the comparison
    sizes (check_txq), then at a batch far beyond the L2."""
    import torch
    from svt_av1_tpu_torch.ops import quant
    rng = np.random.default_rng(7)
    rec = dict(max_abs_err=0, by_batch=[])
    for b in k1_batches():
        check_txq(b, card, rng, rec)
    # a batch far beyond the L2: bound by device memory
    resid = torch.randint(-255, 256, (135168, 16, 16), dtype=torch.int32,
                          device="cuda")
    qp = quant.to_device(quant.make_quant_params(140), "cuda")
    n_v1 = int((v2_launcher(resid, qp)() != V1(resid, qp).launch()).sum())
    if n_v1:
        raise AssertionError(f"B=135168: {n_v1} values differ between the "
                             "kernel and the first kernel")
    rec["by_batch"].append(dict(time_txq(resid, card, plain=False),
                                driven=False))
    return rec


def phase_goldens():
    import torch
    from svt_av1_tpu_torch import goldens as gd
    from svt_av1_tpu_torch.codec import constants as cc
    from svt_av1_tpu_torch.ops import intra
    from svt_av1_tpu_torch.ops import transforms as tf
    inv = dict(np.load(os.path.join(gd.GOLDEN_DIR, "inv_txfm.npz")))
    n_inv = 0
    for tx_size, tx_type, bd in gd.inv_txfm_cases():
        coeffs, pred = gd.inv_txfm_input(tx_size, tx_type, bd)
        got = tf.inv_txfm2d_add(torch.from_numpy(coeffs[None]).cuda(),
                                torch.from_numpy(pred[None]).cuda(),
                                tx_type, tx_size, bd=bd)[0].cpu().numpy()
        ref = inv[f"s{tx_size}_t{tx_type}_b{bd}"].astype(np.int32)
        if not np.array_equal(got, ref):
            raise AssertionError(f"inv_txfm2d_add differs from the golden "
                                 f"(size {tx_size} type {tx_type} bd {bd})")
        n_inv += 1
    ivec = dict(np.load(os.path.join(gd.GOLDEN_DIR, "intra.npz")))
    n_pred = 0
    for mode in (cc.DC_PRED, cc.V_PRED, cc.H_PRED, cc.SMOOTH_PRED,
                 cc.PAETH_PRED):
        for (w, h) in gd.INTRA_SIZES:
            above, left, corner = gd.intra_input(mode, w, h)
            got = intra.predict(
                mode, torch.from_numpy(above[None].astype(np.int32)).cuda(),
                torch.from_numpy(left[None].astype(np.int32)).cuda(),
                torch.tensor([corner], dtype=torch.int32, device="cuda"),
                h, w)[0].cpu().numpy()
            if not np.array_equal(got, ivec[f"m{mode}_{w}x{h}"]):
                raise AssertionError(f"predictor {mode} {w}x{h} differs "
                                     "from the golden")
            n_pred += 1
    log(f"phase 4: inv_txfm2d_add {n_inv} cases and DC/V/H/SMOOTH/PAETH "
        f"{n_pred} cases bit-exact vs the C goldens on cuda")


FILTERS = dict(enable_dlf_flag=1, cdef_level=1)
# the bench's GOP structure: 3-level mini-GoPs, keyint 15,
# MCTF and TPL off (the earlier slice's path) ...
GOP = dict(hierarchical_levels=3, intra_period_length=15, enable_tf=0,
           enable_tpl_la=0, **FILTERS)
# ... and on (the reference's default tools)
LOOKAHEAD = dict(enable_tf=1, enable_tpl_la=1)


def encode(frames, w, h, device, preset=10, batched=True, **filters):
    """Packets of ``frames`` at ``preset``, qp 35: one send_pictures call,
    or (not ``batched``) one send_picture per frame and a flush.
    ``filters``: the in-loop filter settings of EncoderConfig."""
    from svt_av1_tpu_torch.api.encoder import Encoder, EncoderConfig
    enc = Encoder(EncoderConfig(source_width=w, source_height=h, qp=35,
                                enc_mode=preset, **filters), device=device)
    if batched:
        enc.send_pictures(frames, eos=True)
    else:
        for f in frames:
            enc.send_picture(*f)
        enc.flush()
    pkts = []
    while (p := enc.get_packet()) is not None:
        pkts.append(p)
    if len(pkts) != len(frames):
        raise AssertionError(f"{len(pkts)} packets for {len(frames)} frames")
    return pkts


def decode_check(pkts, device, headers=None):
    """Port decoder on ``device``; every frame must equal Packet.recon.
    Returns the parsed decisions per frame; appends each frame header to
    ``headers`` when given."""
    from svt_av1_tpu_torch.codec.decoder import Decoder
    dec = Decoder(device=device)
    decisions = []
    for p in pkts:
        frames = dec.decode_temporal_unit(p.data)
        if len(frames) != 1:
            raise AssertionError("one displayed frame per packet expected")
        for k in ("y", "u", "v"):
            if not np.array_equal(frames[0][k], p.recon[k]):
                raise AssertionError(f"decoder recon differs (plane {k}, "
                                     f"frame {p.pts})")
        decisions.append(frames[0]["decisions"])
        if headers is not None:
            headers.append(dec.last_frame_header)
    return decisions


def phase_encode(tag, frames, w, h, card, preset=10, **filters):
    import torch
    from svt_av1_tpu_torch.ops import fused_txq
    encode(frames, w, h, None, preset, **filters)    # warm
    torch.cuda.synchronize()
    fused_txq.launches = 0
    t0 = time.perf_counter()
    pkts = encode(frames, w, h, None, preset, **filters)
    dt = time.perf_counter() - t0
    launches = fused_txq.launches
    if launches <= 0:
        raise AssertionError("the main path never launched fused_txq")
    nbytes = sum(len(p.data) for p in pkts)
    mpsnr = float(np.mean([psnr(f[0], p.recon["y"])
                           for f, p in zip(frames, pkts)]))
    t1 = time.perf_counter()
    decisions = decode_check(pkts, None)
    what = ("" if not filters else
            " with DLF" + (" + CDEF" if filters.get("cdef_level") else ""))
    log(f"phase {tag}: {w}x{h} x{len(frames)} M{preset} qp35{what} through "
        f"send_pictures on the default device "
        f"({torch.cuda.get_device_name(0)}): "
        f"{len(frames) / dt:.3f} fps hot ({dt:.3f} s), {nbytes} bytes, "
        f"mean Y-PSNR {mpsnr:.4f} dB, fused_txq launches {launches} "
        f"({card}); decoder on the default device matches recon "
        f"({time.perf_counter() - t1:.1f} s)")
    return pkts, decisions, launches


def tool_counts(decisions):
    """Blocks with a non-DCT tx type, a non-zero angle delta, CfL and a
    palette over the frames' parsed decisions."""
    from svt_av1_tpu_torch.codec import constants as cc
    blocks = [b for d in decisions for b in d.values()]
    return dict(
        blocks=len(blocks),
        tx=sum(b.tx_type != cc.DCT_DCT for b in blocks),
        delta=sum(b.angle_delta_y != 0 for b in blocks),
        cfl=sum(b.uv_mode == cc.UV_CFL_PRED for b in blocks),
        palette=sum(b.palette is not None for b in blocks))


def phase_key_frames(tag, frames, w, h, card, warm=True,
                     need=("tx", "delta", "cfl", "palette")):
    """M6 through send_picture / flush on the default device: one warm
    frame (unless ``warm`` is off: a smaller size warmed the program),
    then the timed run; every packet decoded on the card; each tool of
    ``need`` used by some block."""
    import torch
    from svt_av1_tpu_torch.ops import fused_txq
    from svt_av1_tpu_torch.utils import profiling
    if warm:
        encode(frames[:1], w, h, None, 6, batched=False)
    torch.cuda.synchronize()
    profiling.reset_stages()
    fused_txq.launches = 0
    t0 = time.perf_counter()
    pkts = encode(frames, w, h, None, 6, batched=False)
    dt = time.perf_counter() - t0
    launches = fused_txq.launches
    stages = profiling.stage_stats()
    nbytes = sum(len(p.data) for p in pkts)
    mpsnr = float(np.mean([psnr(f[0], p.recon["y"])
                           for f, p in zip(frames, pkts)]))
    t1 = time.perf_counter()
    decisions = decode_check(pkts, None)
    dec_s = time.perf_counter() - t1
    n = tool_counts(decisions)
    sec = {k: stages.get(k, (0.0, 0))[0]
           for k in ("palette_md", "device_md_intra", "host_ec")}
    log(f"phase {tag}: {w}x{h} x{len(frames)} M6 qp35 through send_picture "
        f"on the default device ({torch.cuda.get_device_name(0)}): "
        f"{dt / len(frames):.3f} s per frame ({dt:.3f} s; per frame "
        f"{[len(p.data) for p in pkts]} bytes), {nbytes} bytes, mean "
        f"Y-PSNR {mpsnr:.4f} dB; of {n['blocks']} blocks {n['tx']} with a "
        f"non-DCT tx type, {n['delta']} with an angle delta, {n['cfl']} CfL, "
        f"{n['palette']} palette; host seconds: palette_md "
        f"{sec['palette_md']:.3f}, device_md_intra "
        f"{sec['device_md_intra']:.3f}, host_ec {sec['host_ec']:.3f} "
        f"({sec['host_ec'] / dt:.1%} of the wall time); fused_txq launches "
        f"{launches} ({card}); decoder on the default device matches recon "
        f"({dec_s:.1f} s)")
    for k in need:
        if n[k] <= 0:
            raise AssertionError(f"phase {tag}: no block uses the tool "
                                 f"'{k}' at M6")
    return pkts, decisions, launches


def same_block(a, b):
    pal = ((a.palette is None) == (b.palette is None)
           and (a.palette is None
                or (np.array_equal(a.palette, b.palette)
                    and np.array_equal(a.palette_map, b.palette_map))))
    return (a.y_mode == b.y_mode and a.uv_mode == b.uv_mode
            and a.tx_type == b.tx_type
            and a.angle_delta_y == b.angle_delta_y
            and a.cfl_alpha_u == b.cfl_alpha_u
            and a.cfl_alpha_v == b.cfl_alpha_v and pal
            and np.array_equal(a.qcoeff_y, b.qcoeff_y)
            and np.array_equal(a.qcoeff_u, b.qcoeff_u)
            and np.array_equal(a.qcoeff_v, b.qcoeff_v))


def block_agreement(da, db):
    same = tot = 0
    for fa, fb in zip(da, db):
        for k, a in fa.items():
            tot += 1
            same += same_block(a, fb[k])
    return same / max(tot, 1)


def phase_tools():
    """The predictors and forward transforms that M5-M8 use for the first
    time, on the card against the port's CPU run."""
    import torch
    import tie_rule
    from svt_av1_tpu_torch.codec import constants as cc
    from svt_av1_tpu_torch.ops import intra
    from svt_av1_tpu_torch.ops import transforms as tf
    rng = np.random.default_rng(8)
    n, b = 16, 2816
    ext = rng.integers(0, 256, (b, 2 * n + 1)).astype(np.int32)
    ext[:, -1] = ext[:, -2]
    ext_c, ext_g = torch.from_numpy(ext), torch.from_numpy(ext).cuda()
    n_pred = 0
    for angle in (81, 84, 87, 183, 186, 189):
        fn = intra.z1_pred if angle < 90 else intra.z3_pred
        if not torch.equal(fn(ext_g, n, n, angle).cpu(),
                           fn(ext_c, n, n, angle)):
            raise AssertionError(f"directional predictor at {angle} degrees "
                                 "differs between cuda and cpu")
        n_pred += 1
    luma = rng.integers(0, 256, (b, 16, 16)).astype(np.int32)
    dc = rng.integers(0, 256, (b, 8, 8)).astype(np.int32)
    alpha = rng.integers(-16, 17, b).astype(np.int32)
    outs = []
    for dev in ("cpu", "cuda"):
        to = lambda a: torch.from_numpy(a).to(dev)
        ac = intra.cfl_ac_420(to(luma), 8, 8)
        outs.append((ac.cpu(), intra.cfl_predict(to(dc), ac,
                                                 to(alpha)).cpu()))
    if not (torch.equal(outs[0][0], outs[1][0])
            and torch.equal(outs[0][1], outs[1][1])):
        raise AssertionError("CfL AC buffer or prediction differs between "
                             "cuda and cpu")
    resid = rng.integers(-255, 256, (b, 16, 16)).astype(np.int32)
    ties = {}
    for name, t in (("ADST_ADST", cc.ADST_ADST), ("ADST_DCT", cc.ADST_DCT),
                    ("DCT_ADST", cc.DCT_ADST)):
        fv, fh, _, _ = tf._fwd_matrices(t, cc.TX_16X16)
        exact = tie_rule.exact_coeffs(resid, fv, fh)
        got = tf.fwd_txfm2d(torch.from_numpy(resid).cuda(), t,
                            cc.TX_16X16).cpu().numpy()
        ref = tf.fwd_txfm2d(torch.from_numpy(resid), t,
                            cc.TX_16X16).numpy()
        ties[name] = tie_rule.tie_mismatches(got, ref, exact)[0]
    log(f"phase 8: z1/z3 predictors at {n_pred} angles and CfL (AC buffer, "
        f"prediction) exact cuda vs cpu at B={b}; 16x16 forward transforms "
        f"cuda vs cpu, coefficients off by one on rounding ties of "
        f"{resid.size}: {ties}")


def phase_cpu_vs_cuda_m6(frames, pkts_cuda, dec_cuda):
    pkts_cpu = encode(frames, *CIF, "cpu", 6, batched=False)
    dec_cpu = decode_check(pkts_cpu, "cpu")
    agree = block_agreement(dec_cpu, dec_cuda)
    p_cpu = np.mean([psnr(f[0], p.recon["y"])
                     for f, p in zip(frames, pkts_cpu)])
    p_gpu = np.mean([psnr(f[0], p.recon["y"])
                     for f, p in zip(frames, pkts_cuda)])
    b_cpu = sum(len(p.data) for p in pkts_cpu)
    b_gpu = sum(len(p.data) for p in pkts_cuda)
    same_bytes = all(a.data == b.data for a, b in zip(pkts_cpu, pkts_cuda))
    log(f"phase 12: {len(frames)} CIF frames at M6 (send_picture) cpu vs "
        f"cuda: {agree:.4%} blocks equal, Y-PSNR {p_cpu:.4f} vs "
        f"{p_gpu:.4f} dB, bytes {b_cpu} vs {b_gpu}, streams identical: "
        f"{same_bytes}")
    if (agree < MIN_BLOCK_AGREE or abs(p_cpu - p_gpu) > MAX_DPSNR
            or abs(b_cpu - b_gpu) > MAX_DBYTES * b_gpu):
        raise AssertionError("cpu and cuda M6 encodes disagree beyond the "
                             "slice's parity thresholds")


def phase_cpu_vs_cuda(frames, pkts_cuda, dec_cuda):
    pkts_cpu = encode(frames, *CIF, "cpu")
    dec_cpu = decode_check(pkts_cpu, "cpu")
    n = len(frames)
    agree = block_agreement(dec_cpu, dec_cuda[:n])
    p_cpu = np.mean([psnr(f[0], p.recon["y"]) for f, p in zip(frames,
                                                               pkts_cpu)])
    p_gpu = np.mean([psnr(f[0], p.recon["y"]) for f, p in zip(
        frames, pkts_cuda[:n])])
    b_cpu = sum(len(p.data) for p in pkts_cpu)
    b_gpu = sum(len(p.data) for p in pkts_cuda[:n])
    same_bytes = all(a.data == b.data for a, b in zip(pkts_cpu, pkts_cuda))
    log(f"phase 7: first {n} CIF frames cpu vs cuda: {agree:.4%} blocks "
        f"equal, Y-PSNR {p_cpu:.4f} vs {p_gpu:.4f} dB, bytes {b_cpu} vs "
        f"{b_gpu}, streams identical: {same_bytes}")
    if (agree < MIN_BLOCK_AGREE or abs(p_cpu - p_gpu) > MAX_DPSNR
            or abs(b_cpu - b_gpu) > MAX_DBYTES * b_gpu):
        raise AssertionError("cpu and cuda encodes disagree beyond the "
                             "slice's parity thresholds")


def _edge_lines(rng, n):
    """(n, 14) int32 lines across an edge: smooth with a small step (the
    flat/wide paths), smooth with a large step, and rough, in turns."""
    base = rng.integers(20, 236, (n, 1))
    smooth = np.cumsum(rng.integers(-1, 2, (n, 14)), axis=1) // 2
    step = np.where(np.arange(14) >= 7, 1, 0)[None]
    kind = (np.arange(n) % 3)[:, None]
    x = base + np.where(kind == 0, smooth + step * rng.integers(-6, 7, (n, 1)),
                        np.where(kind == 1,
                                 smooth + step * rng.integers(-60, 61, (n, 1)),
                                 rng.integers(-25, 26, (n, 14))))
    return np.clip(x, 0, 255).astype(np.int32)


def _blocky(h, w, step, rng):
    """A smooth ramp with a per-block offset, so the deblocker engages."""
    yy, xx = np.mgrid[0:h, 0:w]
    off = rng.integers(-4, 5, (h // step + 1, w // step + 1))
    return (90 + xx // 5 + yy // 6 + off[yy // step, xx // step]
            + rng.integers(0, 2, (h, w))).astype(np.int32)


def phase_filter_ops():
    """DLF and CDEF ops on the card against the port's CPU run, exact, at
    the CIF frame's batch sizes."""
    import torch
    from svt_av1_tpu_torch.ops import cdef, dlf
    rng = np.random.default_rng(13)
    both = lambda a: (torch.from_numpy(a), torch.from_numpy(a).cuda())
    n_lines = CIF[1] * (CIF[0] // 16 - 1)           # CIF luma vertical edges
    counts = {}
    for flen in (4, 6, 8, 14):
        for level in (4, 12, 32, 63):
            c, g = both(_edge_lines(rng, n_lines))
            thr = dlf.loop_filter_thresholds(level, 0)
            ref = dlf.filter_lines(c, *thr, flen)
            if not torch.equal(dlf.filter_lines(g, *thr, flen).cpu(), ref):
                raise AssertionError(f"filter_lines len {flen} level {level}"
                                     " differs between cuda and cpu")
            counts[f"{flen}/{level}"] = int((ref != c).any(1).sum())
    planes = {}
    for name, (h, w), step, flen, level in (
            ("luma", CIF[::-1], 16, 14, 20),
            ("chroma", (CIF[1] // 2, CIF[0] // 2), 8, 6, 10)):
        c, g = both(_blocky(h, w, step, rng))
        ref = dlf.loop_filter_plane_uniform(c, step, level, 0, flen)
        got = dlf.loop_filter_plane_uniform(g, step, level, 0, flen).cpu()
        if not torch.equal(got, ref) or torch.equal(ref, c):
            raise AssertionError(f"loop_filter_plane_uniform ({name}) differs "
                                 "between cuda and cpu, or did not filter")
        planes[name] = int((ref != c).sum())
    nb = (CIF[0] // 8) * (CIF[1] // 8)
    ii, jj = np.mgrid[0:8, 0:8]
    pats = np.stack([(ii + k * jj) // 2 % 2 for k in range(-3, 4)]
                    + [(jj + k * ii) // 2 % 2 for k in range(-3, 4)]) * 255
    blocks = rng.integers(0, 256, (nb, 8, 8))
    hi = np.repeat(pats, 8, 0)[:nb // 2]
    blocks[:len(hi)] = np.clip(hi + rng.integers(-3, 4, hi.shape), 0, 255)
    c, g = both(blocks.astype(np.int32))
    d_ref, v_ref = cdef.cdef_find_dir(c)
    d_got, v_got = cdef.cdef_find_dir(g)
    if not (torch.equal(d_got.cpu(), d_ref) and torch.equal(v_got.cpu(), v_ref)):
        raise AssertionError("cdef_find_dir differs between cuda and cpu")
    x = blocks.reshape(nb, 64).astype(np.int64) - 128
    part = np.einsum("dpi,bi->bdp",
                     cdef._partial_projections().astype(np.int64), x)
    n_big = int(((part * part * cdef._cost_weights().astype(np.int64))
                 .sum(2).max(1) > 2 ** 24).sum())
    grid = [(p, s) for p in (0, 1, 2, 3, 4, 6, 8, 12, 15) for s in (0, 1, 2, 4)]
    for n in (8, 4):
        wins = rng.integers(0, 256, (nb, n + 4, n + 4)).astype(np.int32)
        wins[::3, :2] = cdef.CDEF_VERY_LARGE
        wins[1::3, :, -2:] = cdef.CDEF_VERY_LARGE
        pri = np.array([grid[i % len(grid)][0] for i in range(nb)], np.int32)
        sec = np.array([grid[i % len(grid)][1] for i in range(nb)], np.int32)
        dirs = rng.integers(0, 8, nb).astype(np.int32)
        args_c = [torch.from_numpy(a) for a in (wins, pri, sec, dirs)]
        args_g = [a.cuda() for a in args_c]
        for damping in (3, 4, 5, 6):
            ref = cdef.cdef_filter_block(*args_c, damping, damping, n=n)
            got = cdef.cdef_filter_block(*args_g, damping, damping, n=n)
            if not torch.equal(got.cpu(), ref):
                raise AssertionError(f"cdef_filter_block n={n} damping "
                                     f"{damping} differs between cuda and cpu")
    log(f"phase 13: DLF and CDEF ops exact cuda vs cpu: filter_lines over "
        f"{n_lines} lines at 4 lengths x levels 4/12/32/63 (lines changed "
        f"{counts}); loop_filter_plane_uniform CIF luma and chroma "
        f"(pixels changed {planes}); cdef_find_dir on {nb} blocks ({n_big} "
        f"with a direction cost above 2^24); cdef_filter_block "
        f"n=8 and n=4 on {nb} blocks x {len(grid)} strength pairs x "
        f"damping 3-6 with CDEF_VERY_LARGE borders")


def _sse(pkts, frames):
    """Total SSE of the packets' recon against the source, Y+U+V."""
    return sum(int(((p.recon[k].astype(np.int64) - f[i]) ** 2).sum())
               for p, f in zip(pkts, frames) for i, k in enumerate("yuv"))


def phase_filtered_key_frames(tag, frames, w, h, card, unfiltered):
    """M6 with DLF and CDEF through send_picture / flush on the default
    device, timed (the unfiltered phase of the same size warmed the frame
    program; the filters are eager ops of fixed shapes); every packet
    decoded on the card; the filtered SSE against ``unfiltered`` (the same
    frames without filters); the filter stage of the first frame under
    torch.profiler."""
    import torch
    from svt_av1_tpu_torch.api.encoder import Encoder, EncoderConfig
    from svt_av1_tpu_torch.codec import obu
    from svt_av1_tpu_torch.ops import fused_txq
    from svt_av1_tpu_torch.utils import kernel_profile, profiling
    torch.cuda.synchronize()
    profiling.reset_stages()
    fused_txq.launches = 0
    t0 = time.perf_counter()
    pkts = encode(frames, w, h, None, 6, batched=False, **FILTERS)
    dt = time.perf_counter() - t0
    launches = fused_txq.launches
    stages = profiling.stage_stats()
    headers = []
    t1 = time.perf_counter()
    decisions = decode_check(pkts, None, headers)
    dec_s = time.perf_counter() - t1
    sse_f, sse_u = _sse(pkts, frames), _sse(unfiltered, frames)
    if sse_f > sse_u:
        raise AssertionError(f"phase {tag}: the filtered recon's SSE {sse_f} "
                             f"is above the unfiltered {sse_u}")
    enc = Encoder(EncoderConfig(source_width=w, source_height=h, qp=35,
                                enc_mode=6, **FILTERS))
    y, u, v = enc._pad(*frames[0])
    qindex = enc._rc.frame_qindex()
    dec0, rec0, _ = enc._mode_decision(y, u, v, qindex)
    fp = obu.FrameParams(base_q_idx=qindex)
    prof = kernel_profile.device_kernels(
        lambda: enc._filter(dec0, rec0, fp, qindex, dict(y=y, u=u, v=v)))
    sec = {k: stages.get(k, (0.0, 0))[0]
           for k in ("device_md_intra", "dlf", "cdef", "host_ec")}
    chosen = [(f.filter_level[0], f.filter_level_uv, f.cdef_strengths)
              for f in headers]
    nbytes = sum(len(p.data) for p in pkts)
    mpsnr = float(np.mean([psnr(f[0], p.recon["y"])
                           for f, p in zip(frames, pkts)]))
    log(f"phase {tag}: {w}x{h} x{len(frames)} M6 qp35 DLF + CDEF through "
        f"send_picture on the default device "
        f"({torch.cuda.get_device_name(0)}): {dt / len(frames):.3f} s per "
        f"frame ({dt:.3f} s), stage seconds dlf {sec['dlf']:.3f}, cdef "
        f"{sec['cdef']:.3f}, device_md_intra {sec['device_md_intra']:.3f}, "
        f"host_ec {sec['host_ec']:.3f}; (luma level, chroma levels, CDEF "
        f"strengths) per frame {chosen}; {nbytes} bytes (per frame "
        f"{[len(p.data) for p in pkts]}), mean Y-PSNR {mpsnr:.4f} dB; SSE "
        f"Y+U+V filtered {sse_f} vs unfiltered {sse_u} "
        f"({(sse_f - sse_u) / sse_u:+.3%}); filter stage of frame 0: "
        f"{prof['launches']} device kernels ({prof['copies']} copies), "
        f"device time {prof['device_ms']} ms, {prof['wall_s']:.3f} s wall "
        f"under the profiler, levels {fp.filter_level[0]}/"
        f"{fp.filter_level_uv}, strengths {fp.cdef_strengths}; fused_txq "
        f"launches {launches} ({card}); decoder on the default device "
        f"matches recon ({dec_s:.1f} s)")
    return pkts, decisions, headers, launches, prof


def phase_cpu_vs_cuda_filters(frames, pkts_cuda, dec_cuda, hdr_cuda):
    pkts_cpu = encode(frames, *CIF, "cpu", 6, batched=False, **FILTERS)
    hdr_cpu = []
    dec_cpu = decode_check(pkts_cpu, "cpu", hdr_cpu)
    agree = block_agreement(dec_cpu, dec_cuda)
    key = lambda f: (f.filter_level, f.filter_level_uv, f.cdef_damping,
                     f.cdef_strengths)
    same_filters = [key(a) for a in hdr_cpu] == [key(b) for b in hdr_cuda]
    p_cpu = np.mean([psnr(f[0], p.recon["y"])
                     for f, p in zip(frames, pkts_cpu)])
    p_gpu = np.mean([psnr(f[0], p.recon["y"])
                     for f, p in zip(frames, pkts_cuda)])
    b_cpu = sum(len(p.data) for p in pkts_cpu)
    b_gpu = sum(len(p.data) for p in pkts_cuda)
    same_bytes = all(a.data == b.data for a, b in zip(pkts_cpu, pkts_cuda))
    log(f"phase 16: {len(frames)} CIF frames at M6 with DLF + CDEF "
        f"(send_picture) cpu vs cuda: {agree:.4%} blocks equal, filters "
        f"{[key(a) for a in hdr_cpu]} vs {[key(b) for b in hdr_cuda]}, "
        f"Y-PSNR {p_cpu:.4f} vs {p_gpu:.4f} dB, bytes {b_cpu} vs {b_gpu}, "
        f"streams identical: {same_bytes}")
    if (agree < MIN_BLOCK_AGREE or not same_filters
            or abs(p_cpu - p_gpu) > MAX_DPSNR
            or abs(b_cpu - b_gpu) > MAX_DBYTES * b_gpu):
        raise AssertionError("cpu and cuda filtered M6 encodes disagree "
                             "beyond the slice's parity thresholds")


# ------------------------------------------------- the GOP slice (17-21) ---

def encode_gop(frames, w, h, device, preset=10, clip=None,
               recon_enabled=True, **cfg):
    """Packets of a GOP encode through send_picture / flush (qp 35 unless
    ``cfg`` sets it), under the setting of the tool clip ``clip``
    (clips.tool_setting: the iris clip's order hints off and wedge
    priced out, as in the reference's test).  recon_enabled=False: the
    shown inter frames come without recon (what a benchmark times)."""
    import clips
    from svt_av1_tpu_torch.api.encoder import Encoder, EncoderConfig
    from svt_av1_tpu_torch.pipeline import gop_fast
    enc = Encoder(EncoderConfig(**dict(dict(source_width=w, source_height=h,
                                            qp=35, enc_mode=preset),
                                       **dict(GOP, **cfg))),
                  device=device)
    enc.recon_enabled = recon_enabled
    with clips.tool_setting(clip, enc, gop_fast):
        for f in frames:
            enc.send_picture(*f)
        enc.flush()
    pkts = []
    while (p := enc.get_packet()) is not None:
        pkts.append(p)
    if sum(p.displayed for p in pkts) != len(frames):
        raise AssertionError(f"{len(pkts)} packets do not display "
                             f"{len(frames)} frames")
    return pkts


def gop_decode_check(pkts, device, shown_limit=None):
    """The port's decoder on ``device`` over a GOP stream: every shown
    frame (show-existing ones included) must equal Packet.recon.  Returns
    (frame headers and decisions of the coded frames, shown count)."""
    from svt_av1_tpu_torch.codec import obu
    from svt_av1_tpu_torch.codec.decoder import Decoder
    dec = Decoder(device=device)
    coded, shown = [], 0
    for p in pkts:
        out = dec.decode_temporal_unit(p.data)
        if len(out) != int(p.displayed):
            raise AssertionError(f"poc {p.pts}: {len(out)} frames shown")
        for rec in out:
            for k in ("y", "u", "v"):
                if not np.array_equal(rec[k], p.recon[k]):
                    raise AssertionError(f"decoder recon differs (plane {k},"
                                         f" poc {p.pts})")
            shown += 1
        if obu.OBU_FRAME in [t for t, _ in obu.parse_obus(p.data)]:
            coded.append((dec.last_frame_header, dec.last_decisions))
        if shown_limit is not None and shown >= shown_limit:
            break
    return coded, shown


def timed_gop(frames, w, h, preset, **cfg):
    """A GOP encode with recon_enabled off (what bench.py times), the
    recon of every coded inter frame kept on the card meanwhile (no
    copy): (packets, {poc: device recon}, seconds, K1 launches, the batch
    sizes K1 had, the host stage seconds)."""
    import torch
    from svt_av1_tpu_torch.api.encoder import Encoder
    from svt_av1_tpu_torch.ops import fused_txq
    from svt_av1_tpu_torch.utils import profiling
    recon = {}
    orig = Encoder._collect_inter_fast

    def keep(self, rec):
        recon[rec[1].poc] = rec[2].recon
        return orig(self, rec)

    torch.cuda.synchronize()
    Encoder._collect_inter_fast = keep
    profiling.reset_stages()
    fused_txq.launches = 0
    seen, fused_txq.batches = fused_txq.batches, set()
    try:
        t0 = time.perf_counter()
        pkts = encode_gop(frames, w, h, None, preset, recon_enabled=False,
                          **cfg)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        Encoder._collect_inter_fast = orig
        batches = sorted(fused_txq.batches)
        fused_txq.batches = seen | fused_txq.batches
    from svt_av1_tpu_torch.codec import obu
    if any(p.recon is not None for p in pkts
           if p.frame_type == obu.INTER_FRAME):
        _fail("recon_enabled=False still copied inter-frame recon")
    return pkts, recon, dt, fused_txq.launches, batches, \
        profiling.stage_stats()


def decode_against(tag, pkts, recon, frames):
    """The port's decoder on the card over a timed_gop stream: every shown
    frame must equal the encoder's recon (Packet.recon on key frames, the
    kept device recon on inter ones).  Returns (the coded frames' headers
    and decisions, mean Y-PSNR of the shown frames, seconds)."""
    from svt_av1_tpu_torch.codec import obu
    from svt_av1_tpu_torch.codec.decoder import Decoder
    t0 = time.perf_counter()
    dec = Decoder()
    coded, ys = [], []
    for p in pkts:
        for rec in dec.decode_temporal_unit(p.data):
            want = p.recon or {k: v.cpu().numpy()
                               for k, v in recon[p.pts].items()}
            for k in ("y", "u", "v"):
                if not np.array_equal(rec[k], want[k]):
                    _fail(f"phase {tag}: decoder recon differs (plane {k}, "
                          f"poc {p.pts})")
            ys.append(psnr(frames[p.pts][0], want["y"]))
        if obu.OBU_FRAME in [t for t, _ in obu.parse_obus(p.data)]:
            coded.append((dec.last_frame_header, dec.last_decisions))
    if len(ys) != len(frames):
        _fail(f"phase {tag}: {len(ys)} frames shown of {len(frames)}")
    return coded, float(np.mean(ys)), time.perf_counter() - t0


def gop_block_counts(coded):
    """Blocks of the coded inter frames by kind."""
    from svt_av1_tpu_torch.codec import constants as cc
    from svt_av1_tpu_torch.codec import obu
    n = dict(blocks=0, inter=0, intra=0, compound=0, wedge=0, diffwtd=0,
             warp=0, merged=0, split8=0, itx=0, obmc=0, ii=0, tmvp_frames=0)
    for fp, dec in coded:
        if fp.frame_type != obu.INTER_FRAME:
            continue
        n["tmvp_frames"] += bool(fp.use_ref_frame_mvs)
        for b in dec.values():
            n["blocks"] += 1
            n["inter" if b.is_inter else "intra"] += 1
            n["compound"] += bool(b.is_inter and b.ref2)
            n["wedge"] += bool(b.ref2 and b.comp_type == 1)
            n["diffwtd"] += bool(b.ref2 and b.comp_type == 2)
            n["warp"] += bool(b.use_warp)
            n["merged"] += b.bsize not in (cc.BLOCK_16X16, cc.BLOCK_8X8)
            n["split8"] += b.bsize == cc.BLOCK_8X8
            n["itx"] += bool(b.is_inter and b.tx_type != cc.DCT_DCT
                             and np.any(b.qcoeff_y))
            n["obmc"] += bool(b.is_inter and b.motion_mode == 1)
            n["ii"] += bool(b.is_inter and b.interintra_mode >= 0)
    return n


def inter_frame_profile(frames, w, h, preset=10):
    """One inter frame (the middle frame coded from the first and the
    last, LAST + ALTREF) run alone: host seconds of P1 + P2 dispatch, to
    device idle, and of the collect, and the device kernels of the whole
    frame under torch.profiler (device busy share = device time / wall
    time)."""
    import torch
    from svt_av1_tpu_torch.utils import kernel_profile
    dispatch, collect = kernel_profile.inter_frame(frames, w, h, preset)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pend = dispatch()
    t_dispatch = time.perf_counter() - t0
    torch.cuda.synchronize()
    t_all = time.perf_counter() - t0
    t1 = time.perf_counter()
    collect(pend)
    t_collect = time.perf_counter() - t1
    prof = kernel_profile.device_kernels(lambda: collect(dispatch()), top=8)
    busy = (prof["device_ms"] / 1000.0 / prof["wall_s"]
            if isinstance(prof["device_ms"], float) else "not measured")
    return dict(dispatch_s=t_dispatch, dispatch_and_device_s=t_all,
                collect_s=t_collect, prof=prof, busy=busy)


def phase_gop(tag, frames, w, h, card, preset=10, warm=None,
              shown_limit=None, profile=True):
    """A GOP through send_picture / flush on the default device: a warm
    run over the first ``warm`` frames (all by default; 0: none), then the
    timed hot run with K1's count set to 0 before and read after; the
    port's decoder on the card over the stream; one inter frame profiled
    alone."""
    import torch
    from svt_av1_tpu_torch.codec import obu
    from svt_av1_tpu_torch.ops import fused_txq
    from svt_av1_tpu_torch.utils import profiling
    warm = len(frames) if warm is None else warm
    if warm:
        encode_gop(frames[:warm], w, h, None, preset)
    torch.cuda.synchronize()
    profiling.reset_stages()
    fused_txq.launches = 0
    t0 = time.perf_counter()
    pkts = encode_gop(frames, w, h, None, preset)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = fused_txq.launches
    stages = profiling.stage_stats()
    if launches <= 0:
        raise AssertionError(f"phase {tag}: the GOP path never launched "
                             "fused_txq")
    t1 = time.perf_counter()
    coded, shown = gop_decode_check(pkts, None, shown_limit)
    dec_s = time.perf_counter() - t1
    n = gop_block_counts(coded)
    for k in ("inter", "compound"):
        if n[k] <= 0:
            raise AssertionError(f"phase {tag}: no {k} block")
    n_inter = sum(1 for p in pkts if p.frame_type == obu.INTER_FRAME
                  and len(p.data) > 8)
    n_key = sum(1 for p in pkts if p.frame_type == obu.KEY_FRAME)
    disp = sorted((p for p in pkts if p.displayed), key=lambda p: p.pts)
    mpsnr = float(np.mean([psnr(frames[p.pts][0], p.recon["y"])
                           for p in disp]))
    nbytes = sum(len(p.data) for p in pkts)
    sec = {k: round(v[0], 3) for k, v in sorted(stages.items())}
    per_inter = stages.get("dispatch_inter", (0.0, 0))[0] / max(n_inter, 1)
    prof_txt = ""
    prof = None
    if profile:
        prof = inter_frame_profile(frames, w, h, preset)
        busy = prof["busy"]
        prof_txt = (
            f"; one inter frame alone (LAST + ALTREF): P1 + P2 dispatch "
            f"{prof['dispatch_s']:.3f} s host, "
            f"{prof['dispatch_and_device_s']:.3f} s to device idle, collect "
            f"{prof['collect_s']:.4f} s; "
            f"{prof['prof']['launches']} device kernels, device time "
            f"{prof['prof']['device_ms']} ms in {prof['prof']['wall_s']:.3f} "
            f"s under the profiler (device busy "
            f"{busy if isinstance(busy, str) else f'{busy:.1%}'}); top "
            f"{[(k['name'], k['count'], round(k['ms'], 3))
                for k in prof['prof']['top_kernels']]}")
    log(f"phase {tag}: GOP {w}x{h} x{len(frames)} M{preset} qp35 "
        f"hierarchical_levels 3 keyint 15 DLF + CDEF through send_picture "
        f"/ flush on the default device ({torch.cuda.get_device_name(0)}): "
        f"{len(frames) / dt:.3f} fps hot ({dt:.3f} s; {n_key} key, "
        f"{n_inter} inter, {len(pkts) - n_key - n_inter} show-existing "
        f"packets), {per_inter:.3f} s host dispatch per inter frame, "
        f"{nbytes} bytes, mean Y-PSNR {mpsnr:.4f} dB; host stage seconds "
        f"{sec}; inter-frame blocks {n}; fused_txq launches {launches} "
        f"({card}); decoder on the default device matches recon over "
        f"{shown} shown frames ({dec_s:.1f} s){prof_txt}")
    return pkts, coded, launches, prof


def _headers_key(coded):
    return [(fp.gm_trans, fp.interpolation_filter) for fp, _ in coded]


def _same_inter_block(a, b, tx=True):
    return (b is not None and a.bsize == b.bsize and a.is_inter == b.is_inter
            and a.y_mode == b.y_mode and a.mv == b.mv and a.ref == b.ref
            and a.ref2 == b.ref2 and a.mv2 == b.mv2
            and a.use_warp == b.use_warp and a.comp_type == b.comp_type
            and a.wedge_idx == b.wedge_idx and a.wedge_sign == b.wedge_sign
            and a.motion_mode == b.motion_mode
            and a.interintra_mode == b.interintra_mode
            and (not tx or (a.tx_type == b.tx_type
                            and np.array_equal(a.qcoeff_y, b.qcoeff_y))))


def gop_cpu_vs_cuda(name, frames, need=None, tag="20", preset=10,
                    clip=None, **kw):
    """One GOP encoded on the CPU and on the card, each decoded by the
    port's decoder on its device (every shown frame equal to
    Packet.recon): block agreement, bytes, identity; the frames whose GM
    model or interp pick differ and the wedge blocks whose option differs
    are the counted ties.  ``need``: a block kind of gop_block_counts that
    the card's stream must code at least once (the tool of a tool clip,
    whose setting the encodes take).  Returns the coded frames' (header,
    decisions) of the CPU's and the card's stream."""
    h, w = frames[0][0].shape
    clip = clip or (name if need else None)
    pc = encode_gop(frames, w, h, "cpu", preset, clip=clip, **kw)
    pg = encode_gop(frames, w, h, None, preset, clip=clip, **kw)
    cc_, _ = gop_decode_check(pc, "cpu")
    cg, _ = gop_decode_check(pg, None)
    same = tot = wedge_ties = tx_flips = 0
    for (_, a), (_, b) in zip(cc_, cg):
        for k, blk in a.items():
            tot += 1
            o = b.get(k)
            same += _same_inter_block(blk, o)
            # the inter tx-type search's float32 transforms: a tie flips
            # the type (and so the levels) of a block alike otherwise
            tx_flips += bool(o is not None and blk.tx_type != o.tx_type
                             and _same_inter_block(blk, o, tx=False))
            wedge_ties += bool(o is not None and blk.comp_type == 1
                               and o.comp_type == 1
                               and (blk.wedge_idx, blk.wedge_sign)
                               != (o.wedge_idx, o.wedge_sign))
    ties = sum(a != b for a, b in zip(_headers_key(cc_), _headers_key(cg)))
    bc, bg = sum(len(p.data) for p in pc), sum(len(p.data) for p in pg)
    agree = same / max(tot, 1)
    dps = abs(np.mean([psnr(frames[p.pts][0], p.recon["y"]) for p in pc
                       if p.displayed])
              - np.mean([psnr(frames[p.pts][0], p.recon["y"]) for p in pg
                         if p.displayed]))
    identical = [p.data for p in pc] == [p.data for p in pg]
    n_c, n_g = gop_block_counts(cc_), gop_block_counts(cg)
    log(f"phase {tag}: GOP {name} {w}x{h} x{len(frames)} M{preset} {kw}"
        f"{' (order hints off, wedge priced out)' if name == 'iris' else ''}"
        f" cpu vs cuda:"
        f" {agree:.4%} of {tot} blocks equal, bytes {bc} vs {bg}, "
        f"|dY-PSNR| {dps:.4f} dB, streams identical: {identical}; counted "
        f"ties: frames whose GM model or interp pick differ {ties}, wedge "
        f"blocks whose option differs {wedge_ties}, blocks whose inter tx "
        f"type alone differs {tx_flips}; inter-frame blocks cpu "
        f"{n_c}, cuda {n_g}; both decoders match recon")
    if (agree < MIN_BLOCK_AGREE or dps > MAX_DPSNR
            or abs(bc - bg) > MAX_DBYTES * bg):
        raise AssertionError(f"cpu and cuda GOP encodes of {name} disagree "
                             "beyond the slice's parity thresholds")
    for k in ((need,) if isinstance(need, str) else need or ()):
        if n_g[k] <= 0:
            raise AssertionError(f"the card's {name} stream codes no {k}")
    return cc_, cg


def phase_gop_cpu_vs_cuda():
    """A 5-frame GOP (hierarchical_levels 2, keyint 4) of the natural clip
    at 96x96, then the wedge, diffwtd and warp clips, on the CPU and on the
    card (gop_cpu_vs_cuda)."""
    import clips
    gop_cpu_vs_cuda("natural", clips.natural_clip(5, 96, 96, seed=2),
                    hierarchical_levels=2, intra_period_length=4)
    for name, (clip, kw, need) in clips.TOOL_CLIPS.items():
        gop_cpu_vs_cuda(name, clip(), need=need, hierarchical_levels=2,
                        **kw)


def phase_motion_ops():
    """The GOP slice's device ops on the card against the port's CPU run
    on the same seeded inputs at CIF shapes: exact, apart from the GM fit
    (float32 least squares) under its tie rule."""
    import torch
    from svt_av1_tpu_torch.ops import convolve, mc, me, warp
    from svt_av1_tpu_torch.pipeline import gop_fast
    from svt_av1_tpu_torch.pipeline import me as me_pipe
    rng = np.random.default_rng(17)
    both = lambda a: (torch.from_numpy(np.ascontiguousarray(a, np.int32)),
                      torch.from_numpy(np.ascontiguousarray(
                          a, np.int32)).cuda())
    eq = lambda c, g, what: None if torch.equal(c, g.cpu()) else (
        _fail(f"{what} differs between cuda and cpu"))
    nb = 396 * 5                  # CIF blocks x the five level-0 seeds
    s = both(rng.integers(0, 256, (nb, 16, 16)))
    wdw = both(rng.integers(0, 256, (nb, 24, 24)))
    eq(me.ssd_search(s[0], wdw[0]), me.ssd_search(s[1], wdw[1]),
       "ssd_search")
    f0, f1 = synth_frames(2, 384, 320)
    src, ref = both(f1[0]), both(f0[0])
    run = me_pipe.hme_core(320, 384, 6, 8, 4)
    hc, hg = run(src[0], ref[0]), run(src[1], ref[1])
    for a, b in zip(hc, hg):
        eq(a, b, "hme_core")
    gm_ties = 0
    for dy, dx in ((0, 0), (3, -2)):
        mvy, mvx = hc[0] + dy, hc[1] + dx
        gc = gop_fast._gm_fit(mvy, mvx, 20, 24)
        gg = gop_fast._gm_fit(mvy.cuda(), mvx.cuda(), 20, 24)
        if not all(torch.equal(a, b.cpu()) for a, b in zip(gc, gg)):
            raw = gop_fast._gm_fit(mvy, mvx, 20, 24, dtype=torch.float64,
                                   raw=True)[3].numpy()
            if np.min(np.abs(np.abs(raw - np.floor(raw)) - 0.5)) >= 1e-3:
                _fail("_gm_fit differs between cuda and cpu off a tie")
            gm_ties += 1
    win = [both(rng.integers(0, 256, (nb, 23, 23))) for _ in range(2)]
    ph = [both(rng.integers(0, 16, nb)) for _ in range(4)]
    for k in (0, 1, 2):
        eq(convolve.convolve_2d_sr(win[0][0], ph[0][0], ph[1][0], 16, 16, k,
                                   k),
           convolve.convolve_2d_sr(win[0][1], ph[0][1], ph[1][1], 16, 16, k,
                                   k), f"convolve_2d_sr kind {k}")
    a_c = [win[0][0], win[1][0]] + [p[0] for p in ph]
    a_g = [win[0][1], win[1][1]] + [p[1] for p in ph]
    eq(convolve.convolve_2d_compound_avg(*a_c, 16, 16),
       convolve.convolve_2d_compound_avg(*a_g, 16, 16), "compound avg")
    inv = both(np.arange(nb) % 2)
    dc = convolve.convolve_2d_compound_diffwtd(*a_c, 16, 16, inv[0])
    dg = convolve.convolve_2d_compound_diffwtd(*a_g, 16, 16, inv[1])
    eq(dc[0], dg[0], "compound diffwtd")
    eq(dc[1], dg[1], "diffwtd mask")
    m = both(rng.integers(0, 65, (nb, 16, 16)))
    eq(convolve.convolve_2d_compound_masked(*a_c, 16, 16, m[0]),
       convolve.convolve_2d_compound_masked(*a_g, 16, 16, m[1]),
       "compound masked")
    h, w = CIF[1], CIF[0]
    ys = np.arange(396) // 22 * 16
    xs = np.arange(396) % 22 * 16
    mvs = rng.integers(-600, 600, (396, 2, 2))
    yy, xx, mv0, mv1 = both(ys), both(xs), both(mvs[:, 0]), both(mvs[:, 1])
    cand = [gop_fast._clamp_cands(mv[i][:, None], yy[i], xx[i], 16, h,
                                  w)[:, 0] for mv in (mv0, mv1)
            for i in (0, 1)]
    eq(cand[0], cand[1], "_clamp_cands")
    refp = [mc.pad_plane(t, mc.PAD) for t in both(f0[0][:h, :w])]
    for kind in (0, 2):
        eq(mc.mc_blocks(refp[0], yy[0], xx[0], cand[0], 16, mc.PAD,
                        kind=kind),
           mc.mc_blocks(refp[1], yy[1], xx[1], cand[1], 16, mc.PAD,
                        kind=kind), f"mc_blocks kind {kind}")
    refc = [mc.pad_plane(t, mc.PAD // 2) for t in both(f0[1][:h // 2,
                                                              :w // 2])]
    eq(mc.mc_blocks(refc[0], yy[0] // 2, xx[0] // 2, cand[0], 8, mc.PAD, 1),
       mc.mc_blocks(refc[1], yy[1] // 2, xx[1] // 2, cand[1], 8, mc.PAD, 1),
       "mc_blocks chroma")
    eq(mc.mc_blocks_compound(refp[0], refp[0].flip(0), yy[0], xx[0], cand[0],
                             cand[2], 16, mc.PAD),
       mc.mc_blocks_compound(refp[1], refp[1].flip(0), yy[1], xx[1], cand[1],
                             cand[3], 16, mc.PAD), "mc_blocks_compound")
    inv = both(np.arange(396) % 2)
    dc = mc.mc_blocks_compound_diffwtd(refp[0], refp[0].flip(0), yy[0], xx[0],
                                       cand[0], cand[2], 16, mc.PAD, inv[0])
    dg = mc.mc_blocks_compound_diffwtd(refp[1], refp[1].flip(0), yy[1], xx[1],
                                       cand[1], cand[3], 16, mc.PAD, inv[1])
    eq(dc[0], dg[0], "mc_blocks_compound_diffwtd")
    n_warp = 0
    for mat in ((-3000, 5000, 65536 + 900, 700, -700, 65536 + 900),
                (12000, -7000, 65536 - 1500, -1200, 1200, 65536 - 1500)):
        for ss, plane in ((0, f0[0][:h, :w]), (1, f0[1][:h // 2, :w // 2])):
            pc, pg = both(plane)
            ph_, pw_ = plane.shape
            eq(warp.warp_plane(pc, mat, pw_, ph_, subsampling=ss),
               warp.warp_plane(pg, mat, pw_, ph_, subsampling=ss),
               "warp_core")
            n_warp += 1
    wedge_ties = wedge_pick_ties(rng)
    log(f"phase 17: GOP device ops exact cuda vs cpu: ssd_search on {nb} "
        f"16x16 blocks, hme_core 384x320 (M10 radii), convolve_2d_sr x3 "
        f"kinds, compound avg / diffwtd / masked on {nb} blocks, "
        f"_clamp_cands, mc_blocks (luma x2 kinds, chroma), "
        f"mc_blocks_compound, mc_blocks_compound_diffwtd on the CIF grid, "
        f"warp_core on {n_warp} planes; _gm_fit cuda vs cpu ties "
        f"(float64 value within 1e-3 of a rounding boundary): {gm_ties}; "
        f"_wedge_pick on 396 CIF blocks cuda vs cpu ties (float64 SSEs of "
        f"the two picks within 1e-6 relative): {wedge_ties}")


def wedge_pick_ties(rng):
    """The wedge pick of _eval_pair (float32 SSE algebra over the 32
    options) on the card and on the CPU for the CIF grid's 396 blocks:
    a differing pick is a tie when the two picks' float64 SSEs lie within
    1e-6 relative.  Returns the number of ties."""
    import torch
    from svt_av1_tpu_torch.pipeline import gop_fast
    src, pA, pB = (rng.integers(0, 256, (396, 256)) for _ in range(3))
    pA[::4] = pB[::4]                       # e = 0: all 32 options tie
    d1 = torch.from_numpy((src - pB).astype(np.float32))
    e = torch.from_numpy((pA - pB).astype(np.float32))
    pick = lambda d, x: gop_fast._wedge_pick(
        d, x, *gop_fast._wedge_masks_on(d.device)[:2]).cpu().numpy()
    got_c, got_g = pick(d1, e), pick(d1.cuda(), e.cuda())
    m = gop_fast._wedge_masks_on(d1.device)[0].numpy().astype(np.float64)
    sse = ((d1.numpy().astype(np.float64)[:, None] - m[None]
            * e.numpy().astype(np.float64)[:, None]) ** 2).sum(2)
    rows = np.arange(396)
    diff = got_c != got_g
    a, b = sse[rows, got_c], sse[rows, got_g]
    if np.any(np.abs(a - b)[diff] > 1e-6 * np.maximum(a, b)[diff]):
        _fail("_wedge_pick differs between cuda and cpu off a tie")
    return int(diff.sum())


# ------------------------------------------- the lookahead slice (22-24) ---

def waves_per_frame(w, h):
    """The number of 2:1 waves of a w x h frame's 16x16 grid: K1's
    launches per key frame with a frame quantizer, and per inter frame's
    pass B."""
    from svt_av1_tpu_torch.pipeline import intra_encoder
    gh, gw = -(-h // 16), -(-w // 16)
    return intra_encoder._schedule_arrays(
        gh, gw, intra_encoder._natural_maxb(gh, gw))[1].shape[0]


def minigop_group(srcs, n):
    """The encoder's TPL group of the mini-GoP of n frames after anchor 0,
    with an IPP tail of up to n frames: (sources, deps)."""
    from svt_av1_tpu_torch.pipeline import gop, tpl
    order, deps = tpl.minigop_group(0, gop.minigop_schedule(0, n),
                                    range(n + 1, min(2 * n + 1, len(srcs))))
    return [srcs[p] for p in order], deps


def mctf_flips(center, neighbors, card_out, cpu_out):
    """Flips of the card's MCTF planes against the CPU's under the pixel
    tie rule (tests/tie_rule.py; the exact values from a float64 run on
    the CPU): [luma, chroma]."""
    import torch
    import tie_rule
    from svt_av1_tpu_torch.pipeline import tf_stage
    exact = tf_stage.mctf_filter_frame(center, neighbors, device="cpu",
                                       dtype=torch.float64, raw=True)
    f = [tie_rule.pixel_flips(g, c, e)[0]
         for g, c, e in zip(card_out, cpu_out, exact)]
    return [f[0], f[1] + f[2]]


def phase_lookahead_ops():
    """The lookahead's device ops on the card against the port's CPU run
    at CIF: SATD and TPL's group stats exact (a key's 9-frame IPP chain,
    a 3-level mini-GoP with its 8-frame IPP tail), the temporal filter on
    CIF's 99 32x32 blocks (F = 3) and mctf_filter_frame (the key's 2
    neighbours, the base's 3) under the pixel tie rule, flips counted."""
    import torch
    import tie_rule
    from svt_av1_tpu_torch.ops import satd
    from svt_av1_tpu_torch.ops import tf as tf_ops
    from svt_av1_tpu_torch.pipeline import gop_fast, tf_stage
    rng = np.random.default_rng(23)
    d = rng.integers(-255, 256, (396 * 4, 8, 8)).astype(np.int32)
    d[:16] = 255
    dt = torch.from_numpy(d)
    if not torch.equal(satd.satd(dt), satd.satd(dt.cuda()).cpu()):
        _fail("satd differs between cuda and cpu")
    frames = synth_frames(17, *CIF)
    srcs = [f[0] for f in frames]
    groups = dict(key_chain=(srcs[:9], [None] + [[i] for i in range(8)]),
                  minigop=minigop_group(srcs, 8))
    t_tpl = {}
    for name, (group, deps) in groups.items():
        st_c = gop_fast.tpl_group_stats(group, deps, device="cpu")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st_g = gop_fast.tpl_group_stats(group, deps, device=None)
        t_tpl[name] = time.perf_counter() - t0
        for a, b in zip(st_c, st_g):
            for k in ("intra", "inter", "mv", "ref_sel"):
                if not np.array_equal(a[k], b[k]):
                    _fail(f"tpl_group_stats {name} {k} differs between "
                          "cuda and cpu")
    tiles = lambda y: (y.reshape(9, 32, 11, 32).transpose(0, 2, 1, 3)
                       .reshape(99, 32, 32).astype(np.int32))
    center = tiles(srcs[8])
    preds = np.stack([tiles(srcs[i]) for i in (7, 9, 6)], 1)
    sq = (center[:, None].astype(np.int64) - preds) ** 2
    berr = (np.stack([sq[..., :16, :16].sum((-2, -1)),
                      sq[..., :16, 16:].sum((-2, -1)),
                      sq[..., 16:, :16].sum((-2, -1)),
                      sq[..., 16:, 16:].sum((-2, -1))], -1)
            / 256.0).astype(np.float32)
    mvs = rng.integers(-6, 7, (99, 3, 4, 2)).astype(np.float32)
    args = [torch.from_numpy(a) for a in (center, preds, berr, mvs)]
    f_c = tf_ops.temporal_filter(*args, decay_factor=80.0).numpy()
    f_g = tf_ops.temporal_filter(*(a.cuda() for a in args),
                                 decay_factor=80.0).cpu().numpy()
    exact = tf_ops.temporal_filter(*args, decay_factor=80.0,
                                   dtype=torch.float64, raw=True).numpy()
    tf_flips = tie_rule.pixel_flips(f_g, f_c, exact)[0]
    mctf = {}
    for name, (c, nb) in dict(key=(0, (1, 2)), base=(8, (7, 9, 6))).items():
        neighbors = [frames[i] for i in nb]
        out_c = tf_stage.mctf_filter_frame(frames[c], neighbors,
                                           device="cpu")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_g = tf_stage.mctf_filter_frame(frames[c], neighbors, device=None)
        t = time.perf_counter() - t0
        mctf[name] = (mctf_flips(frames[c], neighbors, out_g, out_c), t)
    log(f"phase 22: lookahead ops cuda vs cpu at CIF: satd on {len(d)} "
        f"8x8 blocks exact; tpl_group_stats exact over the key chain (9 "
        f"frames) and the mini-GoP (17 frames, 23 references), "
        f"{t_tpl['key_chain']:.3f} / {t_tpl['minigop']:.3f} s on the card "
        f"(first calls); temporal_filter on 99 32x32 blocks F=3 flips "
        f"(pixel tie rule, exact value within 1e-3 of .5) {tf_flips}; "
        f"mctf_filter_frame flips [luma, chroma] key (F=2) "
        f"{mctf['key'][0]}, base (F=3) {mctf['base'][0]}, "
        f"{mctf['key'][1]:.3f} / {mctf['base'][1]:.3f} s on the card")


def phase_lookahead_gop(card, frames):
    """The previous slice's main path: the CIF GOP with the lookahead on
    (MCTF and TPL, delta-q key frames), M10, DLF + CDEF, through
    send_picture / flush on the default device, timed with recon_enabled
    off (timed_gop; phases 18-22 ran every program at CIF, so no separate
    warm run), K1's count set to 0 before and read after: its launches
    must equal the waves of every frame that is not a delta-q key frame
    (such a frame takes the per-block quantizer and the plain transform,
    as in the reference); then every shown frame decoded on the card
    against the encoder's recon (decode_against)."""
    import torch
    from svt_av1_tpu_torch.codec import obu
    w, h = CIF
    pkts, recon, dt, launches, _, stages = timed_gop(frames, w, h, 10,
                                                     **LOOKAHEAD)
    coded, mpsnr, dec_s = decode_against("23", pkts, recon, frames)
    keys = [(fp, dec) for fp, dec in coded if fp.frame_type == obu.KEY_FRAME]
    dq = [(fp, dec) for fp, dec in keys if fp.delta_q_present]
    qrange = [(fp.base_q_idx, min(b.qindex for b in dec.values()),
               max(b.qindex for b in dec.values())) for fp, dec in dq]
    waves = waves_per_frame(w, h)
    want = waves * (len(coded) - len(dq))
    if launches != want:
        _fail(f"fused_txq launched {launches} times, {want} predicted "
              f"({waves} waves x {len(coded)} coded frames, {len(dq)} of "
              "them delta-q key frames)")
    n_inter = sum(1 for p in pkts if p.frame_type == obu.INTER_FRAME
                  and len(p.data) > 8)
    per_inter = stages.get("dispatch_inter", (0.0, 0))[0] / max(n_inter, 1)
    sec = {k: round(v[0], 3) for k, v in sorted(stages.items())}
    la = {k: (round(stages[k][0], 3), stages[k][1])
          for k in ("key_tf", "key_tpl", "gop_tf", "gop_tpl",
                    "gop_tpl_synth") if k in stages}
    nbytes = sum(len(p.data) for p in pkts)
    log(f"phase 23: GOP {w}x{h} x{len(frames)} M10 qp35 "
        f"hierarchical_levels 3 keyint 15 MCTF + TPL DLF + CDEF through "
        f"send_picture / flush on the default device "
        f"({torch.cuda.get_device_name(0)}), recon_enabled off: "
        f"{len(frames) / dt:.3f} fps ({dt:.3f} s; {len(keys)} key, "
        f"{n_inter} inter packets), {per_inter:.3f} s host dispatch per "
        f"inter frame, {nbytes} bytes, mean Y-PSNR {mpsnr:.4f} dB; "
        f"lookahead stage seconds (total, calls) {la}; all host "
        f"stage seconds {sec}; delta-q key frames {len(dq)} of "
        f"{len(keys)} (base qindex, qmap min, max) {qrange} (the bench "
        f"clip moves uniformly, so TPL may find every superblock alike; "
        f"phase 24 codes delta-q on the card); fused_txq "
        f"launches {launches} = {waves} waves x {len(coded) - len(dq)} "
        f"frames without delta-q (of 840 / 896 / 952 for 2 / 1 / 0 "
        f"delta-q key frames) ({card}); decoded on the default device, "
        f"equal to the encoder's recon over {len(frames)} shown frames "
        f"({dec_s:.1f} s)")
    return pkts, launches


def phase_lookahead_cpu_vs_cuda():
    """The 7-frame 128x96 lookahead GOP of tests/test_torch_lookahead.py
    (clips.split_motion_clip, M10, hierarchical_levels 2, keyint 4, MCTF +
    TPL) on the CPU and on the card (gop_cpu_vs_cuda), every MCTF call's
    planes compared under the pixel tie rule; the card's stream must code
    a delta-q key frame."""
    import clips
    from svt_av1_tpu_torch.codec import obu
    from svt_av1_tpu_torch.pipeline import tf_stage
    frames = clips.split_motion_clip(7)
    calls = []
    orig = tf_stage.mctf_filter_frame

    def record(center, neighbors, *a, **k):
        out = orig(center, neighbors, *a, **k)
        calls.append((center, neighbors, out))
        return out

    tf_stage.mctf_filter_frame = record
    try:
        _, coded_g = gop_cpu_vs_cuda(
            "split_motion", frames, tag="24", hierarchical_levels=2,
            intra_period_length=4, **LOOKAHEAD)
    finally:
        tf_stage.mctf_filter_frame = orig
    half = len(calls) // 2                  # the CPU's calls, then the card's
    flips = [mctf_flips(c[0], c[1], g[2], c[2])
             for c, g in zip(calls[:half], calls[half:])]
    dq = sum(fp.delta_q_present for fp, _ in coded_g
             if fp.frame_type == obu.KEY_FRAME)
    log(f"phase 24: the lookahead GOP's {half} MCTF calls cuda vs cpu, "
        f"flips [luma, chroma] {flips}; delta-q key frames on the card "
        f"{dq}")
    if len(calls) != 2 * half or not dq:
        _fail("the card's lookahead GOP is not the CPU's (MCTF calls) or "
              "codes no delta-q key frame")


# bench.py's primary GOP config (bench.py:86-91): M6, keyint 15, 3-level
# mini-GoPs, TPL + MCTF, DLF, CDEF level 1, qp 35
M6_BENCH = dict(hierarchical_levels=3, intra_period_length=15, enable_tf=1,
                enable_tpl_la=1, **FILTERS)


def phase_m6_gop(card, frames):
    """This slice's main path: bench.py's primary config (the CIF x17 GOP
    at M6 with TPL + MCTF, DLF and CDEF) through send_picture / flush on
    the default device.  A warm run over a 3-frame prefix (a key frame and
    a mini-GoP of 2: both P1 shapes, P2, MCTF and TPL at CIF; phase 27
    ran the M6 tools at small sizes), then the timed run with
    recon_enabled off as bench.py runs it (timed_gop), K1's count set to
    0 before and read after: K1 runs on the pass B of every inter frame,
    at B = 88 (M6 key frames search four tx types and do not take it);
    then every shown frame decoded on the card against the encoder's
    recon (decode_against)."""
    import torch
    from svt_av1_tpu_torch.codec import obu
    w, h = CIF
    t0 = time.perf_counter()
    encode_gop(frames[:3], w, h, None, 6, **M6_BENCH)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    pkts, recon, dt, launches, batches, stages = timed_gop(frames, w, h, 6,
                                                           **M6_BENCH)
    coded, mpsnr, dec_s = decode_against("26", pkts, recon, frames)
    n = gop_block_counts(coded)
    n_inter = sum(fp.frame_type == obu.INTER_FRAME for fp, _ in coded)
    waves = waves_per_frame(w, h)
    b = k1_batch(1, CIF, 6)
    if launches != waves * n_inter or batches != [b]:
        _fail(f"phase 26: fused_txq launched {launches} times at batches "
              f"{batches}; {waves} waves x {n_inter} inter frames at B = {b}"
              " predicted")
    per_inter = stages.get("dispatch_inter", (0.0, 0))[0] / max(n_inter, 1)
    st = {k: (round(stages[k][0], 3), stages[k][1])
          for k in ("key_tf", "key_tpl", "gop_tf", "gop_tpl",
                    "gop_tpl_synth", "tmvp_setup", "save_mvfield", "host_ec",
                    "device_md_inter") if k in stages}
    nbytes = sum(len(p.data) for p in pkts)
    log(f"phase 26: the main path: bench.py's primary config, GOP {w}x{h} "
        f"x{len(frames)} M6 qp35 hierarchical_levels 3 keyint 15 MCTF + TPL "
        f"DLF + CDEF through send_picture / flush on the default device "
        f"({torch.cuda.get_device_name(0)}), recon_enabled off: "
        f"{len(frames) / dt:.4f} fps hot ({dt:.3f} s; warm 3-frame prefix "
        f"{warm_s:.1f} s), {per_inter:.3f} s host dispatch per inter frame "
        f"({n_inter} inter frames), {nbytes} bytes, mean Y-PSNR "
        f"{mpsnr:.4f} dB; stage seconds (total, calls) {st}; inter-frame "
        f"blocks {n} (use_ref_frame_mvs on {n['tmvp_frames']} of {n_inter} "
        f"inter frames); fused_txq launches {launches} = {waves} waves x "
        f"{n_inter} inter frames at B = {b} ({card}); decoded on the card, "
        f"equal to the encoder's recon over {len(frames)} shown frames "
        f"({dec_s:.1f} s)")
    return launches


def phase_m6_tools_cpu_vs_cuda():
    """The M5-M9 clips of tests/test_torch_gop_m6.py on the CPU and on the
    card (gop_cpu_vs_cuda, with each clip's pinned features as the
    reference's tool-isolation tests pin them): OBMC (seam texture, M6
    without part8 and the tx search), inter-intra (gradient wipe, the
    same), the 8x8 split + TMVP (boundary clip, M6), M8's full tools and
    M9 on the natural clip; each card stream must code its tool."""
    import clips
    off = dict(enable_dlf_flag=0, cdef_level=0)
    runs = (("obmc_m6", clips.seam_clip(), 6, "obmc",
             dict(qp=50, intra_period_length=31, **off)),
            ("ii_m6", clips.gradient_wipe_clip(), 6, "ii",
             dict(qp=45, intra_period_length=31, **off)),
            ("part8_tmvp_m6", clips.boundary_clip(), 6,
             ("split8", "tmvp_frames"), dict(qp=40, intra_period_length=15)),
            ("m8", clips.natural_clip(5, 64, 64, seed=1), 8, "itx",
             dict(intra_period_length=4)),
            ("m9", clips.natural_clip(5, 64, 64, seed=1), 9, "compound",
             dict(intra_period_length=4)))
    for name, frames, preset, need, kw in runs:
        gop_cpu_vs_cuda(name, frames, need=need, tag="27", preset=preset,
                        clip=name, hierarchical_levels=2, **kw)


def _fail(msg):
    raise AssertionError(msg)


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from svt_av1_tpu_torch import device as device_mod
    from svt_av1_tpu_torch import kernels

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    device_mod.resolve("cuda")
    print(smi, flush=True)
    log(f"phase 1: torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s), python "
        f"{sys.version.split()[0]}")

    t0 = time.perf_counter()
    out = kernels.build()
    kernels.lib()
    build_s = time.perf_counter() - t0
    ptxas = " | ".join(ln.strip() for ln in out.splitlines()
                       if "registers" in ln or "spill" in ln)
    log(f"phase 2: built {len(kernels.sources())} kernel source(s) in "
        f"{build_s:.1f} s into {kernels.LIB_PATH}; ptxas: "
        f"{ptxas}")

    card = smi
    krec = phase_kernel(card)
    phase_goldens()
    from svt_av1_tpu_torch.ops import fused_txq
    fused_txq.batches.clear()           # from here on: the paths' batches

    # this slice first (in a fresh process, so that nothing the earlier
    # paths left behind weighs on the main path's timing): the GOP at
    # M5-M9, its tools on small clips, then bench.py's primary config
    cif17 = synth_frames(17, *CIF)
    by_path = {}
    phase_m6_tools_cpu_vs_cuda()
    m6_launches = phase_m6_gop(card, cif17)
    by_path["M6 GOP MCTF+TPL CIF x17"] = m6_launches

    import clips
    # the paths of the earlier slices at a cut depth (8 CIF / 2 720p
    # frames a batch, 3 CIF and 1 720p key frames at M6), so that the
    # whole script fits the time limit
    cif = synth_frames(CIF_FRAMES, *CIF)
    hd = synth_frames(HD_FRAMES, *HD)
    pkts_cif, dec_cif, by_path["M10 send_pictures CIF x8"] = phase_encode(
        "5", cif, *CIF, card)
    by_path["M10 send_pictures 720p x2"] = phase_encode(
        "6", hd, *HD, card)[2]
    phase_cpu_vs_cuda(cif[:4], pkts_cif, dec_cif)
    del pkts_cif, dec_cif

    phase_tools()
    key_cif = cif[:2] + [clips.screen_frame(*CIF, seed=1)]
    pk_m6, dec_m6, by_path["M6 send_picture CIF x3"] = phase_key_frames(
        "9", key_cif, *CIF, card)
    key_hd = [hd[0]]          # palette: the CIF screen frame of phase 9
    pk_m6_hd, _, by_path["M6 send_picture 720p x1"] = phase_key_frames(
        "10", key_hd, *HD, card, warm=False, need=("tx", "delta", "cfl"))
    by_path["M6 send_pictures CIF x8"] = phase_encode(
        "11a", cif, *CIF, card, preset=6)[2]
    by_path["M6 send_pictures 720p x2"] = phase_encode(
        "11b", hd, *HD, card, preset=6)[2]
    phase_cpu_vs_cuda_m6([key_cif[0], key_cif[2]], [pk_m6[0], pk_m6[2]],
                         [dec_m6[0], dec_m6[2]])

    phase_filter_ops()
    pk_f, dec_f, hdr_f, n, _ = phase_filtered_key_frames(
        "14a", key_cif, *CIF, card, pk_m6)
    by_path["M6 send_picture DLF+CDEF CIF x3"] = n
    n = phase_filtered_key_frames("14b", key_hd, *HD, card, pk_m6_hd)[3]
    by_path["M6 send_picture DLF+CDEF 720p x1"] = n
    by_path["M10 send_pictures DLF CIF x8"] = phase_encode(
        "15a", cif, *CIF, card, enable_dlf_flag=1)[2]
    by_path["M10 send_pictures DLF+CDEF CIF x8"] = phase_encode(
        "15b", cif, *CIF, card, **FILTERS)[2]
    phase_cpu_vs_cuda_filters([key_cif[0], key_cif[2]], [pk_f[0], pk_f[2]],
                              [dec_f[0], dec_f[2]], [hdr_f[0], hdr_f[2]])

    # the GOP slice of the earlier PR (MCTF and TPL off) at a cut depth:
    # CIF x9 and 720p x5, no warm run at CIF
    phase_motion_ops()
    by_path["M10 GOP CIF x5"] = phase_gop("18", cif17[:5], *CIF, card,
                                          warm=0, profile=False)[2]
    by_path["M10 GOP 720p x3"] = phase_gop(
        "19", synth_frames(3, *HD), *HD, card, warm=2, shown_limit=3,
        profile=False)[2]
    phase_gop_cpu_vs_cuda()
    by_path["M12 GOP CIF x5"] = phase_gop("21", cif17[:5], *CIF, card,
                                          preset=12, warm=0,
                                          profile=False)[2]

    # this slice: the lookahead (MCTF, TPL, delta-q key frames)
    phase_lookahead_ops()
    _, launches = phase_lookahead_gop(card, cif17)
    by_path["M10 GOP MCTF+TPL CIF x17"] = launches
    phase_lookahead_cpu_vs_cuda()


    # every batch size that a path gave K1 must have been checked against
    # the plain version; a size that phase 3 did not foresee is checked now
    unchecked = sorted(fused_txq.batches
                       - {r["b"] for r in krec["by_batch"]})
    rng = np.random.default_rng(22)
    for b in unchecked:
        check_txq(b, card, rng, krec, tag="25")
    log(f"phase 25: K1 batch sizes launched by the paths "
        f"{sorted(fused_txq.batches)}; checked in phase 3 "
        f"{[r['b'] for r in krec['by_batch'] if r['driven']]}; checked "
        f"now {unchecked}")

    leaked = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith("jax.")
                    or m == "svt_av1_tpu" or m.startswith("svt_av1_tpu."))
    if leaked:
        raise AssertionError(f"modules of JAX or of the JAX package were "
                             f"loaded: {leaked[:8]}")
    # the line's top-level numbers are K1's on this slice's main path: the
    # launches of bench.py's primary config (the M6 GOP at CIF), the time
    # at its pass-B batch (one frame x 11 wave slots x 8 modes); every
    # size is under by_batch
    b0 = next(r for r in krec["by_batch"]
              if r["b"] == k1_batch(1, CIF, 6))
    print(smi, flush=True)
    print(json.dumps({"kernels": [dict(
        name="fused_txq16", route="cuda",
        source="svt_av1_tpu_torch/csrc/fused_txq.cu",
        replaces="svt_av1_tpu/ops/pallas/fused_txq.py:32",
        launches=m6_launches, max_abs_err=krec["max_abs_err"],
        ms=b0["us"] / 1000, plain_ms=b0["plain_us"] / 1000,
        bound_ms=b0["bound_us"] / 1000, bound_by=b0["bound_by"],
        library_ms=None, bound_us=b0["bound_us"], share=b0["share"],
        host_issue_ms=b0["host_issue_ms"], v1_ms=b0["v1_us"] / 1000,
        launches_by_path=by_path, by_batch=krec["by_batch"])]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
