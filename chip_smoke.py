#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (svt_av1_tpu_torch) on one GPU.

    python3 chip_smoke.py

    python3 chip_smoke.py --this-slice   # phases 1-4, 37, 38 and 25 only

Phases, one line each (ending with the seconds since the start); any
failure raises and exits non-zero.  Phases 37 and 38 (this slice), then
35 and 36, 32, 33 and 34, then 28, 31, 30 and 29, then 27 and 26 (the
slices before it) run right after phase 4; the rest in order:
  1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
     exits non-zero without CUDA;
  2. build of the CUDA kernels from svt_av1_tpu_torch/csrc (nvcc, sm_90a)
     into build/kernels/;
  3. the fused transform+quantize kernel (K1) on the card, at every batch
     size B that the paths below give it (frames in one program x wave
     slots x luma modes, k1_batches: 264 and 240 for M10 send_pictures at
     CIF x4 and 720p x1, 352 and 320 for M6; 66, 44 and 240 for a
     send_picture key frame or the pass B of one inter frame at CIF M10,
     CIF M12 and 720p M10; 18, 12, 18 and 24 for phase 20's small GOPs;
     88 for pass B at CIF M6, 16 and 32 for phase 27's; at M0-M4 110
     and 22 for pass B at CIF M4 and 64x64 M2, 660, 165 and 60 for M4
     send_pictures with the five filter-intra pseudo-modes, 15, 30, 45
     and 16 for the varpart program's 16x16 steps), qindex 140 and
     255: bit-identical to the first kernel (svt_fused_txq16_v1, kept in
     the same source), the tie rule below against the plain PyTorch
     version, qcoeff/dqcoeff exact on its own coefficients; the same on
     10-bit residuals (uniform in [-1023, 1023], the first eight blocks
     flat at +-1023 so that |coeff| + round passes the quantizer's int16
     clamp) at qindex 1, 35, 128 and 255 with the 10-bit quantizer,
     under the 10-bit tie rule below, the saturated blocks equal to the
     plain version's, at the sizes the 10-bit paths give it (k1_batches10:
     360 for the 1080p key frame of phase 37, 264 for its CIF x4 batch,
     phase 38's), also timed on the 10-bit residuals; at each size
     the device time per launch of the kernel, the first kernel and the
     plain version (a CUDA graph of 20 launches on preallocated outputs,
     replayed 50 times between two CUDA events; three rounds in turns)
     beside the launch's bytes, FLOP and bound, and the host time of one
     wrapper call; then the two kernels at B = 135168, a batch far beyond
     the L2 (bound by device memory);
  4. the inverse transform and the DC/V/H/SMOOTH/PAETH predictors on the
     card against the C-reference goldens in tests/golden/ (bit-exact);
  5. the all-intra batch: CIF 352x288, 4 frames, preset M10, qp 35, through
     Encoder(cfg).send_pictures on the default device (the card), once to
     warm and once timed; the kernel's launch count over the timed run
     must be > 0; every packet is decoded by the port's decoder on the
     card and must equal Packet.recon exactly;
  6. the same encode and decode check at 1280x720, 1 frame (no warm run:
     phase 35 ran the program at 720p);
  7. the first 4 CIF frames encoded on the CPU with the plain versions,
     against the card's: >= 99% of blocks equal, |dPSNR| <= 0.05 dB,
     |dbytes| <= 1%;
  8. the zone-1/zone-3 directional predictors, the CfL AC buffer and
     prediction (exact) and the 16x16 ADST_ADST/ADST_DCT/DCT_ADST forward
     transforms (tie rule) on the card against the port's CPU run;
  9. preset M6 (tx-type search, angle deltas, CfL, palette) through
     Encoder(cfg).send_picture / flush on the default device: CIF, 1
     frame of the bench clip and 1 screen-content frame, one warm frame
     then timed; every packet decoded on the card and equal to
     Packet.recon; seconds per frame, bytes, Y-PSNR, the counts of blocks
     with a non-DCT tx type, a non-zero angle delta, CfL and palette
     (each must be > 0) and the host_ec seconds;
 10. the same at 1280x720, 1 clip frame (no warm frame; palette is
     required of phase 9's screen frame only);
 11. M6 through send_pictures (the batched program with the preset's 8
     plain luma modes): CIF x4 and 720p x1, hot fps, bytes, PSNR, K1
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
 15. M10 through send_pictures, CIF x4, with DLF only (array route) and
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
 19. the same GOP at 1280x720 x3 (no warm run, as phase 18), the
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
 23. the lookahead slice's main path at a cut depth: the CIF x5 GOP (key
     and a 4-frame mini-GoP at flush) of
     phase 18's structure with the reference's default tools, MCTF and
     TPL on (delta-q key frames), M10, DLF + CDEF, with recon_enabled off
     as bench.py runs it (phases 18-22 ran every program at CIF, so no
     separate warm run): fps, host dispatch seconds per inter frame, the
     seconds of the lookahead stages (key_tf, key_tpl, gop_tf, gop_tpl,
     gop_tpl_synth), the key frames coded with delta-q and their qindex
     range; every shown frame decoded on the card equal to the encoder's
     recon (kept on the card during the run); K1's launches must equal 56
     waves x the frames that are not delta-q key frames, since a
     delta-q key frame takes the per-block quantizer and
     the plain transform, as in the reference;
 24. the 7-frame 128x96 lookahead GOP of the CPU tests
     (clips.split_motion_clip, M10, hierarchical_levels 2, keyint 4) on
     the CPU against the card's, as in phase 20, with every MCTF call's
     planes compared under the pixel tie rule (flips printed); the card's
     stream must code a delta-q key frame;
 25. K1 at any batch size the paths launched that phase 3 did not check
     (checked and timed the same way, at both bit depths); the sizes are
     recorded by the
     wrapper (fused_txq.batches) from the end of phase 4 on;
 26. the main path of the M5-M9 slice, bench.py's primary config at a cut
     depth: the CIF x3 GOP (key + a 2-frame mini-GoP at flush; bench.py
     runs x17) at M6 with MCTF + TPL, DLF + CDEF, hierarchical levels 3,
     keyint 15, qp 35, run after phase 27 (which ran the M6 programs at
     small sizes), timed with recon_enabled off: fps, host
     dispatch seconds per inter frame, the lookahead, tmvp_setup and
     save_mvfield stage seconds, bytes, mean Y-PSNR, the inter blocks by
     kind (8x8 split
     leaves, non-DCT inter tx, OBMC, inter-intra, compound, warp) and the
     inter frames with use_ref_frame_mvs; K1's launches must equal the
     waves of the 2 inter frames, all at B = 88 (M6 key frames search
     four tx types and do not take it); every shown frame decoded on the
     card equal to the encoder's recon (kept on the card during the run);
 27. the M5-M9 clips of the CPU tests on the CPU against the card's, as in
     phase 20: OBMC (seam texture) and inter-intra (gradient wipe) at M6
     with part8 and the tx search pinned off as the reference's tests pin
     them, the 8x8 split + TMVP (boundary clip, M6), M8's full tools and
     M9 on the natural clip; the card's stream must code the clip's tool,
     and blocks whose inter tx type alone differs are counted;
 28. the M0-M4 ops on the card against the port's CPU run, exact: the
     filter-intra predictor (five modes, one wavefront) at 4/8/16/32, D45
     / D67 / D203 at 16/32/64, the per-SB CDEF apply and per-SB SSE on a
     CIF frame with an index map over 4 strength sets; the host time of
     one filter-intra call per block size;
 29. M4 all-intra at CIF: send_picture with DLF + CDEF on the bench
     clip's first frame (qp 35) and on a clip / screen-content composite
     (qp 25, where per-SB CDEF strengths pay): the varpart program, the
     mask-aware DLF search, per-SB CDEF; seconds, bytes, Y-PSNR, levels,
     cdef_bits and strengths, the blocks of each leaf size, filter-intra
     and D45 / D67 (each must be > 0 over the two, and cdef_bits > 0 on
     one); then send_pictures x4 (K1 at B = 660); every packet decoded on
     the card equal to Packet.recon;
 30. the main path of the M0-M4 slice: the CIF x7 GOP (key + a 6-frame
     3-level mini-GoP at flush; at x5 no block takes GOLDEN) at M4 with MCTF + TPL, DLF + CDEF, run after phase 31
     (which ran the M4 programs at small sizes), timed with
     recon_enabled off as phase 26 is: fps, host
     dispatch per inter frame (beside phase 26's M6 frames in the same
     call), the stage seconds, the blocks of each tool (filter-intra on the
     key frames and GOLDEN references must be > 0); K1's launches must
     equal 56 waves x the 6 inter frames, all at B = 110 (the key frames
     search four tx types); every shown frame decoded on the card equal
     to the encoder's recon;
 31. the M0-M4 clips of the CPU tests on the CPU against the card's: the
     varpart picture (128x96 M4, DLF + CDEF), the 64x64 screen picture at
     M2 (filter-intra, D203), M4 send_pictures on two 64x64 pictures, the
     64x64 x5 M2 GOP (hierarchical_levels 1: GOLDEN blocks; its key frame
     forced to two CDEF strength sets, cdef_bits > 0 required) and the
     64x64 x9 M4 GOP (hierarchical_levels 2, two 4-frame mini-GoPs: the
     second base's GOLDEN must be the key frame), each decoded on its
     device: >= 99% of blocks equal, identity printed;
 32. the loop restoration and superres ops on the card against the port's
     CPU run, exact: wiener_filter and the 16 self-guided parameter sets
     (filters and projection) at CIF's luma chunk shape, the superres
     upscale of CIF planes from half width and at denominators 9-16, and
     the LR search and apply of a CIF frame (tests/clips.lr_planes: the
     same unit choices and planes);
 33. the main path of the post-filter slice: CIF x1 M10 through
     send_picture / flush with DLF + CDEF + loop restoration, then 720p
     x1 with LR, CIF x1 with superres + LR, CIF x1 each with film grain (parameters
     estimated from the source), AQ 1 and AQ 2, and a CIF x3 M10 GOP with
     LR on its key frame (phase 18's structure), each beside the same
     frames without the tool: seconds per frame, the restoration stage
     seconds, the LR unit types chosen per frame and plane, bytes and
     Y-PSNR, K1's launches and batches (56 a CIF frame at B = 66 on the
     main path and the GOP, 45 at B = 36 on a superres frame, none on AQ
     frames), every shown frame decoded on the card equal to recon; then
     the restoration stage of one CIF frame under torch.profiler
     (kernels, device time, busy share);
 34. the small streams of tests/test_torch_post_filters.py (LR at 128x96,
     superres + LR at 160x96, film grain at 64x64, AQ 1, AQ 2 at M8 and
     M10, a 64x64 x5 GOP with LR on its key frame) on the CPU and on the
     card: every stream identical, each decoded on its device equal to
     its recon;
 35. the main path of the rate-control slice: the CIF x5 GOP (phase
     18's structure:
     hierarchical_levels 3, keyint 15, DLF + CDEF) at M10 with the
     default MCTF under one-pass CBR at 100,000 bits/s at 30 fps through
     send_picture / flush, timed with recon_enabled off, beside the same
     frames at qp 35: fps, host dispatch seconds per inter frame, the
     achieved bits/s against the target, (poc, qindex, bytes) of every
     coded frame, the stat report's host seconds per CIF frame, K1's
     launches (56 waves x 5 frames at B = 66), every shown frame decoded
     on the card equal to the encoder's recon; then the CIF x3 two-pass
     GOP (pass 1 at qp 35, its stats blob from get_stream_info(0); pass 2
     VBR at the target), all-intra CBR send_picture at 1,000,000 bits/s on
     four smooth CIF frames and a noise frame (one recode, at pts 4: the
     controller gives a first frame the worst qindex, so it cannot
     overshoot), send_pictures with tile columns on CIF x4 (2 tiles, with
     HDR metadata and stat reports) and 720p x1 (4 tiles), each beside one
     tile (bytes, the entropy-coding seconds), decoded on the card by the
     tiled decoder; one 720p frame's tiled packetization 20 times (the
     same bytes each time);
 36. the small streams of tests/test_torch_rate_control.py and
     tests/test_torch_api_surface.py on the CPU and on the card, each
     decoded on its device equal to its recon: streams and qindex
     sequences identical (a difference fails unless a tie counted in the
     first frame that differs explains it);
 37. the main path of this slice: one 1920x1080 10-bit frame (the bench
     clip at 10 bits, coded 1920x1088) at M10 with DLF + CDEF + loop
     restoration through send_picture / flush on the default device,
     timed hot (a warm run of the same frame first) with recon_enabled
     off: seconds, bytes, Y-PSNR (peak 1023), the stage seconds
     (device_md_intra, dlf, cdef, restoration, host_ec), the filter
     levels, strengths and LR types, K1's launches (one per luma wave:
     254 at B = 360); decoded on the card to uint16 planes equal to
     recon; then a CIF 10-bit M6 key frame with DLF + CDEF + LR
     (BASELINE config 3's preset: tx search, CfL, no palette at 10 bits,
     no K1), timed in turns beside the same frame at 8 bits, its tool
     counts; send_pictures CIF x4 at 10 bits with DLF + CDEF (the
     per-block route, K1 at B = 264), decoded on the card;
 38. the small streams of tests/test_torch_10bit.py (10-bit M10 + LR, M6,
     M4, superres + LR, film grain, AQ 1, CBR with a recode,
     send_pictures x2; an 8-bit stream at encoder_color_format 3 and a
     levels-3 GOP with a scene cut) and tests/test_torch_avif.py (AVIF
     stills at 8 and 10 bits) on the card, each decoded on the card equal
     to its recon, against the CPU's stored streams: identical, with the
     same qindex sequences.

Phases 7, 12, 16, 20, 27, 31 and 34 hold the card's stream of each of
their cases to the CPU's: a stream whose sha1 equals the digest that
tools/record_cpu_streams.py stored for the case
(tests/golden/torch_cpu_streams.json) is the CPU's stream; any other is
encoded on the CPU in the run and held to the parity rule (phase 34: to
identity), as before.

K1's launch count is set to 0 before each encode path and read after it;
the send_pictures paths (with and without the filters) and the GOP paths
(pass B of every inter frame, and the M9-M13 key frames without delta-q)
must have launched it (phase 35 checks each count against the waves of
the frames it coded); the M6 send_picture paths and the M0-M6 GOPs' key
frames do not run it (their luma step searches four tx types, as the
reference's does without its kernel); the M4 varpart key frames run it
on their 16x16 steps.

Tie rule for the forward transform: the kernel's float32 sums run in
another order than cuBLAS's, so a coefficient may differ from the plain
version's by at most 1, and only where its float64 value lies within 1e-2
of a half-integer; qcoeff/dqcoeff must equal the plain quantizer applied
to the kernel's own coefficients, exactly.  10-bit residuals reach
coefficients near 2^17, where one float32 step (2^-6) is wider than
1e-2: there a coefficient may differ by 1 only where its float64 value
lies within the float32 error bound of the two 16-term products,
(16 + 16 + 1) x 2^-24 x (|fv| |resid| |fh|^T), of a half-integer
(tests/tie_rule.py); every such mismatch is counted and printed with the
largest distance seen.  Pixel tie rule of MCTF (a
float32 weighted average with exp weights, which CUDA and the CPU round
differently in the last bit): a filtered pixel may differ by 1 only where
its float64 value lies within 1e-3 of a half-integer.

Bound of a K1 launch: the residual, the matrices and the quantizer
constants read once and the three outputs written once, over 3.35 TB/s,
against 2 x 2 x 16^3 FLOP a block over 67 TFLOP/s (the H100 SXM's
published rates); bytes bound it.  The inputs are timed as the encode
leaves them: just written, so in the 50 MB L2.

The script imports nothing of JAX or of the JAX package (the golden
inputs come from svt_av1_tpu_torch/goldens.py; phase 36's and 38's
cases and helpers from the test modules, which import the JAX package only
inside the functions that record its outputs) and checks at its end
that neither was loaded.  The second-to-last line is the kernels' JSON
record (its top-level numbers are K1's on this slice's main path, phase
37's 1080p 10-bit key frame, at B = 360 on 10-bit residuals; by_batch
has every size, bd the residuals' bit depth), the last line {"ok":
true, "device": {...}}.
"""
import hashlib
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


def psnr(a, b, peak=255.0):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 99.0 if mse == 0 else float(10 * np.log10(peak ** 2 / mse))


HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3, published datasheet rate
FP32_FLOP_PER_S = 67e12     # H100 SXM float32 outside the tensor cores
GRAPH_LAUNCHES = 20
GRAPH_REPLAYS = 50
# the depth of the all-intra send_pictures paths of the earlier slices
CIF_FRAMES, HD_FRAMES = 4, 1
# the sha1 digest of the CPU's stream of every cpu-vs-cuda case of
# phases 7, 12, 16, 20, 27, 31 and 34 (tools/record_cpu_streams.py writes
# them from a CPU run): a card stream equal to its case's digest is the
# CPU's stream, and the case is not encoded on the CPU again
CPU_STREAMS = os.path.join(REPO, "tests", "golden", "torch_cpu_streams.json")
# the device of the card's side of those cases (None: the default
# device), and while tools/record_cpu_streams.py runs them on the CPU,
# the digests it collects
CARD = None
RECORDED = None


def stream_digest(pkts):
    """sha1 over the packets' lengths and bytes."""
    h = hashlib.sha1()
    for p in pkts:
        h.update(len(p.data).to_bytes(8, "little"))
        h.update(p.data)
    return h.hexdigest()


def stored_cpu_stream(key, pkts):
    """Whether ``pkts``, the card's stream of the cpu-vs-cuda case ``key``,
    is the CPU's stream as CPU_STREAMS stores it.  While recording, the
    digest is collected instead, and the answer is True."""
    digest = stream_digest(pkts)
    if RECORDED is not None:
        RECORDED[key] = digest
        return True
    try:
        with open(CPU_STREAMS) as f:
            return json.load(f).get(key) == digest
    except FileNotFoundError:
        return False


def k1_batch(nframes, size, preset, fi=False):
    """K1's batch B on a path: frames in one program x wave slots (the
    natural wave size of the 16x16 grid) x the preset's luma modes, plus
    the five filter-intra pseudo-modes with ``fi`` (send_pictures at
    M0-M4; pass B has none).  A send_pictures chunk holds all its frames;
    a send_picture key frame and the pass B of an inter frame hold
    one."""
    from svt_av1_tpu_torch.pipeline import intra_encoder
    from svt_av1_tpu_torch.pipeline.presets import features_for
    w, h = size
    return (nframes * intra_encoder._natural_maxb(-(-h // 16), -(-w // 16))
            * (len(features_for(preset).intra_modes) + (5 if fi else 0)))


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
    # M0-M4: pass B at M4 (10 modes, CIF, phase 30) and M2 (11 modes,
    # 64x64, phase 31); send_pictures with the five filter-intra
    # pseudo-modes (CIF x4, 64x64 x2); the varpart program's 16x16 steps
    # (the one-frame batch is phase 29's warm run)
    driven += [k1_batch(1, CIF, 4), k1_batch(1, (64, 64), 2),
               k1_batch(CIF_FRAMES, CIF, 4, fi=True),
               k1_batch(1, CIF, 4, fi=True), k1_batch(2, (64, 64), 4, fi=True)]
    driven += (k1_varpart_batches(CIF, 4) + k1_varpart_batches((64, 64), 2)
               + k1_varpart_batches((128, 96), 4))
    # superres frames code at half width (CIF: 176 px, phase 33; 80 px,
    # phase 34)
    driven += [k1_batch(1, (CIF[0] // 2, CIF[1]), 10),
               k1_batch(1, (80, 96), 10)]
    # phase 36's send_pictures streams: 64x64 x8, 32x32 x33 (a chunk of
    # 32 and one of 1), the tiled 128x64 / 352x64 x3
    driven += [k1_batch(8, (64, 64), 10), k1_batch(32, (32, 32), 10),
               k1_batch(1, (32, 32), 10), k1_batch(3, (128, 64), 10)]
    return list(dict.fromkeys(driven))


# this slice's main path: one 1080p frame (coded 1920x1088)
P1080 = (1920, 1080)
P1080_CODED = (1920, 1088)


def k1_batches10():
    """The batch sizes the 10-bit paths give K1 (10-bit residuals): phase
    37's 1080p M10 key frame and CIF x4 send_pictures, phase 38's small
    streams (M10 at 128x96, the superres frame at 80x96, 64x64 and the
    96x64 AVIF still, send_pictures 64x64 x2, the M4 varpart frame's
    16x16 steps)."""
    sizes = [k1_batch(1, P1080_CODED, 10), k1_batch(CIF_FRAMES, CIF, 10)]
    sizes += [k1_batch(1, s, 10)
              for s in ((128, 96), (80, 96), (64, 64), (96, 64))]
    sizes += [k1_batch(2, (64, 64), 10)] + k1_varpart_batches((128, 96), 4)
    return list(dict.fromkeys(sizes))


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


def time_txq(resid, card, plain=True, tag="3", bd=8):
    """Device time per launch of the kernel, the first kernel and (when
    ``plain``) the plain version at qindex 140 (the quantizer of bit depth
    ``bd``), three rounds in turns, and the host issue time of the wrapper
    and of the first wrapper."""
    from svt_av1_tpu_torch.ops import fused_txq, quant
    b = resid.shape[0]
    qp = quant.to_device(quant.make_quant_params(140, bd=bd), "cuda")
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
    log(f"phase {tag}: fused_txq B={b} qindex=140 {bd}-bit device time "
        f"per launch "
        f"(CUDA graph of {GRAPH_LAUNCHES} launches x {GRAPH_REPLAYS} "
        f"replays, median of 3 rounds in turns): kernel {med['v2']:.3f} us,"
        f" first kernel {med['v1']:.3f} us, {plain_txt}{nbytes} bytes, "
        f"{flop} FLOP; bound {bound_us:.3f} us ({bound_by}, 3.35 TB/s); "
        f"kernel at {bound_us / med['v2']:.1%} of its bound, first kernel "
        f"at {bound_us / med['v1']:.1%}; host issue per call: wrapper "
        f"{issue:.4f} ms, first wrapper {issue_v1:.4f} ms; {card}")
    return dict(b=b, bd=bd, us=med["v2"], v1_us=med["v1"],
                plain_us=med.get("plain"), bytes=nbytes, flop=flop,
                bound_us=bound_us, bound_by=bound_by,
                share=bound_us / med["v2"], v1_share=bound_us / med["v1"],
                host_issue_ms=issue, v1_host_issue_ms=issue_v1,
                rounds=times)


def check_txq10(b, rng, rec, tag="3"):
    """K1 at batch b on 10-bit residuals: uniform in [-1023, 1023], the
    first (up to) eight blocks flat at +-1023, whose DC passes the
    quantizer's int16 clamp at every qindex; at qindex 1, 35, 128 and 255
    with the 10-bit quantizer: bit-identity with the first kernel, the
    10-bit tie rule against the plain version (tests/tie_rule.py: a
    one-step difference only where the exact value lies within the
    float32 error bound of the two products of a half-integer), the
    quantizer exact on the kernel's own coefficients, and the saturated
    blocks' qcoeff / dqcoeff equal to the plain version's.  Returns the
    residual tensor."""
    import torch
    import tie_rule
    from svt_av1_tpu_torch.codec import constants as cc
    from svt_av1_tpu_torch.ops import fused_txq, quant
    from svt_av1_tpu_torch.ops import transforms as tf
    fv, fh, _, _ = tf._fwd_matrices(cc.DCT_DCT, cc.TX_16X16)
    resid_np = rng.integers(-1023, 1024, (b, 16, 16)).astype(np.int32)
    nflat = min(b, 8)
    resid_np[:nflat] = 1023 * np.array([1, -1] * 4, np.int32)[:nflat, None,
                                                              None]
    exact = tie_rule.exact_coeffs(resid_np, fv, fh)
    bound = tie_rule.coeff_error_bound(resid_np, fv, fh)
    resid = torch.from_numpy(resid_np).cuda()
    for qindex in (1, 35, 128, 255):
        qp = quant.to_device(quant.make_quant_params(qindex, bd=10), "cuda")
        ck, qk, dk = fused_txq.fused_txq(resid, qp)
        v1 = V1(resid, qp).launch()
        cp, qpl, dpl = fused_txq.fused_txq_plain(resid, qp)
        torch.cuda.synchronize()
        n_v1 = sum(int((a != o).sum()) for a, o in zip((ck, qk, dk), v1))
        if n_v1:
            _fail(f"B={b} qindex={qindex} 10-bit: {n_v1} values differ "
                  "between the kernel and the first kernel")
        q_ref, d_ref = quant.quantize(ck, qp, cc.TX_16X16)
        if not (torch.equal(qk, q_ref) and torch.equal(dk, d_ref)):
            _fail("10-bit: kernel qcoeff/dqcoeff differ from the quantizer "
                  "on its own coefficients")
        if not (torch.equal(qk[:nflat], qpl[:nflat])
                and torch.equal(dk[:nflat], dpl[:nflat])):
            _fail(f"B={b} qindex={qindex}: the saturated blocks differ "
                  "from the plain version")
        nmis, maxd, worst = tie_rule.tie_mismatches_bounded(
            ck.cpu().numpy(), cp.cpu().numpy(), exact, bound)
        rec["max_abs_err"] = max(rec["max_abs_err"], maxd)
        rec["mismatches10"] += nmis
        rec["worst10"] = max(rec["worst10"], worst)
        log(f"phase {tag}: fused_txq B={b} qindex={qindex} 10-bit "
            f"residuals ({nflat} flat +-1023 blocks, DC level "
            f"{int(qk[0, 0, 0])} at the int16 clamp): 0 of "
            f"{3 * resid.numel()} values differ from the first kernel; "
            f"{nmis} of {resid.numel()} coefficients differ from the plain "
            f"version (max |diff| {maxd}, each within the float32 error "
            f"bound of a .5 tie, largest distance {worst:.3g}); qcoeff/"
            f"dqcoeff exact, saturated blocks equal")
    return resid


def check_txq(b, card, rng, rec, driven=True, tag="3", ten=False):
    """K1 (fused_txq16) at batch b: bit-identity with the first kernel,
    the tie rule against the plain version, exact quantizer on the
    kernel's own coefficients, at qindex 140 and 255; then its timing
    (time_txq) appended to rec["by_batch"], marked ``driven`` (a size the
    script's 8-bit paths give K1) or not (timed for comparison only);
    with ``ten`` (a size the 10-bit paths give it) the same checks at
    10-bit residuals (check_txq10) and their timing too."""
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
    resid10 = check_txq10(b, rng, rec, tag) if ten else None
    rec["by_batch"].append(dict(time_txq(resid, card, tag=tag),
                                driven=driven))
    if ten:
        rec["by_batch"].append(dict(time_txq(resid10, card, tag=tag, bd=10),
                                    driven=b in k1_batches10()))


def phase_kernel(card):
    """K1 at the batch sizes of the driven paths and at the comparison
    sizes (check_txq), then at a batch far beyond the L2."""
    import torch
    from svt_av1_tpu_torch.ops import quant
    rng = np.random.default_rng(7)
    rec = dict(max_abs_err=0, by_batch=[], mismatches10=0, worst10=0.0)
    sizes8, sizes10 = k1_batches(), k1_batches10()
    for b in dict.fromkeys(sizes8 + sizes10):
        check_txq(b, card, rng, rec, driven=b in sizes8, ten=b in sizes10)
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
    """Port decoder on ``device``; every frame, cropped to the render size,
    must equal Packet.recon.  Returns the parsed decisions per frame;
    appends each frame header to ``headers`` when given."""
    from svt_av1_tpu_torch.codec.decoder import Decoder
    dec = Decoder(device=device)
    decisions = []
    for p in pkts:
        frames = dec.decode_temporal_unit(p.data)
        if len(frames) != 1:
            raise AssertionError("one displayed frame per packet expected")
        for k in ("y", "u", "v"):
            h, w = p.recon[k].shape
            if not np.array_equal(frames[0][k][:h, :w], p.recon[k]):
                raise AssertionError(f"decoder recon differs (plane {k}, "
                                     f"frame {p.pts})")
        decisions.append(frames[0]["decisions"])
        if headers is not None:
            headers.append(dec.last_frame_header)
    return decisions


def phase_encode(tag, frames, w, h, card, preset=10, warm=True, **filters):
    import torch
    from svt_av1_tpu_torch.ops import fused_txq
    if warm:
        encode(frames, w, h, None, preset, **filters)
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
    if stored_cpu_stream("12", pkts_cuda):
        log(f"phase 12: {len(frames)} CIF frames at M6 (send_picture): the "
            f"card's {sum(len(p.data) for p in pkts_cuda)} bytes are the "
            "CPU's stream (stored digest): identical")
        return
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
    n = len(frames)
    if stored_cpu_stream("7", pkts_cuda[:n]):
        log(f"phase 7: first {n} CIF frames: the card's "
            f"{sum(len(p.data) for p in pkts_cuda[:n])} bytes are the CPU's "
            "stream (stored digest): identical")
        return
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


def phase_filtered_key_frames(tag, frames, w, h, card, unfiltered,
                              profile=True):
    """M6 with DLF and CDEF through send_picture / flush on the default
    device, timed (the unfiltered phase of the same size warmed the frame
    program; the filters are eager ops of fixed shapes); every packet
    decoded on the card; the filtered SSE against ``unfiltered`` (the same
    frames without filters); with ``profile``, the filter stage of the
    first frame under torch.profiler (its mode decision run again)."""
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
    prof_txt, prof = "", None
    if profile:
        enc = Encoder(EncoderConfig(source_width=w, source_height=h, qp=35,
                                    enc_mode=6, **FILTERS))
        y, u, v = enc._pad(*frames[0])
        qindex = enc._rc.frame_qindex()
        dec0, rec0, _ = enc._mode_decision(y, u, v, qindex)
        fp = obu.FrameParams(base_q_idx=qindex)
        prof = kernel_profile.device_kernels(
            lambda: enc._filter(dec0, rec0, fp, qindex,
                                dict(y=y, u=u, v=v)))
        prof_txt = (
            f"; filter stage of frame 0: {prof['launches']} device kernels "
            f"({prof['copies']} copies), device time {prof['device_ms']} "
            f"ms, {prof['wall_s']:.3f} s wall under the profiler, levels "
            f"{fp.filter_level[0]}/{fp.filter_level_uv}, strengths "
            f"{fp.cdef_strengths}")
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
        f"({(sse_f - sse_u) / sse_u:+.3%}){prof_txt}; fused_txq "
        f"launches {launches} ({card}); decoder on the default device "
        f"matches recon ({dec_s:.1f} s)")
    return pkts, decisions, headers, launches, prof


def phase_cpu_vs_cuda_filters(frames, pkts_cuda, dec_cuda, hdr_cuda):
    if stored_cpu_stream("16", pkts_cuda):
        log(f"phase 16: {len(frames)} CIF frames at M6 with DLF + CDEF "
            f"(send_picture): the card's "
            f"{sum(len(p.data) for p in pkts_cuda)} bytes are the CPU's "
            "stream (stored digest): identical")
        return
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


def counted(run):
    """run() with K1's count and batch record set aside: (its result, K1
    launches, the sorted batches, the host stage seconds, wall seconds)."""
    import torch
    from svt_av1_tpu_torch.ops import fused_txq
    from svt_av1_tpu_torch.utils import profiling
    torch.cuda.synchronize()
    profiling.reset_stages()
    fused_txq.launches = 0
    seen, fused_txq.batches = fused_txq.batches, set()
    try:
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        batches = sorted(fused_txq.batches)
        fused_txq.batches = seen | fused_txq.batches
    return out, fused_txq.launches, batches, profiling.stage_stats(), dt


def timed_gop(frames, w, h, preset, **cfg):
    """A GOP encode with recon_enabled off (what bench.py times), the
    recon of every coded inter frame kept on the card meanwhile (no
    copy): (packets, {poc: device recon}, seconds, K1 launches, the batch
    sizes K1 had, the host stage seconds)."""
    from svt_av1_tpu_torch.api.encoder import Encoder
    from svt_av1_tpu_torch.codec import obu
    recon = {}
    orig = Encoder._collect_inter_fast

    def keep(self, rec):
        recon[rec[1].poc] = rec[2].recon
        return orig(self, rec)

    Encoder._collect_inter_fast = keep
    try:
        pkts, launches, batches, stages, dt = counted(lambda: encode_gop(
            frames, w, h, None, preset, recon_enabled=False, **cfg))
    finally:
        Encoder._collect_inter_fast = orig
    if any(p.recon is not None for p in pkts
           if p.frame_type == obu.INTER_FRAME):
        _fail("recon_enabled=False still copied inter-frame recon")
    return pkts, recon, dt, launches, batches, stages


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
             warp=0, merged=0, split8=0, itx=0, obmc=0, ii=0, golden=0,
             tmvp_frames=0)
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
            n["golden"] += bool(b.is_inter and b.ref == 4)
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
    pg = encode_gop(frames, w, h, CARD, preset, clip=clip, **kw)
    cg, _ = gop_decode_check(pg, CARD)
    n_g = gop_block_counts(cg)
    for k in ((need,) if isinstance(need, str) else need or ()):
        if n_g[k] <= 0:
            raise AssertionError(f"the card's {name} stream codes no {k}")
    what = (f"phase {tag}: GOP {name} {w}x{h} x{len(frames)} M{preset} {kw}"
            + (" (order hints off, wedge priced out)" if name == "iris"
               else ""))
    if stored_cpu_stream(f"{tag}/{name}", pg):
        log(f"{what} on the card: {sum(len(p.data) for p in pg)} bytes, "
            f"the CPU's stream (stored digest): identical; inter-frame "
            f"blocks {n_g}; decoded on the card equal to recon")
        return None, cg
    pc = encode_gop(frames, w, h, "cpu", preset, clip=clip, **kw)
    cc_, _ = gop_decode_check(pc, "cpu")
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
    n_c = gop_block_counts(cc_)
    log(f"{what} cpu vs cuda: {agree:.4%} of {tot} blocks equal, bytes {bc} vs {bg}, "
        f"|dY-PSNR| {dps:.4f} dB, streams identical: {identical}; counted "
        f"ties: frames whose GM model or interp pick differ {ties}, wedge "
        f"blocks whose option differs {wedge_ties}, blocks whose inter tx "
        f"type alone differs {tx_flips}; inter-frame blocks cpu "
        f"{n_c}, cuda {n_g}; both decoders match recon")
    if (agree < MIN_BLOCK_AGREE or dps > MAX_DPSNR
            or abs(bc - bg) > MAX_DBYTES * bg):
        raise AssertionError(f"cpu and cuda GOP encodes of {name} disagree "
                             "beyond the slice's parity thresholds")
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
        f"frames without delta-q ({card}); decoded on the default device, "
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
    """The M5-M9 slice's main path: bench.py's primary config (the GOP at
    M6 with TPL + MCTF, DLF and CDEF; CIF x5 here, x17 in bench.py)
    through send_picture / flush on the default device (phase 27 ran the
    M6 tools at small sizes just before): the timed run with
    recon_enabled off as bench.py runs it (timed_gop), K1's count set to
    0 before and read after: K1 runs on the pass B of every inter frame,
    at B = 88 (M6 key frames search four tx types and do not take it);
    then every shown frame decoded on the card against the encoder's
    recon (decode_against)."""
    import torch
    from svt_av1_tpu_torch.codec import obu
    w, h = CIF
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
        f"{len(frames) / dt:.4f} fps ({dt:.3f} s), {per_inter:.3f} s host "
        f"dispatch per inter frame "
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

def m4_counts(decisions):
    """Blocks by M0-M4 tool over the frames' parsed decisions: leaf sizes,
    filter-intra, D45 / D67 / D203, GOLDEN references."""
    from svt_av1_tpu_torch.codec import constants as cc
    blocks = [b for d in decisions for b in d.values()]
    return dict(
        leaf16=sum(b.bsize == cc.BLOCK_16X16 for b in blocks),
        leaf32=sum(b.bsize == cc.BLOCK_32X32 for b in blocks),
        leaf64=sum(b.bsize == cc.BLOCK_64X64 for b in blocks),
        filter_intra=sum(b.filter_intra_mode >= 0 for b in blocks),
        d45=sum(not b.is_inter and b.y_mode == cc.D45_PRED for b in blocks),
        d67=sum(not b.is_inter and b.y_mode == cc.D67_PRED for b in blocks),
        d203=sum(not b.is_inter and b.y_mode == cc.D203_PRED
                 for b in blocks),
        golden=sum(b.is_inter and b.ref == 4 for b in blocks))


def k1_varpart_batches(size, preset):
    """K1's batches in the variable-partition program (presets M0-M4):
    the 16x16 sub-steps of a wave's superblocks (1 up to the natural wave
    size of the 64x64 grid) x the luma modes and filter-intra
    pseudo-modes."""
    from svt_av1_tpu_torch.pipeline import intra_encoder
    from svt_av1_tpu_torch.pipeline.presets import features_for
    w, h = size
    maxb = intra_encoder._natural_maxb(-(-h // 64), -(-w // 64))
    nm = len(features_for(preset).intra_modes) + 5
    return [k * nm for k in range(1, maxb + 1)]


def composite_frame(w, h):
    """The bench clip's picture on the left half and screen content on
    the right: superblocks that want different CDEF strengths."""
    import clips
    a = synth_frames(1, w, h)[0]
    b = clips.screen_frame(w, h, seed=1)
    out = []
    for pa, pb in zip(a, b):
        p = pa.copy()
        half = p.shape[1] // 2
        p[:, half:] = pb[:, half:]
        out.append(p)
    return tuple(out)


def encode_key(frames, w, h, device, preset, qp=35, batched=False,
               **filters):
    """Packets of all-intra ``frames`` at ``preset`` and ``qp``."""
    from svt_av1_tpu_torch.api.encoder import Encoder, EncoderConfig
    enc = Encoder(EncoderConfig(source_width=w, source_height=h, qp=qp,
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


def phase_quality_ops():
    """The M0-M4 ops on the card against the port's CPU run, exact: the
    filter-intra predictor (the five modes in one wavefront) at the block
    sizes and batches of the varpart program, D45 / D67 / D203 at 16, 32
    and 64, and the per-SB CDEF apply and per-SB SSE on a CIF frame with
    an index map over 4 strength sets; then the host time of one
    filter-intra call (its wavefront is eager launches: the dispatch cost
    the varpart and send_pictures paths pay)."""
    import torch
    from svt_av1_tpu_torch.codec import constants as cc
    from svt_av1_tpu_torch.ops import intra
    from svt_av1_tpu_torch.pipeline import cdef_stage
    rng = np.random.default_rng(28)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    n_fi = n_dir = 0
    fi_ms = {}
    for n, b in ((4, 64), (8, 64), (16, 45), (32, 45)):
        a, l = (rng.integers(0, 256, (b, n)).astype(np.int32)
                for _ in range(2))
        c = rng.integers(0, 256, b).astype(np.int32)
        ref = intra.filter_intra_pred_multi(t(a), t(l), t(c), tuple(range(5)),
                                            n, n)
        args = (t(a).cuda(), t(l).cuda(), t(c).cuda(), tuple(range(5)), n, n)
        got = intra.filter_intra_pred_multi(*args).cpu()
        if not torch.equal(ref, got):
            _fail(f"phase 28: filter-intra {n}x{n} differs cuda vs cpu")
        n_fi += ref.numel()
        fi_ms[n] = round(host_issue_ms(
            lambda: intra.filter_intra_pred_multi(*args), n=20), 3)
    for n in (16, 32, 64):
        a, l = (rng.integers(0, 256, (45, n)).astype(np.int32)
                for _ in range(2))
        c = rng.integers(0, 256, 45).astype(np.int32)
        ae, le = (rng.integers(0, 256, (45, 2 * n + 1)).astype(np.int32)
                  for _ in range(2))
        for mode in (cc.D45_PRED, cc.D67_PRED, cc.D203_PRED):
            ref = intra.predict(mode, t(a), t(l), t(c), n, n,
                                above_ext=t(ae), left_ext=t(le))
            got = intra.predict(mode, t(a).cuda(), t(l).cuda(), t(c).cuda(),
                                n, n, above_ext=t(ae).cuda(),
                                left_ext=t(le).cuda()).cpu()
            if not torch.equal(ref, got):
                _fail(f"phase 28: mode {mode} {n}x{n} differs cuda vs cpu")
            n_dir += ref.numel()
    w, h = CIF
    src = synth_frames(1, w, h)[0]
    rec = {p: np.clip(s.astype(np.int32)
                      + rng.integers(-6, 7, s.shape), 0, 255).astype(np.uint8)
           for p, s in zip("yuv", src)}
    skip16 = rng.random((h // 16, w // 16)) < 0.3
    idx = rng.integers(-1, 4, ((h + 63) // 64, (w + 63) // 64)).astype(
        np.int32)
    sets = cdef_stage.SEARCH_SET[2:6]
    damping = cdef_stage.cdef_damping(140)
    ref = cdef_stage.cdef_apply({p: t(v) for p, v in rec.items()}, skip16,
                                sets, damping, sb_idx=idx)
    got = cdef_stage.cdef_apply({p: t(v).cuda() for p, v in rec.items()},
                                skip16, sets, damping, sb_idx=idx)
    srcs = dict(zip("yuv", src))
    for p in "yuv":
        if not torch.equal(ref[p], got[p].cpu()):
            _fail(f"phase 28: per-SB CDEF apply differs cuda vs cpu ({p})")
    sse_c = cdef_stage._sb_sse({p: t(v) for p, v in srcs.items()}, ref)
    sse_g = cdef_stage._sb_sse({p: t(v).cuda() for p, v in srcs.items()},
                               got).cpu()
    if not torch.equal(sse_c, sse_g):
        _fail("phase 28: per-SB SSE differs cuda vs cpu")
    log(f"phase 28: M0-M4 ops exact cuda vs cpu: filter-intra (5 modes, "
        f"one wavefront) {n_fi} samples at 4/8/16/32, D45/D67/D203 "
        f"{n_dir} samples at 16/32/64, per-SB CDEF apply and SSE on a CIF "
        f"frame ({idx.size} SBs, 4 sets, index -1..3); host time per "
        f"filter-intra call (ms, by block size) {fi_ms}")


def phase_m4_key_frames(card):
    """Presets M0-M4 all-intra at CIF on the default device: send_picture
    with DLF + CDEF (the varpart program, the mask-aware DLF level search,
    the per-SB CDEF search) on the bench clip's first frame (qp 35) and on
    the clip / screen composite (qp 25, where per-SB strengths pay); then
    send_pictures x4 at M4 (the batched program with the five filter-intra
    pseudo-modes, K1 at B = 4 x 11 x 15).  Each packet decoded on the card
    equal to Packet.recon; the M0-M4 tools counted."""
    import torch
    from svt_av1_tpu_torch.ops import fused_txq
    from svt_av1_tpu_torch.utils import profiling
    w, h = CIF
    runs = (("clip", synth_frames(1, w, h), 35),
            ("composite", [composite_frame(w, h)], 25))
    total = {}
    launches = {}
    bits = []
    for name, frames, qp in runs:
        torch.cuda.synchronize()
        profiling.reset_stages()
        fused_txq.launches = 0
        t0 = time.perf_counter()
        pkts = encode_key(frames, w, h, None, 4, qp=qp, **FILTERS)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches[name] = fused_txq.launches
        stages = profiling.stage_stats()
        hdrs = []
        dec = decode_check(pkts, None, hdrs)
        n = m4_counts(dec)
        for k, v in n.items():
            total[k] = total.get(k, 0) + v
        bits.append(hdrs[0].cdef_bits)
        sec = {k: round(stages[k][0], 3) for k in
               ("device_md_intra", "dlf", "cdef", "host_ec") if k in stages}
        log(f"phase 29: M4 send_picture {name} {w}x{h} qp{qp} DLF + CDEF "
            f"(varpart) on the default device "
            f"({torch.cuda.get_device_name(0)}): {dt:.3f} s, "
            f"{len(pkts[0].data)} bytes, Y-PSNR "
            f"{psnr(frames[0][0], pkts[0].recon['y']):.4f} dB, DLF levels "
            f"{hdrs[0].filter_level}/{hdrs[0].filter_level_uv}, cdef_bits "
            f"{hdrs[0].cdef_bits}, strengths "
            f"{hdrs[0].cdef_strength_list or hdrs[0].cdef_strengths}; blocks "
            f"{n}; stage seconds {sec}; fused_txq launches "
            f"{launches[name]} ({card}); decoded on the card, equal to recon")
    for k in ("leaf16", "leaf32", "leaf64", "filter_intra"):
        if total[k] <= 0:
            _fail(f"phase 29: no {k} block")
    if total["d45"] + total["d67"] <= 0 or max(bits) <= 0:
        _fail(f"phase 29: no D45/D67 block or no per-SB CDEF ({bits})")
    cif = synth_frames(CIF_FRAMES, w, h)
    encode_key(cif[:1], w, h, None, 4, batched=True)           # warm
    torch.cuda.synchronize()
    fused_txq.launches = 0
    t0 = time.perf_counter()
    pkts = encode_key(cif, w, h, None, 4, batched=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches["batch"] = fused_txq.launches
    if launches["batch"] <= 0:
        _fail("phase 29: send_pictures at M4 never launched fused_txq")
    n = m4_counts(decode_check(pkts, None))
    if n["filter_intra"] <= 0:
        _fail("phase 29: no filter-intra block in send_pictures")
    log(f"phase 29: M4 send_pictures {w}x{h} x{len(cif)} qp35 (five "
        f"filter-intra pseudo-modes in the batch): {len(cif) / dt:.3f} fps "
        f"hot ({dt:.3f} s), {sum(len(p.data) for p in pkts)} bytes; blocks "
        f"{n}; fused_txq launches {launches['batch']} at B = "
        f"{k1_batch(CIF_FRAMES, CIF, 4, fi=True)} ({card}); decoded on "
        f"the card, equal to recon")
    return launches


def phase_m4_gop(card, frames):
    """The M0-M4 slice's main path: the CIF x7 GOP (key + a 3-level
    mini-GoP of 6 at flush) at M4 with MCTF + TPL, DLF + CDEF through send_picture /
    flush on the default device (phase 31 ran the M4 programs at small
    sizes just before): the timed run with recon_enabled off
    (timed_gop), K1's count set to 0 before and
    read after: K1 runs on the pass B of every inter frame at B = 11 x 10
    (the key frames search four tx types and do not take it); every shown
    frame decoded on the card against the encoder's recon."""
    import torch
    from svt_av1_tpu_torch.codec import obu
    w, h = CIF
    pkts, recon, dt, launches, batches, stages = timed_gop(frames, w, h, 4,
                                                           **M6_BENCH)
    coded, mpsnr, dec_s = decode_against("30", pkts, recon, frames)
    n = gop_block_counts(coded)
    m = m4_counts([d for _, d in coded])
    n_inter = sum(fp.frame_type == obu.INTER_FRAME for fp, _ in coded)
    waves = waves_per_frame(w, h)
    b = k1_batch(1, CIF, 4)
    if launches != waves * n_inter or batches != [b]:
        _fail(f"phase 30: fused_txq launched {launches} times at batches "
              f"{batches}; {waves} waves x {n_inter} inter frames at B = {b}"
              " predicted")
    for k in ("filter_intra", "golden"):
        if m[k] <= 0:
            _fail(f"phase 30: no {k} block")
    per_inter = stages.get("dispatch_inter", (0.0, 0))[0] / max(n_inter, 1)
    st = {k: (round(stages[k][0], 3), stages[k][1])
          for k in ("key_tf", "key_tpl", "device_md_intra", "key_filters",
                    "gop_tf", "gop_tpl", "tmvp_setup", "host_ec",
                    "device_md_inter") if k in stages}
    log(f"phase 30: the main path of this slice: GOP {w}x{h} x{len(frames)} "
        f"M4 qp35 hierarchical_levels 3 keyint 15 MCTF + TPL DLF + CDEF "
        f"through send_picture / flush on the default device "
        f"({torch.cuda.get_device_name(0)}), recon_enabled off: "
        f"{len(frames) / dt:.4f} fps ({dt:.3f} s), {per_inter:.3f} s host "
        f"dispatch per inter frame "
        f"({n_inter} inter frames), "
        f"{sum(len(p.data) for p in pkts)} bytes, mean Y-PSNR {mpsnr:.4f} "
        f"dB; stage seconds (total, calls) {st}; inter-frame blocks {n}; "
        f"M0-M4 tools {m}; key cdef_bits "
        f"{[fp.cdef_bits for fp, _ in coded if fp.frame_type == 0]}; "
        f"fused_txq launches {launches} = {waves} waves x {n_inter} inter "
        f"frames at B = {b} ({card}); decoded on the card, equal to the "
        f"encoder's recon over {len(frames)} shown frames ({dec_s:.1f} s)")
    return launches


def phase_m4_cpu_vs_cuda():
    """The M0-M4 clips of the CPU tests on the CPU and on the card: the
    varpart picture (128x96, M4, DLF + CDEF), the 64x64 screen picture at
    M2 (DLF + CDEF: filter-intra, D203), send_pictures at M4 on two 64x64
    screen pictures, each decoded on its device and equal to its recon,
    block agreement, bytes, identity; then through gop_cpu_vs_cuda the
    64x64 x5 GOP at M2 (hierarchical_levels 1: GOLDEN; its key frame's
    per-SB CDEF pick forced to two strength sets, as the CPU test forces
    it, so that the key frame codes cdef_bits 1 and a cdef_idx per SB)
    and the 64x64 x9 GOP at M4 (hierarchical_levels 2, two 4-frame
    mini-GoPs: the second base's GOLDEN is the key frame, which keep_poc
    held through the first mini-GoP)."""
    import clips
    from svt_av1_tpu_torch.codec import mv_pred
    from svt_av1_tpu_torch.pipeline import cdef_stage
    runs = (("varpart 128x96 M4", [clips.varpart_frame()], 4, False,
             FILTERS),
            ("screen 64x64 M2", [clips.screen_frame(64, 64, seed=5)], 2,
             False, FILTERS),
            ("send_pictures 64x64 x2 M4",
             [clips.screen_frame(64, 64, seed=s) for s in (5, 6)], 4, True,
             {}))
    total = {}
    for name, frames, preset, batched, filt in runs:
        h, w = frames[0][0].shape
        pg = encode_key(frames, w, h, CARD, preset, batched=batched, **filt)
        dg = decode_check(pg, CARD)
        n = m4_counts(dg)
        for k, v in n.items():
            total[k] = total.get(k, 0) + v
        if stored_cpu_stream(f"31/{name}", pg):
            log(f"phase 31: {name} on the card: "
                f"{sum(len(p.data) for p in pg)} bytes, the CPU's stream "
                f"(stored digest): identical; card blocks {n}; decoded on "
                "the card equal to recon")
            continue
        pc = encode_key(frames, w, h, "cpu", preset, batched=batched, **filt)
        dc = decode_check(pc, "cpu")
        agree = block_agreement(dc, dg)
        identical = [p.data for p in pc] == [p.data for p in pg]
        log(f"phase 31: {name} cpu vs cuda: {agree:.4%} blocks equal, bytes "
            f"{sum(len(p.data) for p in pc)} vs "
            f"{sum(len(p.data) for p in pg)}, streams identical: "
            f"{identical}; card blocks {n}; both decoders match recon")
        if agree < MIN_BLOCK_AGREE:
            _fail(f"phase 31: {name} cpu and cuda disagree")
    for k in ("filter_intra", "d203", "leaf32", "leaf64"):
        if total[k] <= 0:
            _fail(f"phase 31: no {k} block on the card")
    def two_sets(sse, coded, lam, cands, max_bits=3):
        return 1, (tuple(cands[1]), tuple(cands[3])), \
            np.where(coded, 1, -1).astype(np.int32)

    select = cdef_stage.select_sb_sets
    cdef_stage.select_sb_sets = two_sets
    try:
        _, cg = gop_cpu_vs_cuda("m2 natural", clips.natural_clip(
            5, 64, 64, seed=1), tag="31", preset=2, hierarchical_levels=1,
            intra_period_length=8)
    finally:
        cdef_stage.select_sb_sets = select
    bits = [fp.cdef_bits for fp, _ in cg if fp.frame_type == 0]
    log(f"phase 31: the card's M2 GOP key frame cdef_bits {bits} (two "
        "strength sets forced)")
    if m4_counts([d for _, d in cg])["golden"] <= 0:
        _fail("phase 31: the card's M2 GOP codes no GOLDEN block")
    if not bits or bits[0] <= 0:
        _fail("phase 31: the card's M2 GOP key frame has no per-SB CDEF")
    _, cg = gop_cpu_vs_cuda("m4 seam out and back", clips.seam_clip(
        9, back=True), tag="31", preset=4, hierarchical_levels=2,
        intra_period_length=32)
    gold = {fp.order_hint: fp.ref_hints[mv_pred.GOLDEN_FRAME - 1]
            for fp, _ in cg if fp.frame_type != 0}
    n_gold = m4_counts([d for _, d in cg])["golden"]
    log(f"phase 31: the card's M4 levels-2 GOP: GOLDEN order hint per "
        f"inter frame {gold}, {n_gold} GOLDEN blocks, "
        f"use_ref_frame_mvs {[fp.use_ref_frame_mvs for fp, _ in cg]}")
    if gold.get(8) != 0 or gold.get(4) != 0 or n_gold <= 0:
        _fail("phase 31: the card's second base does not code from the "
              "key frame in GOLDEN")


# ------------------- the post filters and quantizer tools (32-34) ---

# loop restoration on top of the in-loop filters (this slice's main path)
LR = dict(enable_restoration_filtering=1, **FILTERS)


def _lr_spy():
    """Wrap lr_stage.search_lr so that the unit choices of every searched
    frame are kept: returns (the list they go to, the undo)."""
    from svt_av1_tpu_torch.codec import lr as lr_mod
    from svt_av1_tpu_torch.pipeline import lr_stage
    seen = []
    orig = lr_stage.search_lr
    names = {lr_mod.RESTORE_NONE: "none", lr_mod.RESTORE_WIENER: "wiener",
             lr_mod.RESTORE_SGRPROJ: "sgr"}

    def spy(src, recon, deb, info, bd=8, eps_set=tuple(range(16))):
        orig(src, recon, deb, info, bd, eps_set)
        frame = {}
        for p, pl in zip("yuv", info):
            kinds = {}
            for row in pl.units:
                for u in row:
                    k = names[u.rtype] + (f"{u.sgrproj.ep}" if u.sgrproj
                                          and u.rtype == 2 else "")
                    kinds[k] = kinds.get(k, 0) + 1
            frame[p] = kinds
        seen.append(frame)

    lr_stage.search_lr = spy

    def undo():
        lr_stage.search_lr = orig
    return seen, undo


def phase_restoration_ops():
    """The restoration and superres ops on the card against the port's
    CPU run, exact: the Wiener filter and every self-guided parameter set
    (filters and projection) at CIF's luma chunk shape (5 chunks of
    64 x 352), the superres upscale of a CIF frame's planes from half
    width and at every denominator 9-16, and the LR search and apply of
    a CIF frame (tests/clips.lr_planes): the same unit choices, the same
    planes."""
    import torch
    import clips
    from svt_av1_tpu_torch.codec import lr as lr_mod
    from svt_av1_tpu_torch.ops import resize
    from svt_av1_tpu_torch.ops import restoration as rst
    from svt_av1_tpu_torch.pipeline import lr_stage
    rng = np.random.default_rng(32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    h, w = 64, 352
    win = rng.integers(0, 256, (5, h + 6, w + 7)).astype(np.int32)
    taps = np.zeros((2, 5, 8), np.int32)
    for i in range(2):
        for b in range(5):
            c = [int(rng.integers(lo, hi + 1))
                 for lo, hi, _, _ in lr_mod.WIENER_TAPS]
            taps[i, b] = [c[0], c[1], c[2], -2 * sum(c), c[2], c[1], c[0], 0]
    ref = rst.wiener_filter(t(win), t(taps[0]), t(taps[1]), w, h)
    got = rst.wiener_filter(t(win).cuda(), t(taps[0]).cuda(),
                            t(taps[1]).cuda(), w, h).cpu()
    if not torch.equal(ref, got):
        _fail("phase 32: wiener_filter differs cuda vs cpu")
    ext = t(win[:, :, :w + 6])
    xqd0 = t(rng.integers(-96, 32, 5).astype(np.int32))
    xqd1 = t(rng.integers(-32, 96, 5).astype(np.int32))
    for eps in range(16):
        for a, b in zip(rst.selfguided_restoration(ext, eps, h, w),
                        rst.selfguided_restoration(ext.cuda(), eps, h, w)):
            if not torch.equal(a, b.cpu()):
                _fail(f"phase 32: self-guided filter {eps} differs")
        a = rst.apply_selfguided(ext, eps, xqd0, xqd1, h, w)
        b = rst.apply_selfguided(ext.cuda(), eps, xqd0.cuda(), xqd1.cuda(),
                                 h, w)
        if not torch.equal(a, b.cpu()):
            _fail(f"phase 32: apply_selfguided {eps} differs cuda vs cpu")
    half = {p: t(a[:, ::2]) for p, a in zip("yuv", synth_frames(1, *CIF)[0])}
    n_sr = 0
    for d in range(9, 17):
        out_w = CIF[0] if d == 16 else 96
        for p, plane in half.items():
            ow = out_w >> int(p != "y")
            src = plane[:, :resize.scaled_width(ow, d)]
            a = resize.superres_upscale(src, ow)
            b = resize.superres_upscale(src.cuda(), ow).cpu()
            if not torch.equal(a, b):
                _fail(f"phase 32: superres upscale 1/{d} differs ({p})")
            n_sr += a.numel()
    src, deb, cdef = clips.lr_planes(CIF[1], CIF[0])
    out = {}
    for dev in ("cpu", "cuda"):
        info = lr_mod.make_lr_info(*CIF)
        tc = {k: t(v).to(dev) for k, v in cdef.items()}
        td = {k: t(v).to(dev) for k, v in deb.items()}
        lr_stage.search_lr(src, tc, td, info)
        planes = lr_stage.apply_lr(tc, td, info)
        out[dev] = ([(u.rtype, u.sgrproj and (u.sgrproj.ep, u.sgrproj.xqd),
                      u.wiener and (u.wiener.vfilter, u.wiener.hfilter))
                     for pl in info for row in pl.units for u in row],
                    {k: v.cpu() for k, v in planes.items()})
    if out["cpu"][0] != out["cuda"][0] or any(
            not torch.equal(out["cpu"][1][k], out["cuda"][1][k])
            for k in "yuv"):
        _fail("phase 32: LR search / apply differ cuda vs cpu")
    log(f"phase 32: restoration ops exact cuda vs cpu: wiener_filter and "
        f"the 16 self-guided sets (filters, projection) on 5 windows of "
        f"{h} x {w}, superres upscale (CIF planes from half width, "
        f"denominators 9-16) {n_sr} samples, LR search (16 sets + Wiener) "
        f"and apply on a CIF frame: units {out['cuda'][0]}")


def _tool_run(tag, what, frames, cfg, card, base=None, gop=False):
    """One timed encode on the default device through send_picture /
    flush at M10 with ``cfg``: seconds per frame, the restoration stage
    seconds, the LR units chosen per frame and plane, bytes and Y-PSNR
    beside ``base`` (the packets of the same frames without the tool),
    K1's launches and batches; every shown frame decoded on the card
    equal to Packet.recon.  Returns (packets, K1 launches)."""
    import torch
    h, w = frames[0][0].shape
    units, undo = _lr_spy()
    try:
        pkts, launches, batches, stages, dt = counted(
            lambda: encode_gop(frames, w, h, None, 10, **cfg) if gop else
            encode_key(frames, w, h, None, 10, **cfg))
    finally:
        undo()
    t1 = time.perf_counter()
    if gop:
        coded, _ = gop_decode_check(pkts, None)
        headers = [fp for fp, _ in coded]
    else:
        headers = []
        decode_check(pkts, None, headers)
    dec_s = time.perf_counter() - t1
    shown = [p for p in pkts if p.displayed]
    ps = float(np.mean([psnr(f[0], p.recon["y"])
                        for f, p in zip(frames, shown)]))
    nbytes = sum(len(p.data) for p in pkts)
    cmp = ""
    if base is not None:
        bb = sum(len(p.data) for p in base)
        bp = float(np.mean([psnr(f[0], p.recon["y"]) for f, p in
                            zip(frames, [p for p in base if p.displayed])]))
        cmp = (f" (without it: {bb} bytes, {bp:.4f} dB: {nbytes - bb:+d} "
               f"bytes, {ps - bp:+.4f} dB)")
    sec = {k: round(stages[k][0], 3) for k in
           ("device_md_intra", "dlf", "cdef", "restoration", "host_ec",
            "dispatch_inter") if k in stages}
    key = headers[0]
    grain = key.film_grain and dict(
        points_y=len(key.film_grain.scaling_points_y),
        ar_lag=key.film_grain.ar_coeff_lag)
    log(f"phase {tag}: {what} {w}x{h} x{len(frames)} M10 on the default "
        f"device ({torch.cuda.get_device_name(0)}): {dt / len(frames):.3f} s "
        f"per frame ({dt:.3f} s), {nbytes} bytes, mean Y-PSNR {ps:.4f} dB"
        f"{cmp}; stage seconds {sec}; LR units per searched frame {units}; "
        f"key frame lr_types {key.lr_types}, superres_denom "
        f"{key.superres_denom}, delta_q {key.delta_q_present}, segmentation "
        f"{key.segmentation is not None}, film grain {grain}; fused_txq "
        f"launches {launches} at B "
        f"= {batches} ({card}); decoded on the card, equal to recon "
        f"({dec_s:.1f} s)")
    return pkts, launches, units, batches, dt


def restoration_profile():
    """The restoration stage of one CIF M10 key frame (the bench clip's
    first frame, DLF + CDEF done) under torch.profiler: the LR search
    over the preset's parameter sets and the apply."""
    import torch
    from svt_av1_tpu_torch.api.encoder import Encoder, EncoderConfig
    from svt_av1_tpu_torch.codec import lr as lr_mod
    from svt_av1_tpu_torch.codec import obu
    from svt_av1_tpu_torch.pipeline import lr_stage
    from svt_av1_tpu_torch.utils import kernel_profile
    enc = Encoder(EncoderConfig(source_width=CIF[0], source_height=CIF[1],
                                qp=35, enc_mode=10, **LR))
    y, u, v = enc._pad(*synth_frames(1, *CIF)[0])
    qindex = enc._rc.frame_qindex()
    dec0, rec0, _ = enc._mode_decision(y, u, v, qindex)
    src = dict(y=y, u=u, v=v)
    recon, deb, _ = enc._filter(dec0, rec0, obu.FrameParams(
        base_q_idx=qindex), qindex, src)

    def stage():
        info = lr_mod.make_lr_info(*CIF)
        lr_stage.search_lr(src, recon, deb, info,
                           eps_set=enc._feat.lr_eps)
        lr_stage.apply_lr(recon, deb, info)

    stage()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stage()
    torch.cuda.synchronize()
    hot = time.perf_counter() - t0
    prof = kernel_profile.device_kernels(stage)
    busy = (prof["device_ms"] / 1000.0 / hot
            if isinstance(prof["device_ms"], float) else "not measured")
    return prof, hot, busy


def phase_post_filters(card, cif):
    """The post-filter slice's main path and its variants on the default
    device at M10 (DLF + CDEF on): CIF x2 send_picture with loop
    restoration (that slice's main path), 720p x1 with LR, CIF x2 superres
    + LR, CIF x1 each with film grain (parameters estimated from the
    source), AQ 1 (delta-q) and AQ 2 (segments), a CIF x3 GOP
    (hierarchical_levels 3, keyint 15, MCTF
    and TPL off) with LR on its key frame; each beside the same frames
    without the tool; then the restoration stage of a CIF frame under
    torch.profiler.  K1 must run 56 waves a CIF frame at B = 66 on the
    main path, 45 at B = 36 on superres frames (176 px: 11 columns, 6
    slots), on every frame of the GOP, and never on AQ frames (per-block
    quantizer rows, as in the reference)."""
    import clips
    w, h = CIF
    hd = synth_frames(1, *HD)
    by_path = {}
    # the main path; the run without LR first warms the M10 program
    key = cif[:1]
    base = encode_key(key, w, h, None, 10, **FILTERS)
    # all-intra CQP: the first frame's packet is that frame coded alone
    plain = base[:1]
    pkts, n, units, batches, dt = _tool_run(
        "33", "send_picture DLF + CDEF + LR (that slice's main path)", key,
        LR, card, base=base)
    waves = waves_per_frame(w, h)
    if n != len(key) * waves or batches != [k1_batch(1, CIF, 10)]:
        _fail(f"phase 33: fused_txq {n} launches at {batches} on the main "
              f"path, {len(key) * waves} at B = {k1_batch(1, CIF, 10)} "
              "predicted")
    if not any(k != "none" for f in units for p in f.values() for k in p):
        _fail("phase 33: LR chose RESTORE_NONE everywhere on the main path")
    by_path["M10 send_picture DLF+CDEF+LR CIF x1"] = n
    main = n
    base = encode_key(hd, *HD, None, 10, **FILTERS)
    by_path["M10 send_picture DLF+CDEF+LR 720p x1"] = _tool_run(
        "33", "send_picture DLF + CDEF + LR", hd, LR, card, base=base)[1]
    sr = dict(superres_mode=1, **LR)
    base = encode_key(cif[:1], w, h, None, 10, superres_mode=1, **FILTERS)
    _, n, _, batches, _ = _tool_run("33", "superres + DLF + CDEF + LR",
                                    cif[:1], sr, card, base=base)
    sr_b = k1_batch(1, (w // 2, h), 10)
    if n != waves_per_frame(w // 2, h) or batches != [sr_b]:
        _fail(f"phase 33: superres K1 {n} launches at {batches}")
    by_path["M10 superres+LR CIF x1"] = n
    for what, extra in (("film grain", dict(film_grain_denoise_strength=8)),
                        ("AQ 1", dict(enable_adaptive_quantization=1)),
                        ("AQ 2", dict(enable_adaptive_quantization=2))):
        _, n, _, _, _ = _tool_run("33", what + " + DLF + CDEF", cif[:1],
                                  dict(extra, **FILTERS), card, base=plain)
        if (n == 0) != what.startswith("AQ"):
            _fail(f"phase 33: {what}: K1 launched {n} times")
        by_path[f"M10 {what} CIF x1"] = n
    gop_frames = cif[:3]
    base = encode_gop(gop_frames, w, h, None, 10)
    _, n, _, batches, _ = _tool_run(
        "33", "GOP (levels 3, keyint 15) DLF + CDEF + LR on the key frame",
        gop_frames, dict(enable_restoration_filtering=1), card, base=base,
        gop=True)
    if n != len(gop_frames) * waves or batches != [k1_batch(1, CIF, 10)]:
        _fail(f"phase 33: the GOP's K1 {n} launches at {batches}")
    by_path["M10 GOP LR CIF x3"] = n
    prof, hot, busy = restoration_profile()
    log(f"phase 33: the restoration stage of one CIF M10 key frame (search "
        f"over the preset's 4 self-guided sets + Wiener, then apply): "
        f"{hot:.3f} s hot; under torch.profiler {prof['launches']} device "
        f"kernels ({prof['copies']} copies), device time "
        f"{prof['device_ms']} ms, {prof['wall_s']:.3f} s wall, busy "
        f"{busy if isinstance(busy, str) else f'{busy:.1%}'} (device time "
        f"over the hot wall); top kernels {prof['top_kernels']}; {card}")
    return main, by_path


# the streams of tests/test_torch_post_filters.py (name: frames, config)
POST_CASES = {
    "lr_m10": (lambda c: c.natural_clip(1, 128, 96, seed=4), 10, LR),
    "superres_lr": (lambda c: c.natural_clip(1, 160, 96, seed=5), 10,
                    dict(superres_mode=1, qp=40, **LR)),
    "film_grain": (lambda c: [c.grain_frame()], 10,
                   dict(film_grain_denoise_strength=8, qp=40)),
    "aq1": (lambda c: [c.varpart_frame()], 10,
            dict(enable_adaptive_quantization=1)),
    "aq2_m8": (lambda c: [c.varpart_frame()], 8,
               dict(enable_adaptive_quantization=2)),
    "aq2_m10": (lambda c: [c.varpart_frame()], 10,
                dict(enable_adaptive_quantization=2)),
}


def phase_post_cpu_vs_cuda():
    """The small streams of the CPU tests on the CPU and on the card:
    every stream identical, each decoded on its device equal to its
    recon; then the 64x64 x5 GOP (hierarchical_levels 2) with LR on its
    key frame through gop_cpu_vs_cuda."""
    import clips
    for name, (make, preset, cfg) in POST_CASES.items():
        frames = make(clips)
        h, w = frames[0][0].shape
        qp = cfg.get("qp", 35)
        kw = {k: v for k, v in cfg.items() if k != "qp"}
        pg = encode_key(frames, w, h, CARD, preset, qp=qp, **kw)
        hg = []
        decode_check(pg, CARD, hg)
        if stored_cpu_stream(f"34/{name}", pg):
            log(f"phase 34: {name} ({w}x{h} M{preset}) on the card: "
                f"{sum(len(p.data) for p in pg)} bytes, the CPU's stream "
                f"(stored digest): identical; lr_types {hg[0].lr_types}; "
                "decoded on the card equal to recon")
            continue
        pc = encode_key(frames, w, h, "cpu", preset, qp=qp, **kw)
        decode_check(pc, "cpu")
        identical = [p.data for p in pc] == [p.data for p in pg]
        log(f"phase 34: {name} ({w}x{h} M{preset}) cpu vs cuda: bytes "
            f"{sum(len(p.data) for p in pc)} vs "
            f"{sum(len(p.data) for p in pg)}, streams identical: "
            f"{identical}; lr_types {hg[0].lr_types}; both decoders match "
            f"recon")
        if not identical:
            _fail(f"phase 34: {name}: the card's stream differs from the "
                  "CPU's")
    frames = clips.natural_clip(5, 64, 64, seed=1)
    kw = dict(hierarchical_levels=2, intra_period_length=4,
              enable_restoration_filtering=1)
    pg = encode_gop(frames, 64, 64, CARD, 10, **kw)
    coded, _ = gop_decode_check(pg, CARD)
    identical = stored_cpu_stream("34/gop_lr", pg)
    how = "the CPU's stream (stored digest)"
    if not identical:
        pc = encode_gop(frames, 64, 64, "cpu", 10, **kw)
        gop_decode_check(pc, "cpu")
        identical = [p.data for p in pc] == [p.data for p in pg]
        how = f"the CPU's {sum(len(p.data) for p in pc)} bytes"
    log(f"phase 34: GOP 64x64 x5 M10 {kw} on the card: "
        f"{sum(len(p.data) for p in pg)} bytes, {how}: streams identical: "
        f"{identical}; lr_types per coded frame "
        f"{[fp.lr_types for fp, _ in coded]}; decoded on the card equal to "
        "recon")
    if not identical:
        _fail("phase 34: the card's GOP stream differs from the CPU's")
    if coded[0][0].lr_types == (0, 0, 0):
        _fail("phase 34: the GOP's key frame codes no LR units")


# -- this slice: rate control and the rest of the API surface ---------------

# the main path's config: the GOP of phase 18 (levels 3, keyint 15, DLF +
# CDEF) with the default MCTF, one-pass CBR at 100,000 bits/s at 30 fps
CBR_TARGET = 100_000
RC_GOP = dict(GOP, enable_tf=1)
HDR = dict(content_light="1000,400",
           mastering_display="G(0.2649,0.6900)B(0.1500,0.0600)"
                             "R(0.6800,0.3200)WP(0.3127,0.3290)"
                             "L(1000.0,0.0001)")


def frame_line(coded, pkts):
    """(poc, qindex, bytes) of every coded frame of a stream, in decode
    order."""
    from svt_av1_tpu_torch.codec import obu
    sized = [p for p in pkts
             if obu.OBU_FRAME in [t for t, _ in obu.parse_obus(p.data)]]
    return [(p.pts, fp.base_q_idx, len(p.data))
            for (fp, _), p in zip(coded, sized)]


def phase_rate_control(card, cif):
    """This slice's main path and its variants on the default device:
    the CIF x5 M10 GOP under one-pass CBR (timed with recon_enabled off,
    beside the same frames at qp 35), the CIF x3 two-pass GOP, all-intra
    CBR send_picture with a recode, send_pictures with tile columns
    (HDR metadata and stat reports ride on the CIF batch)."""
    import clips
    import torch
    from svt_av1_tpu_torch.api.encoder import Encoder, EncoderConfig
    from svt_av1_tpu_torch.codec import obu
    from svt_av1_tpu_torch.utils import metrics
    w, h = CIF
    waves = waves_per_frame(w, h)
    b66 = k1_batch(1, CIF, 10)
    by_path = {}
    frames = cif[:5]
    fps = 30.0
    runs = {}
    for what, cfg in (("CBR", dict(rate_control_mode=2,
                                   target_bit_rate=CBR_TARGET)),
                      ("qp 35", {})):
        pkts, recon, dt, n, batches, stages = timed_gop(
            frames, w, h, 10, **dict(RC_GOP, **cfg))
        coded, mpsnr, dec_s = decode_against("35", pkts, recon, frames)
        if n != waves * len(coded) or batches != [b66]:
            _fail(f"phase 35: {what} GOP: fused_txq {n} launches at "
                  f"{batches}, {waves * len(coded)} at B = {b66} predicted")
        bits = sum(len(p.data) for p in pkts) * 8
        n_inter = sum(fp.frame_type == obu.INTER_FRAME for fp, _ in coded)
        per_inter = stages.get("dispatch_inter", (0.0, 0))[0] / n_inter
        runs[what] = (pkts, recon)
        t0 = time.perf_counter()
        for p in pkts:
            if p.displayed:
                rec = p.recon or {k: v.cpu().numpy()
                                  for k, v in recon[p.pts].items()}
                metrics.frame_stats(dict(zip("yuv", frames[p.pts])), rec)
        stat_s = (time.perf_counter() - t0) / len(frames)
        rate = bits * fps / len(frames)
        log(f"phase 35: GOP {w}x{h} x{len(frames)} M10 {what} "
            f"hierarchical_levels 3 keyint 15 MCTF DLF + CDEF through "
            f"send_picture / flush on the default device, recon_enabled "
            f"off: {len(frames) / dt:.3f} fps ({dt:.3f} s), "
            f"{per_inter:.3f} s host dispatch per inter frame, "
            f"{bits // 8} bytes = {rate:.0f} bits/s at 30 fps"
            + (f" against the {CBR_TARGET} target ({rate / CBR_TARGET:.3f}"
               "x)" if what == "CBR" else "")
            + f", mean Y-PSNR {mpsnr:.4f} dB; (poc, qindex, bytes) in "
            f"decode order {frame_line(coded, pkts)}; fused_txq launches "
            f"{n} = {waves} waves x {len(coded)} coded frames at B = "
            f"{batches} ({card}); stat report (PSNR + SSIM, numpy on the "
            f"host) {stat_s:.3f} s per CIF frame; decoded on the card equal "
            f"to the encoder's recon ({dec_s:.1f} s)")
        by_path[f"M10 GOP {what} CIF x5"] = n
    main = by_path["M10 GOP CBR CIF x5"]
    if (qindices_of(runs["CBR"][0]) == qindices_of(runs["qp 35"][0])):
        _fail("phase 35: CBR coded every frame at the CRF qindex")

    # two passes: CRF pass 1 (the stats blob), VBR pass 2 at the target
    five = cif[:3]
    p1, n1, _, _, dt1 = counted(lambda: encode_gop_enc(
        five, w, h, **dict(RC_GOP, pass_=1)))
    enc1, pk1 = p1
    blob = enc1.get_stream_info(0)
    if blob != enc1.get_stats() or not blob:
        _fail("phase 35: get_stream_info(0) is not the pass-1 stats blob")
    (enc2, pk2), n2, _, _, dt2 = counted(lambda: encode_gop_enc(
        five, w, h, **dict(RC_GOP, pass_=2, rate_control_mode=1,
                           target_bit_rate=CBR_TARGET,
                           rc_stats_buffer=blob)))
    coded2, _ = gop_decode_check(pk2, None)
    gop_decode_check(pk1, None)
    bits2 = sum(len(p.data) for p in pk2) * 8
    log(f"phase 35: two-pass GOP {w}x{h} x{len(five)} M10: pass 1 (qp 35) "
        f"{dt1:.3f} s, stats blob {len(blob)} bytes; pass 2 (VBR "
        f"{CBR_TARGET} bits/s) {dt2:.3f} s, {bits2 * fps / len(five):.0f} "
        f"bits/s; (poc, qindex, bytes) {frame_line(coded2, pk2)}; fused_txq "
        f"{n1} + {n2} launches; both passes decoded on the card equal to "
        f"recon")
    by_path["M10 two-pass GOP CIF x3 (pass 1 + pass 2)"] = n1 + n2

    # all-intra CBR send_picture: four smooth frames, then a noise frame
    # that overshoots 8x its budget and is coded again (a first frame
    # cannot: the controller gives it the worst qindex)
    rng = np.random.default_rng(35)
    noise = (rng.integers(0, 256, (h, w)).astype(np.uint8),
             rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8),
             rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8))
    key = clips.natural_clip(4, w, h, seed=2) + [noise]
    with test_module("test_torch_rate_control").recode_spy() as seen:
        pk, n, batches, stages, dt = counted(lambda: encode_key(
            key, w, h, None, 10, rate_control_mode=2,
            target_bit_rate=1_000_000))
    recodes = [pts for pts, _ in seen]
    hdr = []
    decode_check(pk, None, hdr)
    if recodes != [4] or n != waves * (len(key) + len(recodes)) or batches != [b66]:
        _fail(f"phase 35: all-intra CBR recodes at {recodes} (4 expected), "
              f"fused_txq {n} launches at {batches}")
    log(f"phase 35: all-intra CBR 1,000,000 bits/s send_picture {w}x{h} "
        f"x{len(key)} (4 clip frames, then a noise frame): "
        f"{dt / len(key):.3f} s per frame; recodes at pts {recodes}; "
        f"(pts, qindex, bytes) "
        f"{[(p.pts, f.base_q_idx, len(p.data)) for p, f in zip(pk, hdr)]}; "
        f"fused_txq {n} launches = {waves} waves x {len(key) + 1} frame "
        f"programs at B = {batches}; decoded on the card equal to recon")
    by_path["M10 CBR send_picture CIF x5 (1 recode)"] = n

    # tile columns on the all-intra batch, beside one tile; the CIF batch
    # carries the HDR metadata and stat reports
    for tag, fr, size, cols, extra in (
            ("CIF x4", cif[:4], CIF, 1, dict(HDR, stat_report=1)),
            ("720p x1", synth_frames(1, *HD), HD, 2, {})):
        tw, th = size
        encode(fr, tw, th, None, **extra)                  # warm
        res = {c: counted(lambda: encode(fr, tw, th, None, tile_columns=c,
                                         **extra)) for c in (0, cols)}
        pk, n, batches, stages, dt = res[cols]
        pk0, _, _, stages0, dt0 = res[0]
        hdr = []
        decode_check(pk, None, hdr)
        decode_check(pk0, None)
        if {fp.log2_tile_cols for fp in hdr} != {cols} or n == 0:
            _fail(f"phase 35: {tag} tile_columns={cols}: log2_tile_cols "
                  f"{[fp.log2_tile_cols for fp in hdr]}, K1 {n} launches")
        meta = sorted(obu.parse_metadata(pl)[0]
                      for t, pl in obu.parse_obus(pk[0].data)
                      if t == obu.OBU_METADATA)
        if extra and (len(meta) != 2 or any(p.stats is None for p in pk)):
            _fail("phase 35: the HDR metadata or stat reports are missing")
        ec, ec0 = stages["host_ec"][0], stages0["host_ec"][0]
        log(f"phase 35: send_pictures {tw}x{th} {tag} M10 tile_columns="
            f"{cols} ({1 << cols} tiles) {dt:.3f} s against one tile "
            f"{dt0:.3f} s; entropy coding (host_ec) {ec:.3f} s against "
            f"{ec0:.3f} s; bytes {sum(len(p.data) for p in pk)} against "
            f"{sum(len(p.data) for p in pk0)}; fused_txq {n} launches at "
            f"B = {batches}"
            + (f"; metadata types {meta}, stats of frame 0 "
               f"{pk[0].stats}, stat_report {stages['stat_report'][0]:.3f} "
               "s" if extra else "")
            + "; decoded on the card equal to recon")
        by_path[f"M10 send_pictures tiles {tag}"] = n
    # the tiled coder's threads: one 720p frame packetized 20 times
    enc = Encoder(EncoderConfig(source_width=HD[0], source_height=HD[1],
                                tile_columns=2))
    from svt_av1_tpu_torch.pipeline import intra_encoder
    (bundle, recon), = intra_encoder.encode_intra_frames_finish(
        intra_encoder.encode_intra_frames_launch(
            synth_frames(1, *HD), 140, modes=enc._feat.intra_modes,
            tile_starts=enc._tile_starts))
    datas = set()
    for _ in range(20):
        enc._seq_hdr_sent = True
        datas.add(enc._packetize_arrays(bundle, recon, 140, 0).data)
    log(f"phase 35: one 720p frame's four-tile packetization 20 times: "
        f"{len(datas)} distinct stream(s)")
    if len(datas) != 1:
        _fail("phase 35: the tiled coder's bytes depend on its threads")
    return main, by_path


def test_module(name):
    """A module of tests/ (its cases and helpers), imported without the
    torch thread count it sets for the CPU tests."""
    import importlib
    import torch
    threads = torch.get_num_threads()
    try:
        return importlib.import_module(name)
    finally:
        torch.set_num_threads(threads)


def qindices_of(pkts):
    """base_q_idx of every coded frame of a stream."""
    from svt_av1_tpu_torch.codec import obu
    return test_module("test_torch_rate_control").qindices(
        obu, [p.data for p in pkts])


def encode_gop_enc(frames, w, h, device=None, **cfg):
    """(the encoder, its packets) of a GOP through send_picture / flush."""
    from svt_av1_tpu_torch.api.encoder import Encoder, EncoderConfig
    enc = Encoder(EncoderConfig(source_width=w, source_height=h,
                                **dict(dict(qp=35), **cfg)), device=device)
    for f in frames:
        enc.send_picture(*f)
    enc.flush()
    return enc, list(iter(enc.get_packet, None))


def phase_rate_control_cpu_vs_cuda():
    """The small streams of tests/test_torch_rate_control.py and
    tests/test_torch_api_surface.py on the card, each decoded on the card
    equal to its recon, against the CPU's streams: those the tests store
    (tests/golden/torch_port_refs.npz, where the CPU tests hold the
    port's CPU stream byte-identical to the JAX package's), found by the
    fingerprint of the card's own packets.  Streams and qindex sequences
    must be identical.  A stream with no stored match is encoded on the
    CPU, and the first frame that differs is printed with the ties
    counted in it (its GM model or interp pick, blocks whose inter tx
    type alone differs); a difference that no counted tie in the first
    differing frame explains fails, and so does any qindex difference
    before it."""
    from svt_av1_tpu_torch.api.encoder import Encoder, EncoderConfig
    from svt_av1_tpu_torch.codec import obu
    rc_tests = test_module("test_torch_rate_control")
    api_tests = test_module("test_torch_api_surface")

    def rc_encode(name, frames, dev):
        return rc_tests.encode(Encoder, EncoderConfig, name, frames,
                               device=dev)[1]

    suites = (("rate_control", rc_tests.CASES, rc_encode, rc_tests.stored),
              ("api_surface", api_tests.CASES, api_tests.encode,
               api_tests.stored))
    for suite, cases, enc, stored in suites:
        for name in cases:
            frames = cases[name][0]()
            pg = enc(name, frames, None)
            cg, _ = gop_decode_check(pg, None)
            qg = qindices_of(pg)
            try:
                ref = stored(name, frames, [p.data for p in pg])
            except AssertionError:
                ref = None
            if ref is not None and ref["data"] == [p.data for p in pg]:
                log(f"phase 36: {suite} {name} on the card: "
                    f"{sum(len(p.data) for p in pg)} bytes, qindex {qg}, "
                    "the CPU's stream (stored): identical; decoded on the "
                    "card equal to recon")
                continue
            pc = enc(name, frames, "cpu")
            cc_, _ = gop_decode_check(pc, "cpu")
            qc = qindices_of(pc)
            if [p.data for p in pc] == [p.data for p in pg]:
                log(f"phase 36: {suite} {name} cpu vs cuda (no stored "
                    f"stream): {sum(len(p.data) for p in pg)} bytes, qindex "
                    f"{qg}, identical; both decoders match recon")
                continue
            first = next((i for i, (a, b) in enumerate(zip(pc, pg))
                          if a.data != b.data), min(len(pc), len(pg)))
            fi = sum(obu.OBU_FRAME in [t for t, _ in obu.parse_obus(p.data)]
                     for p in pc[:first])
            ties = tx_flips = 0
            if fi < min(len(cc_), len(cg)):
                ties = int(_headers_key(cc_[fi:fi + 1])
                           != _headers_key(cg[fi:fi + 1]))
                a, b = cc_[fi][1], cg[fi][1]
                tx_flips = sum(bool(b.get(k) is not None
                                    and blk.tx_type != b[k].tx_type
                                    and _same_inter_block(blk, b[k],
                                                          tx=False))
                               for k, blk in a.items())
            log(f"phase 36: {suite} {name} cpu vs cuda: bytes "
                f"{sum(len(p.data) for p in pc)} vs "
                f"{sum(len(p.data) for p in pg)}, qindex {qc} vs {qg}; "
                f"first differing packet {first}, counted ties in it: GM / "
                f"interp {ties}, inter tx type alone {tx_flips}")
            if qc[:fi + 1] != qg[:fi + 1] or not (ties or tx_flips):
                _fail(f"phase 36: {name}: the card's stream differs from "
                      "the CPU's where no counted tie explains it")

# -- this slice: the 10-bit all-intra encode and AVIF stills (37-38) --------

TEN = dict(encoder_bit_depth=10)


def frames10(n, w, h):
    """The bench clip at 10 bits (tests/clips.py to_10bit)."""
    import clips
    return clips.to_10bit(synth_frames(n, w, h))


def ten_bit_line(tag, what, pkts, frames, dt, n, batches, stages, dec_s,
                 card, headers):
    """One phase line of a 10-bit encode."""
    import torch
    h, w = frames[0][0].shape
    ps = float(np.mean([psnr(f[0], p.recon["y"], 1023.0)
                        for f, p in zip(frames, pkts)]))
    sec = {k: round(stages[k][0], 3) for k in
           ("device_md_intra", "dlf", "cdef", "restoration", "host_ec",
            "device_dispatch", "device_wait_transfer") if k in stages}
    log(f"phase {tag}: {what} {w}x{h} x{len(frames)} 10-bit on the default "
        f"device ({torch.cuda.get_device_name(0)}): {dt / len(frames):.3f} "
        f"s per frame ({dt:.3f} s), {sum(len(p.data) for p in pkts)} bytes, "
        f"mean Y-PSNR {ps:.4f} dB (peak 1023); stage seconds {sec}; key "
        f"frame levels {headers[0].filter_level[0]}/"
        f"{headers[0].filter_level_uv}, CDEF {headers[0].cdef_strengths}, "
        f"lr_types {headers[0].lr_types}; fused_txq launches {n} at B = "
        f"{batches} ({card}); decoded on the card to uint16 planes equal to "
        f"recon ({dec_s:.1f} s)")


def phase_ten_bit(card):
    """This slice's main path and its variants on the default device:
    one 1080p 10-bit M10 frame (coded 1920x1088) with DLF + CDEF + loop
    restoration through send_picture / flush, timed hot (a warm run of
    the same frame first) with recon_enabled off as bench.py sets it,
    K1 once per luma wave at B = 360; then the CIF 10-bit M6 key frame
    with the filters (BASELINE config 3's preset: tx search, CfL, no
    palette at 10 bits; no K1, as in the reference), timed beside the
    same frame at 8 bits in turns; then send_pictures CIF x4 at 10 bits
    (the per-block route: one chunk, K1 once per wave at B = 264).
    Every packet is decoded on the card and must equal Packet.recon."""
    w, h = P1080
    frame = frames10(1, w, h)
    by_path = {}

    def main():
        from svt_av1_tpu_torch.api.encoder import Encoder, EncoderConfig
        enc = Encoder(EncoderConfig(source_width=w, source_height=h, qp=35,
                                    **TEN, **LR))
        enc.recon_enabled = False
        enc.send_picture(*frame[0])
        enc.flush()
        return list(iter(enc.get_packet, None))

    encode_key(frame, w, h, None, 10, **TEN, **LR)          # warm
    pkts, n, batches, stages, dt = counted(main)
    waves = waves_per_frame(*P1080_CODED)
    b_main = k1_batch(1, P1080_CODED, 10)
    if n != waves or batches != [b_main]:
        _fail(f"phase 37: fused_txq {n} launches at {batches} on the main "
              f"path, {waves} at B = {b_main} predicted")
    if pkts[0].recon["y"].dtype != np.uint16:
        _fail("phase 37: the 10-bit recon is not uint16")
    headers = []
    t1 = time.perf_counter()
    decode_check(pkts, None, headers)
    dec_s = time.perf_counter() - t1
    if headers[0].lr_types == (0, 0, 0):
        _fail("phase 37: LR chose RESTORE_NONE everywhere on the main path")
    ten_bit_line("37", "the main path: M10 send_picture DLF + CDEF + LR, "
                 "recon_enabled off, hot,", pkts, frame, dt, n, batches,
                 stages, dec_s, card, headers)
    by_path["10-bit M10 send_picture DLF+CDEF+LR 1080p x1"] = main_n = n

    # BASELINE config 3's preset on a CIF key frame, 10 bits beside 8
    cif8 = synth_frames(1, *CIF)
    cif10 = frames10(1, *CIF)
    times, runs = {}, {}
    for bd, fr in ((10, cif10), (8, cif8), (10, cif10)):
        runs[bd] = counted(lambda: encode_key(
            fr, *CIF, None, 6, encoder_bit_depth=bd, **LR))
        times.setdefault(bd, []).append(runs[bd][4])
        if runs[bd][1]:
            _fail(f"phase 37: the M6 {bd}-bit key frame launched K1 "
                  f"{runs[bd][1]} times")
    pk10, n, batches, stages, dt = runs[10]
    headers10 = []
    t1 = time.perf_counter()
    dec10 = decode_check(pk10, None, headers10)
    dec_s = time.perf_counter() - t1
    counts = tool_counts(dec10)
    if (not counts["tx"] or not counts["cfl"] or counts["palette"]
            or headers10[0].allow_screen_content_tools):
        _fail(f"phase 37: the 10-bit M6 frame's tools {counts}")
    ten_bit_line("37", "M6 send_picture DLF + CDEF + LR (BASELINE config "
                 "3's preset)", pk10, cif10, dt, n, batches, stages, dec_s,
                 card, headers10)
    log(f"phase 37: the CIF M6 key frame with DLF + CDEF + LR, 10 bits "
        f"against 8 in turns (10, 8, 10; the first run cold): 10-bit "
        f"{[round(t, 3) for t in times[10]]} s, 8-bit "
        f"{[round(t, 3) for t in times[8]]} s, hot 10 / 8 = "
        f"{times[10][-1] / times[8][-1]:.3f}; 10-bit blocks with a non-DCT "
        f"tx type {counts['tx']}, CfL {counts['cfl']}, angle deltas "
        f"{counts['delta']}, palette {counts['palette']}")
    by_path["10-bit M6 send_picture DLF+CDEF+LR CIF x1"] = 0

    cif4 = frames10(CIF_FRAMES, *CIF)
    pk, n, batches, stages, dt = counted(lambda: encode(
        cif4, *CIF, None, **TEN, **FILTERS))
    b264 = k1_batch(CIF_FRAMES, CIF, 10)
    if n != waves_per_frame(*CIF) or batches != [b264]:
        _fail(f"phase 37: send_pictures 10-bit CIF x4: fused_txq {n} "
              f"launches at {batches}")
    headers = []
    t1 = time.perf_counter()
    decode_check(pk, None, headers)
    ten_bit_line("37", "M10 send_pictures DLF + CDEF (the per-block route)",
                 pk, cif4, dt, n, batches, stages,
                 time.perf_counter() - t1, card, headers)
    by_path["10-bit M10 send_pictures DLF+CDEF CIF x4"] = n
    return main_n, by_path


def phase_ten_bit_cpu_vs_cuda():
    """The small streams of tests/test_torch_10bit.py and
    tests/test_torch_avif.py on the card, each decoded on the card equal
    to its recon, against the CPU's streams as the tests store them (the
    JAX package's, which the CPU port equals byte for byte), found by
    the fingerprint of the card's own packets; a stream with no stored
    match is encoded on the CPU and must be identical.  Streams and
    qindex sequences must be identical."""
    ten = test_module("test_torch_10bit")
    avif = test_module("test_torch_avif")
    for name in ten.CASES:
        frames = ten.CASES[name][0]()
        pg = ten.encode(name, frames, None)
        gop_decode_check(pg, None)
        datas = [p.data for p in pg]
        try:
            ref = ten.stored(name, frames, datas)["data"]
            how = "the CPU's stream (stored)"
        except AssertionError:
            ref = [p.data for p in ten.encode(name, frames, "cpu")]
            how = "the CPU's stream (encoded now: no stored match)"
        same = ref == datas and ten.qindices(ref) == ten.qindices(datas)
        log(f"phase 38: 10-bit test stream {name} on the card: "
            f"{sum(map(len, datas))} bytes, qindex {ten.qindices(datas)}; "
            f"{how}: {'identical' if same else 'DIFFERENT'}; decoded on "
            f"the card equal to recon")
        if not same:
            _fail(f"phase 38: {name}: the card's stream differs from the "
                  "CPU's")
    for bd in avif.CASES:
        frame = avif.CASES[bd]()
        pkt = avif.encode(bd, frame, None)
        decode_check([pkt], None)
        try:
            ref = bytes(avif.stored(bd, frame, pkt.data)[0])
            how = "stored"
        except AssertionError:
            ref = avif.encode(bd, frame, "cpu").data
            how = "encoded now: no stored match"
        log(f"phase 38: AVIF still {bd}-bit on the card: {len(pkt.data)} "
            f"bytes; the CPU's ({how}): "
            f"{'identical' if ref == pkt.data else 'DIFFERENT'}; decoded on "
            f"the card equal to recon")
        if ref != pkt.data:
            _fail(f"phase 38: the {bd}-bit AVIF still differs from the "
                  "CPU's")


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

    # this slice first (so that nothing the earlier paths left behind
    # weighs on the main path's timing): the 10-bit all-intra encode and
    # its variants, then the small streams of the CPU tests
    main_launches, by_path = phase_ten_bit(card)
    phase_ten_bit_cpu_vs_cuda()
    if "--this-slice" in sys.argv[1:]:
        # a short call while the slice is built: phases 1-4, 37, 38, 25
        return finish(card, krec, main_launches, by_path, smi)

    # the slice of the previous PR: rate control and the API surface,
    # then its small streams
    cif17 = synth_frames(17, *CIF)
    by_path.update(phase_rate_control(card, cif17)[1])
    phase_rate_control_cpu_vs_cuda()

    # the slice of the previous PR: the restoration ops, its main path and
    # variants, the small streams
    phase_restoration_ops()
    by_path.update(phase_post_filters(card, cif17)[1])
    phase_post_cpu_vs_cuda()

    # the M0-M4 slice: its ops and small clips, then the M4 GOP,
    # then the M4 key frames
    phase_quality_ops()
    phase_m4_cpu_vs_cuda()
    by_path["M4 GOP MCTF+TPL CIF x7"] = phase_m4_gop(card, cif17[:7])
    kl = phase_m4_key_frames(card)
    by_path["M4 send_picture DLF+CDEF CIF clip"] = kl["clip"]
    by_path["M4 send_picture DLF+CDEF CIF composite"] = kl["composite"]
    by_path["M4 send_pictures CIF x4"] = kl["batch"]

    # the slice of the previous PR: the GOP at M5-M9, its tools on small
    # clips, then bench.py's primary config at a cut depth (x3)
    phase_m6_tools_cpu_vs_cuda()
    by_path["M6 GOP MCTF+TPL CIF x3"] = phase_m6_gop(card, cif17[:3])

    import clips
    # the paths of the earlier slices at a cut depth (4 CIF / 1 720p
    # frames a batch, 3 CIF and 1 720p key frames at M6), so that the
    # whole script fits the time limit
    cif = synth_frames(CIF_FRAMES, *CIF)
    hd = synth_frames(HD_FRAMES, *HD)
    pkts_cif, dec_cif, by_path["M10 send_pictures CIF x4"] = phase_encode(
        "5", cif, *CIF, card)
    # phase 35's tiled run warmed the 720p M10 program
    by_path["M10 send_pictures 720p x1"] = phase_encode(
        "6", hd, *HD, card, warm=False)[2]
    phase_cpu_vs_cuda(cif[:4], pkts_cif, dec_cif)
    del pkts_cif, dec_cif

    phase_tools()
    key_cif = cif[:1] + [clips.screen_frame(*CIF, seed=1)]
    pk_m6, dec_m6, by_path["M6 send_picture CIF x2"] = phase_key_frames(
        "9", key_cif, *CIF, card)
    key_hd = [hd[0]]          # palette: the CIF screen frame of phase 9
    pk_m6_hd, _, by_path["M6 send_picture 720p x1"] = phase_key_frames(
        "10", key_hd, *HD, card, warm=False, need=("tx", "delta", "cfl"))
    by_path["M6 send_pictures CIF x4"] = phase_encode(
        "11a", cif, *CIF, card, preset=6)[2]
    by_path["M6 send_pictures 720p x1"] = phase_encode(
        "11b", hd, *HD, card, preset=6)[2]
    phase_cpu_vs_cuda_m6(key_cif, pk_m6, dec_m6)

    phase_filter_ops()
    pk_f, dec_f, hdr_f, n, _ = phase_filtered_key_frames(
        "14a", key_cif, *CIF, card, pk_m6)
    by_path["M6 send_picture DLF+CDEF CIF x2"] = n
    # the filter stage's profile at CIF only (14a)
    n = phase_filtered_key_frames("14b", key_hd, *HD, card, pk_m6_hd,
                                  profile=False)[3]
    by_path["M6 send_picture DLF+CDEF 720p x1"] = n
    by_path["M10 send_pictures DLF CIF x4"] = phase_encode(
        "15a", cif, *CIF, card, enable_dlf_flag=1)[2]
    by_path["M10 send_pictures DLF+CDEF CIF x4"] = phase_encode(
        "15b", cif, *CIF, card, **FILTERS)[2]
    phase_cpu_vs_cuda_filters(key_cif, pk_f, dec_f, hdr_f)

    # the GOP slice of the earlier PR (MCTF and TPL off) at a cut depth:
    # CIF x5 and 720p x3, no warm run
    phase_motion_ops()
    by_path["M10 GOP CIF x5"] = phase_gop("18", cif17[:5], *CIF, card,
                                          warm=0, profile=False)[2]
    by_path["M10 GOP 720p x3"] = phase_gop(
        "19", synth_frames(3, *HD), *HD, card, warm=0, shown_limit=3,
        profile=False)[2]
    phase_gop_cpu_vs_cuda()
    by_path["M12 GOP CIF x5"] = phase_gop("21", cif17[:5], *CIF, card,
                                          preset=12, warm=0,
                                          profile=False)[2]

    # this slice: the lookahead (MCTF, TPL, delta-q key frames)
    phase_lookahead_ops()
    _, launches = phase_lookahead_gop(card, cif17[:5])
    by_path["M10 GOP MCTF+TPL CIF x5"] = launches
    phase_lookahead_cpu_vs_cuda()
    return finish(card, krec, main_launches, by_path, smi)


def finish(card, krec, main_launches, by_path, smi):
    """Phase 25, the import check and the two last lines."""
    import torch
    from svt_av1_tpu_torch.ops import fused_txq
    # every batch size that a path gave K1 must have been checked against
    # the plain version; a size that phase 3 did not foresee is checked now
    unchecked = sorted(fused_txq.batches
                       - {r["b"] for r in krec["by_batch"]})
    rng = np.random.default_rng(22)
    for b in unchecked:
        check_txq(b, card, rng, krec, tag="25", ten=True)
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
    # launches of the 1080p 10-bit M10 key frame, the time at its batch
    # (one frame x 60 wave slots x 6 modes) on 10-bit residuals; every
    # size is under by_batch (bd: the residuals' bit depth)
    b0 = next(r for r in krec["by_batch"]
              if r["b"] == k1_batch(1, P1080_CODED, 10) and r["bd"] == 10)
    print(smi, flush=True)
    print(json.dumps({"kernels": [dict(
        name="fused_txq16", route="cuda",
        source="svt_av1_tpu_torch/csrc/fused_txq.cu",
        replaces="svt_av1_tpu/ops/pallas/fused_txq.py:32",
        launches=main_launches, max_abs_err=krec["max_abs_err"],
        ms=b0["us"] / 1000, plain_ms=b0["plain_us"] / 1000,
        bound_ms=b0["bound_us"] / 1000, bound_by=b0["bound_by"],
        library_ms=None, bound_us=b0["bound_us"], share=b0["share"],
        host_issue_ms=b0["host_issue_ms"], v1_ms=b0["v1_us"] / 1000,
        mismatches_10bit=krec["mismatches10"],
        worst_tie_distance_10bit=krec["worst10"],
        launches_by_path=by_path, by_batch=krec["by_batch"])]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
