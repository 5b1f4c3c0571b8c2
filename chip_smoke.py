#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (svt_av1_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and exits non-zero:
  1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
     exits non-zero without CUDA;
  2. build of the CUDA kernels from svt_av1_tpu_torch/csrc (nvcc, sm_90a)
     into build/kernels/;
  3. the fused transform+quantize kernel (K1) on the card, at B = 2112
     and 1920 (the CIF and 720p wave batches at M10), 100, and 2816 and
     2560 (the same at M5-M9: 8 luma modes), qindex 140 and 255:
     bit-identical to the first kernel (svt_fused_txq16_v1, kept in
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
  5. the main path: CIF 352x288, 32 frames, preset M10, qp 35, through
     Encoder(cfg).send_pictures on the default device (the card), once to
     warm and once timed; the kernel's launch count over the timed run
     must be > 0; every packet is decoded by the port's decoder on the
     card and must equal Packet.recon exactly;
  6. the same encode and decode check at 1280x720, 8 frames;
  7. the first 4 CIF frames encoded on the CPU with the plain versions,
     against the card's: >= 99% of blocks equal, |dPSNR| <= 0.05 dB,
     |dbytes| <= 1%;
  8. the zone-1/zone-3 directional predictors, the CfL AC buffer and
     prediction (exact) and the 16x16 ADST_ADST/ADST_DCT/DCT_ADST forward
     transforms (tie rule) on the card against the port's CPU run;
  9. preset M6 (tx-type search, angle deltas, CfL, palette) through
     Encoder(cfg).send_picture / flush on the default device: CIF, 4
     frames of the bench clip and 1 screen-content frame, one warm frame
     then timed; every packet decoded on the card and equal to
     Packet.recon; seconds per frame, bytes, Y-PSNR, the counts of blocks
     with a non-DCT tx type, a non-zero angle delta, CfL and palette
     (each must be > 0) and the host_ec seconds;
 10. the same at 1280x720, 1 clip frame and 1 screen-content frame;
 11. M6 through send_pictures (the batched program with the preset's 8
     plain luma modes): CIF x32 and 720p x8, hot fps, bytes, PSNR, K1
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
 15. M10 through send_pictures, CIF x32, with DLF only (array route) and
     with DLF + CDEF (per-block route, CDEF signaled at strength 0 as in
     the reference): hot fps, bytes, PSNR, K1 launches > 0, decoder exact;
 16. the first clip frame and the screen-content frame at M6 with both
     filters on the CPU against the card's: >= 99% of blocks equal, the
     same filter levels and CDEF strengths, |dPSNR| <= 0.05 dB,
     |dbytes| <= 1%.

K1's launch count is set to 0 before each encode path and read after it;
the send_pictures paths (with and without the filters) must have launched
it, the M6 send_picture paths do not run it (their luma step searches
four tx types, as the reference's does without its kernel).

Tie rule for the forward transform: the kernel's float32 sums run in
another order than cuBLAS's, so a coefficient may differ from the plain
version's by at most 1, and only where its float64 value lies within 1e-2
of a half-integer; qcoeff/dqcoeff must equal the plain quantizer applied
to the kernel's own coefficients, exactly.

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


def log(msg):
    print(msg, flush=True)


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
# K1's batch on the main paths: frames x wave slots x luma modes at CIF
# x32 / 720p x8 with 6 modes (M10) and 8 modes (M5-M9); 100 is a small one
K1_BATCHES = (2112, 1920, 100, 2816, 2560)
GRAPH_REPLAYS = 50


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


def time_txq(resid, card, plain=True):
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
    log(f"phase 3: fused_txq B={b} qindex=140 device time per launch "
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


def phase_kernel(card):
    """K1 (fused_txq16): bit-identity with the first kernel, the tie rule
    against the plain version, exact quantizer on the kernel's own
    coefficients; device time per launch of both kernels and the plain
    version in turns; host issue time of the wrapper."""
    import torch
    import tie_rule
    from svt_av1_tpu_torch.codec import constants as cc
    from svt_av1_tpu_torch.ops import fused_txq, quant
    from svt_av1_tpu_torch.ops import transforms as tf
    fv, fh, _, _ = tf._fwd_matrices(cc.DCT_DCT, cc.TX_16X16)
    rng = np.random.default_rng(7)
    rec = dict(max_abs_err=0, by_batch=[])
    for b in K1_BATCHES:
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
                                     "differ between the kernel and the "
                                     "first kernel")
            q_ref, d_ref = quant.quantize(ck, qp, cc.TX_16X16)
            if not (torch.equal(qk, q_ref) and torch.equal(dk, d_ref)):
                raise AssertionError("kernel qcoeff/dqcoeff differ from the "
                                     "quantizer on its own coefficients")
            nmis, maxd = tie_rule.tie_mismatches(ck.cpu().numpy(),
                                                 cp.cpu().numpy(), exact)
            rec["max_abs_err"] = max(rec["max_abs_err"], maxd)
            log(f"phase 3: fused_txq B={b} qindex={qindex}: 0 of "
                f"{3 * resid.numel()} coeff/qcoeff/dqcoeff values differ "
                f"from the first kernel; {nmis} of {resid.numel()} "
                f"coefficients differ from the plain version (all on "
                f"rounding ties, max |diff| {maxd}); qcoeff/dqcoeff exact")
        rec["by_batch"].append(time_txq(resid, card))
    # a batch far beyond the L2: bound by device memory
    resid = torch.randint(-255, 256, (135168, 16, 16), dtype=torch.int32,
                          device="cuda")
    qp = quant.to_device(quant.make_quant_params(140), "cuda")
    n_v1 = int((v2_launcher(resid, qp)() != V1(resid, qp).launch()).sum())
    if n_v1:
        raise AssertionError(f"B=135168: {n_v1} values differ between the "
                             "kernel and the first kernel")
    rec["by_batch"].append(time_txq(resid, card, plain=False))
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


def phase_key_frames(tag, frames, w, h, card):
    """M6 through send_picture / flush on the default device: one warm
    frame, then the timed run; every packet decoded on the card."""
    import torch
    from svt_av1_tpu_torch.ops import fused_txq
    from svt_av1_tpu_torch.utils import profiling
    encode(frames[:1], w, h, None, 6, batched=False)  # warm
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
    for k in ("tx", "delta", "cfl", "palette"):
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
    log(smi)
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

    import clips
    cif = synth_frames(32, *CIF)
    hd = synth_frames(8, *HD)
    by_path = {}
    pkts_cif, dec_cif, by_path["M10 send_pictures CIF x32"] = phase_encode(
        "5", cif, *CIF, card)
    by_path["M10 send_pictures 720p x8"] = phase_encode(
        "6", hd, *HD, card)[2]
    phase_cpu_vs_cuda(cif[:4], pkts_cif, dec_cif)
    del pkts_cif, dec_cif

    phase_tools()
    key_cif = cif[:4] + [clips.screen_frame(*CIF, seed=1)]
    pk_m6, dec_m6, by_path["M6 send_picture CIF x5"] = phase_key_frames(
        "9", key_cif, *CIF, card)
    key_hd = [hd[0], clips.screen_frame(*HD, seed=1)]
    pk_m6_hd, _, by_path["M6 send_picture 720p x2"] = phase_key_frames(
        "10", key_hd, *HD, card)
    launches = by_path["M6 send_pictures CIF x32"] = phase_encode(
        "11a", cif, *CIF, card, preset=6)[2]
    by_path["M6 send_pictures 720p x8"] = phase_encode(
        "11b", hd, *HD, card, preset=6)[2]
    phase_cpu_vs_cuda_m6([key_cif[0], key_cif[4]], [pk_m6[0], pk_m6[4]],
                         [dec_m6[0], dec_m6[4]])

    phase_filter_ops()
    pk_f, dec_f, hdr_f, n, _ = phase_filtered_key_frames(
        "14a", key_cif, *CIF, card, pk_m6)
    by_path["M6 send_picture DLF+CDEF CIF x5"] = n
    n = phase_filtered_key_frames("14b", key_hd, *HD, card, pk_m6_hd)[3]
    by_path["M6 send_picture DLF+CDEF 720p x2"] = n
    by_path["M10 send_pictures DLF CIF x32"] = phase_encode(
        "15a", cif, *CIF, card, enable_dlf_flag=1)[2]
    by_path["M10 send_pictures DLF+CDEF CIF x32"] = phase_encode(
        "15b", cif, *CIF, card, **FILTERS)[2]
    phase_cpu_vs_cuda_filters([key_cif[0], key_cif[4]], [pk_f[0], pk_f[4]],
                              [dec_f[0], dec_f[4]], [hdr_f[0], hdr_f[4]])

    leaked = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith("jax.")
                    or m == "svt_av1_tpu" or m.startswith("svt_av1_tpu."))
    if leaked:
        raise AssertionError(f"modules of JAX or of the JAX package were "
                             f"loaded: {leaked[:8]}")
    # the line's top-level numbers are K1's at this slice's main-path
    # batch (M6 send_pictures, CIF x32); every size is under by_batch
    b0 = next(r for r in krec["by_batch"] if r["b"] == 2816)
    log(smi)
    log(json.dumps({"kernels": [dict(
        name="fused_txq16", route="cuda",
        source="svt_av1_tpu_torch/csrc/fused_txq.cu",
        replaces="svt_av1_tpu/ops/pallas/fused_txq.py:32",
        launches=launches, max_abs_err=krec["max_abs_err"],
        ms=b0["us"] / 1000, plain_ms=b0["plain_us"] / 1000,
        bound_ms=b0["bound_us"] / 1000, bound_by=b0["bound_by"],
        library_ms=None, bound_us=b0["bound_us"], share=b0["share"],
        host_issue_ms=b0["host_issue_ms"], v1_ms=b0["v1_us"] / 1000,
        launches_by_path=by_path, by_batch=krec["by_batch"])]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
