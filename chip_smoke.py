#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (svt_av1_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and exits non-zero:
  1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
     exits non-zero without CUDA;
  2. build of the CUDA kernels from svt_av1_tpu_torch/csrc (nvcc, sm_90a)
     into build/kernels/;
  3. the fused transform+quantize kernel against its plain PyTorch version
     on the card (B = 2112, the CIF wave batch, and B = 100; qindex 140 and
     255), with the rounding-tie rule below, and both versions' median
     times over 50 runs (CUDA events);
  4. the inverse transform and the DC/V/H/SMOOTH/PAETH predictors on the
     card against the C-reference goldens in tests/golden/ (bit-exact);
  5. the main path: CIF 352x288, 32 frames, preset M10, qp 35, through
     Encoder(cfg, device="cuda").send_pictures, once to warm and once
     timed; the kernel's launch count over the timed run must be > 0; every
     packet is decoded by the port's decoder on the card and must equal
     Packet.recon exactly;
  6. the same encode and decode check at 1280x720, 8 frames;
  7. the first 4 CIF frames encoded on the CPU with the plain versions,
     against the card's: >= 99% of blocks equal, |dPSNR| <= 0.05 dB,
     |dbytes| <= 1%.

Tie rule for the forward transform: the kernel's float32 sums run in
another order than cuBLAS's, so a coefficient may differ from the plain
version's by at most 1, and only where its float64 value lies within 1e-2
of a half-integer; qcoeff/dqcoeff must equal the plain quantizer applied
to the kernel's own coefficients, exactly.

The second-to-last line is the kernels' JSON record, the last line
{"ok": true, "device": {...}}.
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


def cuda_median_ms(fn, runs=50, warm=5):
    import torch
    for _ in range(warm):
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def phase_kernel(card):
    import torch
    import tie_rule
    from svt_av1_tpu_torch.ops import fused_txq, quant
    from svt_av1_tpu_torch.ops import transforms as tf
    from svt_av1_tpu.codec import constants as cc
    fv, fh, _, _ = tf._fwd_matrices(cc.DCT_DCT, cc.TX_16X16)
    rng = np.random.default_rng(7)
    rec = None
    for b in (2112, 100):
        resid_np = rng.integers(-255, 256, (b, 16, 16)).astype(np.int32)
        exact = tie_rule.exact_coeffs(resid_np, fv, fh)
        resid = torch.from_numpy(resid_np).cuda()
        for qindex in (140, 255):
            qp = quant.to_device(quant.make_quant_params(qindex), "cuda")
            ck, qk, dk = fused_txq.fused_txq(resid, qp)
            cp, _, _ = fused_txq.fused_txq_plain(resid, qp)
            torch.cuda.synchronize()
            q_ref, d_ref = quant.quantize(ck, qp, cc.TX_16X16)
            if not (torch.equal(qk, q_ref) and torch.equal(dk, d_ref)):
                raise AssertionError("kernel qcoeff/dqcoeff differ from the "
                                     "quantizer on its own coefficients")
            nmis, maxd = tie_rule.tie_mismatches(ck.cpu().numpy(),
                                                 cp.cpu().numpy(), exact)
            ms = cuda_median_ms(lambda: fused_txq.fused_txq(resid, qp))
            plain_ms = cuda_median_ms(
                lambda: fused_txq.fused_txq_plain(resid, qp))
            log(f"phase 3: fused_txq B={b} qindex={qindex}: "
                f"{nmis} of {resid.numel()} coefficients differ from the "
                f"plain version (all on rounding ties, max |diff| {maxd}); "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (median of 50,"
                f" {card})")
            if b == 2112 and qindex == 140:
                rec = dict(max_abs_err=maxd, ms=ms, plain_ms=plain_ms)
            else:
                rec["max_abs_err"] = max(rec["max_abs_err"], maxd)
    return rec


def phase_goldens():
    import torch
    import golden_defs as gd
    from svt_av1_tpu.codec import constants as cc
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


def encode(frames, w, h, device):
    from svt_av1_tpu_torch.api.encoder import Encoder, EncoderConfig
    enc = Encoder(EncoderConfig(source_width=w, source_height=h, qp=35,
                                enc_mode=10), device=device)
    enc.send_pictures(frames, eos=True)
    pkts = []
    while (p := enc.get_packet()) is not None:
        pkts.append(p)
    if len(pkts) != len(frames):
        raise AssertionError(f"{len(pkts)} packets for {len(frames)} frames")
    return pkts


def decode_check(pkts, device):
    """Port decoder on ``device``; every frame must equal Packet.recon.
    Returns the parsed decisions per frame."""
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
    return decisions


def phase_encode(tag, frames, w, h, card):
    import torch
    from svt_av1_tpu_torch.ops import fused_txq
    encode(frames, w, h, "cuda")                     # warm
    torch.cuda.synchronize()
    fused_txq.launches = 0
    t0 = time.perf_counter()
    pkts = encode(frames, w, h, "cuda")
    dt = time.perf_counter() - t0
    launches = fused_txq.launches
    if launches <= 0:
        raise AssertionError("the main path never launched fused_txq")
    nbytes = sum(len(p.data) for p in pkts)
    mpsnr = float(np.mean([psnr(f[0], p.recon["y"])
                           for f, p in zip(frames, pkts)]))
    t1 = time.perf_counter()
    decisions = decode_check(pkts, "cuda")
    log(f"phase {tag}: {w}x{h} x{len(frames)} M10 qp35 on cuda: "
        f"{len(frames) / dt:.3f} fps hot ({dt:.3f} s), {nbytes} bytes, "
        f"mean Y-PSNR {mpsnr:.4f} dB, fused_txq launches {launches} "
        f"({card}); decoder on cuda matches recon "
        f"({time.perf_counter() - t1:.1f} s)")
    return pkts, decisions, launches


def block_agreement(da, db):
    same = tot = 0
    for fa, fb in zip(da, db):
        for k, a in fa.items():
            b = fb[k]
            tot += 1
            same += (a.y_mode == b.y_mode and a.uv_mode == b.uv_mode
                     and np.array_equal(a.qcoeff_y, b.qcoeff_y)
                     and np.array_equal(a.qcoeff_u, b.qcoeff_u)
                     and np.array_equal(a.qcoeff_v, b.qcoeff_v))
    return same / max(tot, 1)


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
    from svt_av1_tpu_torch.ops import fused_txq

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

    cif = synth_frames(32, *CIF)
    pkts_cif, dec_cif, launches = phase_encode("5", cif, *CIF, card)
    phase_encode("6", synth_frames(8, *HD), *HD, card)
    phase_cpu_vs_cuda(cif[:4], pkts_cif, dec_cif)

    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    log(smi)
    log(json.dumps({"kernels": [dict(
        name="fused_txq16", route="cuda",
        source="svt_av1_tpu_torch/csrc/fused_txq.cu",
        replaces="svt_av1_tpu/ops/pallas/fused_txq.py:32",
        launches=launches, **krec)]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
