"""The port's command-line app: the counterpart of svt_av1_tpu/app/cli.py
(the reference's SvtAv1EncApp), with the same arguments and output.

Usage:
  python -m svt_av1_tpu_torch.app.cli -i in.y4m -b out.ivf --preset 12 --crf 35

It encodes on the current CUDA device and raises without CUDA; a caller
in Python runs it on the CPU with ``main(argv, device="cpu")``.  Each
``-i`` / ``-b`` pair is one channel, an independent encode.  The last
line on stderr gives the frames, seconds, fps and mean Y-PSNR.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from svt_av1_tpu_torch import device as device_mod
from svt_av1_tpu_torch.api.config import EncoderConfig, parse_parameter
from svt_av1_tpu_torch.api.encoder import Encoder
from svt_av1_tpu_torch.utils.ivf import IVFWriter
from svt_av1_tpu_torch.utils.y4m import Y4MReader


def build_parser():
    p = argparse.ArgumentParser(prog="SvtAv1TorchEncApp",
                                description="PyTorch/CUDA AV1 encoder")
    p.add_argument("-i", "--input", required=True, action="append",
                   help="input .y4m (repeat for multi-channel)")
    p.add_argument("-b", "--output", required=True, action="append",
                   help="output .ivf (one per input channel)")
    p.add_argument("--preset", type=int, default=10)
    p.add_argument("--crf", type=int, default=35)
    p.add_argument("--keyint", type=int, default=-2)
    p.add_argument("-n", "--frames", type=int, default=0,
                   help="max frames to encode (0 = all)")
    p.add_argument("--svtav1-params", default="",
                   help="colon-separated name=value pairs")
    p.add_argument("--progress", type=int, default=1)
    return p


def main(argv=None, device=None):
    """Run the app on ``argv`` (sys.argv[1:] if None) on ``device`` (the
    current CUDA device if None).  Returns the exit code."""
    args = build_parser().parse_args(argv)
    device = device_mod.resolve(device)
    if len(args.input) != len(args.output):
        print("channel count mismatch: need one -b per -i",
              file=sys.stderr)
        return 1
    rc = 0
    for cin, cout in zip(args.input, args.output):
        rc |= _encode_channel(args, cin, cout, device)
    return rc


def _encode_channel(args, input_path, output_path, device):
    reader = Y4MReader(input_path)
    hdr = reader.header
    cfg = EncoderConfig(source_width=hdr.width, source_height=hdr.height,
                        encoder_bit_depth=hdr.bit_depth,
                        frame_rate_numerator=hdr.fps_num,
                        frame_rate_denominator=hdr.fps_den,
                        enc_mode=args.preset, qp=args.crf,
                        intra_period_length=args.keyint)
    for tok in filter(None, args.svtav1_params.split(":")):
        name, _, value = tok.partition("=")
        parse_parameter(cfg, name, value)

    enc = Encoder(cfg, device=device)
    writer = IVFWriter(output_path, hdr.width, hdr.height,
                       hdr.fps_num, hdr.fps_den)
    t0 = time.time()
    count = 0
    psnr_acc = []
    sources = {}
    sent = 0

    def drain():
        nonlocal count
        while True:
            pkt = enc.get_packet()
            if pkt is None:
                return
            writer.write_frame(pkt.data, pkt.pts)
            if not pkt.displayed:
                continue  # hidden frame: displayed later (show_existing)
            src_y = sources.pop(pkt.pts, None)
            if pkt.recon is not None and src_y is not None:
                mse = np.mean((pkt.recon["y"].astype(np.float64)
                               - src_y.astype(np.float64)) ** 2)
                peak = float((1 << hdr.bit_depth) - 1)
                psnr_acc.append(99.0 if mse == 0 else
                                10 * np.log10(peak ** 2 / mse))
            count += 1
            if args.progress:
                print(f"\rencoded {count}", end="", file=sys.stderr)

    for frame in reader:
        sources[sent] = frame.y
        last = bool(args.frames and sent + 1 >= args.frames)
        enc.send_picture(frame.y, frame.u, frame.v, eos=last)
        sent += 1
        drain()
        if last:
            break
    if not enc.done:
        enc.flush()
        drain()
    writer.close()
    reader.close()
    dt = time.time() - t0
    fps = count / dt if dt > 0 else 0.0
    print(file=sys.stderr)
    print(f"Encoded {count} frames in {dt:.2f}s ({fps:.3f} fps)"
          + (f", mean Y-PSNR {np.mean(psnr_acc):.2f} dB" if psnr_acc else ""),
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
