#!/usr/bin/env python3
"""Where a key-frame encode of the PyTorch/CUDA port spends its time.

    python3 tools/profile_torch_encode.py [--size 352x288] [--preset 6]

Needs one NVIDIA GPU.  Encodes one frame of the bench clip and one
screen-content frame through Encoder.send_picture on the card: two warm
frames, then three timed frames of each kind (host clock around the call,
which ends with the results on the host), then one frame of each kind
under torch.profiler (CPU + CUDA activities).  Prints, per kind, one JSON
line: hot seconds per frame, the number of device kernels the frame
launched (copies and memsets apart), the sum of their device time, the
device-busy share (device time over the median hot wall time) and the
five kernels with the most device time.  The first line is the card's
name and power limit.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="352x288")
    ap.add_argument("--preset", type=int, default=6)
    args = ap.parse_args()
    w, h = (int(x) for x in args.size.split("x"))
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_encode: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import clips
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from svt_av1_tpu_torch.api.encoder import Encoder, EncoderConfig
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    kinds = dict(
        clip=clips.natural_clip(1, w, h, chroma_noise=False)[0],
        screen=clips.screen_frame(w, h, seed=1))
    enc = Encoder(EncoderConfig(source_width=w, source_height=h, qp=35,
                                enc_mode=args.preset))

    def one(frame):
        t0 = time.perf_counter()
        enc.send_picture(*frame)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        return dt, len(enc.get_packet().data)

    for frame in kinds.values():
        one(frame)
    for kind, frame in kinds.items():
        hot = [one(frame)[0] for _ in range(3)]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            traced, nbytes = one(frame)
        # device-side rows only: a kernel appears under its own name,
        # and the CPU op that launched it carries the same time again
        rows = []
        for k in prof.key_averages():
            dev = getattr(k, "self_device_time_total",
                          getattr(k, "self_cuda_time_total", 0))
            if k.device_type == DeviceType.CUDA and dev > 0:
                rows.append((k.key, int(k.count), float(dev)))
        copies = sum(r[1] for r in rows
                     if r[0].startswith(("Memcpy", "Memset")))
        launches = sum(r[1] for r in rows) - copies
        dev_ms = sum(r[2] for r in rows) / 1000.0
        med = float(np.median(hot))
        top = sorted(rows, key=lambda r: -r[2])[:5]
        print(json.dumps(dict(
            kind=kind, size=f"{w}x{h}", preset=args.preset, bytes=nbytes,
            hot_s_per_frame=hot, traced_s=traced, kernel_launches=launches,
            copies=copies,
            device_ms=dev_ms if rows else "not measured",
            device_busy=(dev_ms / 1000.0 / med) if rows else "not measured",
            top_kernels=[dict(name=n[:60], count=c, ms=t / 1000.0)
                         for n, c, t in top])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
