#!/usr/bin/env python3
"""Where a key-frame encode of the PyTorch/CUDA port spends its time.

    python3 tools/profile_torch_encode.py [--size 352x288] [--preset 6]
                                          [--filters]

Needs one NVIDIA GPU.  Encodes one frame of the bench clip and one
screen-content frame through Encoder.send_picture on the card: two warm
frames, then three timed frames of each kind (host clock around the call,
which ends with the results on the host), then one frame of each kind
under torch.profiler (CPU + CUDA activities).  Prints, per kind, one JSON
line: hot seconds per frame, the number of device kernels the frame
launched (copies and memsets apart), the sum of their device time, the
device-busy share (device time over the median hot wall time) and the
five kernels with the most device time.  With --filters the encode runs
with DLF and CDEF on, and each line adds ``filter_stage``: the in-loop
filter stage alone (DLF level search or heuristic level, CDEF search and
apply) run on the frame's decisions and recon, three times on the host
clock (``hot_s``, each ending in a synchronise), then once under
torch.profiler for the same counts, with the levels and strengths it
chose; and ``dlf_only``, the same for an encoder with DLF alone (at
M9-M13 the heuristic level that ``send_pictures`` applies per frame).
The first line is the card's name and power limit.
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
    ap.add_argument("--filters", action="store_true",
                    help="encode with DLF and CDEF on, and profile the "
                         "filter stage of each frame kind on its own")
    args = ap.parse_args()
    w, h = (int(x) for x in args.size.split("x"))
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_encode: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import clips
    from svt_av1_tpu_torch.api.encoder import Encoder, EncoderConfig
    from svt_av1_tpu_torch.codec import obu
    from svt_av1_tpu_torch.utils import kernel_profile
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    kinds = dict(
        clip=clips.natural_clip(1, w, h, chroma_noise=False)[0],
        screen=clips.screen_frame(w, h, seed=1))
    filt = dict(enable_dlf_flag=1, cdef_level=1) if args.filters else {}
    enc = Encoder(EncoderConfig(source_width=w, source_height=h, qp=35,
                                enc_mode=args.preset, **filt))
    dlf_enc = Encoder(EncoderConfig(source_width=w, source_height=h, qp=35,
                                    enc_mode=args.preset, enable_dlf_flag=1))

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
        res = {}
        prof = kernel_profile.device_kernels(
            lambda: res.update(n=one(frame)[1]))
        med = float(np.median(hot))
        dev_ms = prof["device_ms"]
        line = dict(
            kind=kind, size=f"{w}x{h}", preset=args.preset,
            filters=args.filters, bytes=res["n"], hot_s_per_frame=hot,
            traced_s=prof["wall_s"], kernel_launches=prof["launches"],
            copies=prof["copies"], device_ms=dev_ms,
            device_busy=(dev_ms / 1000.0 / med
                         if dev_ms != "not measured" else dev_ms),
            top_kernels=prof["top_kernels"])
        if args.filters:
            # the filter stage alone, on this frame's decisions and recon:
            # the encoder's (DLF and CDEF) and a DLF-only encoder's
            y, u, v = enc._pad(*frame)
            qindex = enc._rc.frame_qindex()
            decisions, recon, _ = enc._mode_decision(y, u, v, qindex)
            src = dict(y=y, u=u, v=v)
            for name, e in (("filter_stage", enc), ("dlf_only", dlf_enc)):
                fp = obu.FrameParams(base_q_idx=qindex)
                run = lambda: e._filter(decisions, recon, fp, qindex, src)
                hot_stage = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    run()
                    torch.cuda.synchronize()
                    hot_stage.append(time.perf_counter() - t0)
                line[name] = dict(
                    kernel_profile.device_kernels(run), hot_s=hot_stage,
                    filter_level=fp.filter_level,
                    filter_level_uv=fp.filter_level_uv,
                    cdef_strengths=fp.cdef_strengths)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
