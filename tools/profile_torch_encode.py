#!/usr/bin/env python3
"""Where a key-frame encode, or an inter frame, of the PyTorch/CUDA port
spends its time.

    python3 tools/profile_torch_encode.py [--size 352x288] [--preset 6]
                                          [--filters] [--gop]

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
With --gop it profiles one inter frame of the fast GOP path instead (the
middle frame of a 9-frame clip coded from the first as LAST and the last
as ALTREF, at qindex 140, DLF and CDEF on, the preset's P1 tools): two
warm runs, three timed on the host clock (P1 + P2 dispatch, then the
bundled copy; each ends in a synchronise), then one under torch.profiler,
and prints one JSON line with, per op family of the two programs (the
named ranges p1.hme, p1.gm_fit, p1.interp_pick, p1.warp, p1.pass_a,
p1.compound, p1.pass_b, p1.merges, p2; p1.alts, the OBMC and inter-intra
alternatives of M5-M8, lies inside p1.pass_b), the host milliseconds inside the
range, the device milliseconds of the kernels it launched and the span
of its kernels on the device timeline, beside the frame's kernel count,
device time and device-busy share; then one JSON line for the lookahead
stages, each named as the encoder's stage (and run inside a profiler
range of that name): key_tf (MCTF of a frame against its next 2 frames),
gop_tf (a mini-GoP base against 3 neighbours), key_tpl (TPL over a key
and its 8-frame IPP chain) and gop_tpl (TPL over a 3-level mini-GoP of 8
in decode order with its 8-frame IPP tail), with three host-clock
seconds each (the call ends with its results on the host), its device
kernels, device time and device-busy share, and the seconds per frame
the stage serves (1 frame for MCTF, 9 for key_tpl, 8 for gop_tpl).
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
    ap.add_argument("--preset", type=int, default=None,
                    help="default: 6 for key frames, 10 with --gop")
    ap.add_argument("--filters", action="store_true",
                    help="encode with DLF and CDEF on, and profile the "
                         "filter stage of each frame kind on its own")
    ap.add_argument("--gop", action="store_true",
                    help="profile one inter frame of the GOP path by op "
                         "family")
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
    if args.gop:
        return gop_profile(w, h, 10 if args.preset is None else args.preset)
    args.preset = 6 if args.preset is None else args.preset
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


FAMILIES = ("p1.hme", "p1.gm_fit", "p1.interp_pick", "p1.warp", "p1.pass_a",
            "p1.compound", "p1.pass_b", "p1.alts", "p1.merges", "p2")


def gop_profile(w, h, preset):
    """One inter frame of the fast GOP path, by op family (see the module
    doc)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    import clips
    from svt_av1_tpu_torch.utils import kernel_profile
    dispatch, collect = kernel_profile.inter_frame(
        clips.natural_clip(9, w, h), w, h, preset)
    frame = lambda: collect(dispatch())
    for _ in range(2):
        frame()
    torch.cuda.synchronize()
    hot = []
    for _ in range(3):
        t0 = time.perf_counter()
        frame()
        torch.cuda.synchronize()
        hot.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        frame()
        torch.cuda.synchronize()
    from torch.autograd import DeviceType
    fam = {}
    for k in prof.key_averages():
        if k.key not in FAMILIES:
            continue
        f = fam.setdefault(k.key, dict(calls=0))
        dev = getattr(k, "device_time_total",
                      getattr(k, "cuda_time_total", 0)) / 1000.0
        if k.device_type == DeviceType.CPU:
            # the host time inside the range, and the device time of the
            # kernels its ops launched
            f.update(calls=int(k.count), host_ms=k.cpu_time_total / 1000.0,
                     kernel_ms=dev)
        else:
            # the range's span on the device timeline
            f["device_span_ms"] = dev
    kp = kernel_profile.device_kernels(frame, top=8)
    med = float(np.median(hot))
    dev_ms = kp["device_ms"]
    print(json.dumps(dict(
        mode="gop inter frame", size=f"{w}x{h}", preset=preset,
        refs="LAST + ALTREF", hot_s_per_frame=hot,
        kernel_launches=kp["launches"], copies=kp["copies"],
        device_ms=dev_ms,
        device_busy=(dev_ms / 1000.0 / med if dev_ms != "not measured"
                     else dev_ms),
        families=fam, top_kernels=kp["top_kernels"])), flush=True)
    lookahead_profile(w, h)
    return 0


def lookahead_profile(w, h):
    """The lookahead stages of the GOP path on the card (see the module
    doc), on a 17-frame clip."""
    import torch
    import clips
    from svt_av1_tpu_torch.pipeline import gop, gop_fast, tf_stage, tpl
    from svt_av1_tpu_torch.utils import kernel_profile
    frames = clips.natural_clip(17, w, h)
    srcs = [f[0] for f in frames]
    order, deps = tpl.minigop_group(0, gop.minigop_schedule(0, 8),
                                    range(9, 17))
    stages = dict(
        key_tf=(lambda: tf_stage.mctf_filter_frame(
            frames[0], frames[1:3]), 1),
        gop_tf=(lambda: tf_stage.mctf_filter_frame(
            frames[8], [frames[7], frames[9], frames[6]]), 1),
        key_tpl=(lambda: gop_fast.tpl_group_stats(
            srcs[:9], [None] + [[i] for i in range(8)]), 9),
        gop_tpl=(lambda: gop_fast.tpl_group_stats(
            [srcs[p] for p in order], deps), 8))
    out = {}
    for name, (fn, per) in stages.items():
        run = lambda: _in_range(name, fn)
        run()
        torch.cuda.synchronize()
        hot = []
        for _ in range(3):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            hot.append(time.perf_counter() - t0)
        kp = kernel_profile.device_kernels(run)
        med = float(np.median(hot))
        dev_ms = kp["device_ms"]
        out[name] = dict(
            hot_s=hot, frames_served=per, hot_s_per_frame=med / per,
            kernel_launches=kp["launches"], copies=kp["copies"],
            device_ms=dev_ms,
            device_ms_per_frame=(dev_ms / per if dev_ms != "not measured"
                                 else dev_ms),
            device_busy=(dev_ms / 1000.0 / med if dev_ms != "not measured"
                         else dev_ms),
            top_kernels=kp["top_kernels"])
    print(json.dumps(dict(mode="gop lookahead", size=f"{w}x{h}",
                          stages=out)), flush=True)


def _in_range(name, fn):
    import torch
    with torch.profiler.record_function(name):
        return fn()


if __name__ == "__main__":
    sys.exit(main())
