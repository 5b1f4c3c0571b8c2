#!/usr/bin/env python3
"""How many device kernels HME's block-matching search launches, with
F.unfold's im2col and with the one strided copy that ops/me.ssd_search
uses, and what that does to one multi-stream inter step's count.

    python3 tools/hme_launches.py [--out hme_launches.json]

Needs one NVIDIA GPU.  Prints one JSON line per measurement:
  - ``ssd_search``: the level-0 search of a 1080p frame's 16x16 blocks
    (radius 3, S x 8,160 blocks) for S = 1 and 4, each form three times
    on the host clock and once under torch.profiler
    (kernel_profile.device_kernels: launches, device ms), but for the
    F.unfold form at S = 4: the profiler's parse of one op with 32,640
    kernels did not end in 20 minutes on the H100, and at S = 1 (8,160)
    it ended in about a minute in some runs and not in ten in others,
    so these cases run last; the two forms' costs must be equal;
  - ``step``: one compound B step at M10 (chip_smoke.py's phase-42
    step, bench clip): at CIF for S = 1, 2 and 4 streams with the
    strided copy and for S = 1 and 2 with F.unfold, at 1080p (coded
    1920x1088) for S = 1 and 4 with the strided copy; its device kernels
    by named range (kernel_profile.range_kernels), the total, and the
    seconds of the profiled step and of the count.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def unfold_search(src_blocks, windows):
    """ssd_search with F.unfold's (B, h*w, L) im2col patches: the form
    ops/me.py used before its one strided copy."""
    import torch
    import torch.nn.functional as F
    from svt_av1_tpu_torch.ops import me as me_ops
    b, h, w = src_blocks.shape
    _, wh, ww = windows.shape
    oh, ow = wh - h + 1, ww - w + 1
    winf = windows.to(torch.float32)
    filt = src_blocks.to(torch.float32).reshape(b, 1, h * w)
    patches = F.unfold(winf[:, None], (h, w))
    cross = torch.bmm(filt, patches).reshape(b, oh, ow)
    ref_sq = me_ops._box_sum(windows.to(torch.int32) ** 2, h, w)
    src_sq = (filt * filt).sum(dim=(1, 2))
    return ref_sq.to(torch.float32) - 2.0 * cross + src_sq[:, None, None]


def search_case(n_streams, rad=3):
    import torch
    from svt_av1_tpu_torch.ops import me as me_ops
    from svt_av1_tpu_torch.utils import kernel_profile
    b = n_streams * 68 * 120
    rng = np.random.default_rng(n_streams)
    src = torch.from_numpy(rng.integers(0, 256, (b, 16, 16),
                                        dtype=np.int32)).cuda()
    win = torch.from_numpy(rng.integers(0, 256, (b, 16 + 2 * rad,
                                                 16 + 2 * rad),
                                        dtype=np.int32)).cuda()
    out = {}
    ref = None
    for name, fn in (("unfold", unfold_search),
                     ("strided", me_ops.ssd_search)):
        got = fn(src, win)
        torch.cuda.synchronize()
        if ref is None:
            ref = got
        elif not torch.equal(got, ref):
            raise SystemExit(f"ssd_search forms differ at S = {n_streams}")
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn(src, win)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        out[name] = dict(wall_s=walls)
        if name == "unfold" and n_streams > 1:
            out[name]["launches"] = "not profiled"
            continue
        prof = kernel_profile.device_kernels(lambda: fn(src, win), top=3)
        out[name].update(launches=prof["launches"],
                         device_ms=prof["device_ms"],
                         top=prof["top_kernels"])
    return dict(what="ssd_search", streams=n_streams, blocks=b, rad=rad,
                **out)


def step_case(n_streams, form, size):
    import chip_smoke
    from svt_av1_tpu_torch.ops import me as me_ops
    streams = chip_smoke.ms_streams(n_streams, size)
    keep = me_ops.ssd_search
    if form == "unfold":
        me_ops.ssd_search = unfold_search
    try:
        prof, k1 = chip_smoke.ms_launches(
            streams, chip_smoke.MS_QINDICES[:n_streams])
    finally:
        me_ops.ssd_search = keep
    return dict(what="step", size="%dx%d" % size, streams=n_streams,
                form=form, k1=k1, **prof)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from svt_av1_tpu_torch import device as device_mod
    device_mod.resolve(None)
    lines = []

    def emit(line):
        lines.append(line)
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "w") as f:
                f.write("".join(json.dumps(x) + "\n" for x in lines))

    emit(dict(torch=torch.__version__, cuda=torch.version.cuda,
              card=torch.cuda.get_device_name(0)))
    import chip_smoke
    for size, form, counts in ((chip_smoke.P1080, "strided", (1, 4)),
                               (chip_smoke.CIF, "strided", (1, 2, 4)),
                               (chip_smoke.CIF, "unfold", (1, 2))):
        for s in counts:
            emit(step_case(s, form, size))
    for s in (1, 4):
        emit(search_case(s))

if __name__ == "__main__":
    main()
