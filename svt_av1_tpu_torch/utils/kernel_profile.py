"""Device kernels of one call, from torch.profiler (CPU + CUDA activities),
and the one-inter-frame call that the GOP profiles run.

Used by tools/profile_torch_encode.py and chip_smoke.py; needs a CUDA
device.  A kernel appears in ``key_averages()`` under its own name as a
CUDA row, and the CPU op that launched it carries the same time again, so
only the device-side rows are summed.  A named range
(``torch.profiler.record_function``) also gets a device-side row, with
the span of the kernels it launched; a device row whose name is also a
CPU row's is such a range and is left out.
"""
from __future__ import annotations

import time


def device_kernels(fn, top: int = 5):
    """Run ``fn()`` once under torch.profiler, then synchronise.  Returns
    dict(wall_s, launches, copies, device_ms, top_kernels): launches counts
    the device kernels (copies and memsets apart, counted in copies);
    device_ms sums the device time of every device row, or is the string
    "not measured" when the profiler saw no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    averages = prof.key_averages()
    ranges = {k.key for k in averages if k.device_type == DeviceType.CPU}
    for k in averages:
        dev = getattr(k, "self_device_time_total",
                      getattr(k, "self_cuda_time_total", 0))
        if (k.device_type == DeviceType.CUDA and dev > 0
                and k.key not in ranges):
            rows.append((k.key, int(k.count), float(dev)))
    copies = sum(r[1] for r in rows if r[0].startswith(("Memcpy", "Memset")))
    return dict(
        wall_s=wall, launches=sum(r[1] for r in rows) - copies,
        copies=copies,
        device_ms=sum(r[2] for r in rows) / 1000.0 if rows
        else "not measured",
        top_kernels=[dict(name=n[:60], count=c, ms=t / 1000.0)
                     for n, c, t in sorted(rows, key=lambda r: -r[2])[:top]])


def inter_frame(frames, w: int, h: int, preset: int, qindex: int = 140):
    """One inter frame of the fast GOP path on the card: the middle frame
    of ``frames`` ((y, u, v) uint8 planes of w x h) coded from the first
    (LAST) and the last (ALTREF) at ``preset`` and ``qindex``.  Returns
    (dispatch, collect): dispatch() issues P1 + P2 and returns the pending
    frame, collect(pending) pulls its decisions to the host."""
    import numpy as np
    import torch
    from svt_av1_tpu_torch.pipeline import cdef_stage, gop_fast
    from svt_av1_tpu_torch.pipeline.presets import features_for
    feat = features_for(preset)
    plane = lambda f: {k: torch.from_numpy(a).cuda()
                       for k, a in zip("yuv", f)}
    y, u, v = frames[len(frames) // 2]
    src = np.concatenate([y, np.concatenate([u, v], 1)], 0)
    refs = {1: plane(frames[0]), 7: plane(frames[-1])}
    kw = dict(modes=feat.intra_modes, ring=feat.subpel_ring,
              rad2=feat.hme_rad2, rad0=feat.hme_rad0,
              cdef_cands=cdef_stage.SEARCH_SET[:feat.cdef_candidates],
              exact_rates=feat.exact_rates, skip_mode=True,
              obmc=feat.obmc, interintra=feat.interintra,
              tx_search=feat.tx_search, split8=feat.part8)
    return (lambda: gop_fast.run_inter_frame(src, refs, qindex, h, w, **kw),
            gop_fast.collect_inter_frame)
