"""Device kernels of one call, from torch.profiler (CPU + CUDA activities).

Used by tools/profile_torch_encode.py and chip_smoke.py; needs a CUDA
device.  A kernel appears in ``key_averages()`` under its own name as a
CUDA row, and the CPU op that launched it carries the same time again, so
only the device-side rows are summed.
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
    for k in prof.key_averages():
        dev = getattr(k, "self_device_time_total",
                      getattr(k, "self_cuda_time_total", 0))
        if k.device_type == DeviceType.CUDA and dev > 0:
            rows.append((k.key, int(k.count), float(dev)))
    copies = sum(r[1] for r in rows if r[0].startswith(("Memcpy", "Memset")))
    return dict(
        wall_s=wall, launches=sum(r[1] for r in rows) - copies,
        copies=copies,
        device_ms=sum(r[2] for r in rows) / 1000.0 if rows
        else "not measured",
        top_kernels=[dict(name=n[:60], count=c, ms=t / 1000.0)
                     for n, c, t in sorted(rows, key=lambda r: -r[2])[:top]])
