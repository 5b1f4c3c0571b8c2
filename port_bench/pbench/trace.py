"""The traced slice: one bounded stretch of the cell's traffic under
``torch.profiler``, reduced to the device's busy time, its kernels and its
idle gaps.

The reduction reads the profiler's raw events
(``prof.profiler.kineto_results.events()``) and never its parsed event
tree (``key_averages``), whose parse of a slice with hundreds of
thousands of launches may not end.

- Device operations: CUDA events that are not user annotations (kernels,
  copies and memsets).  ``busy_s`` is the length of the union of their
  intervals, not the sum of their durations.
- The slice: its span on the host's wall clock sets ``window_s``; the
  device's idle share is 1 - busy_s / window_s.
- Idle gaps: the stretches of the slice that no device operation covers,
  each labelled by the innermost range the host was in at the gap's
  middle: the harness's ``bench.*`` ranges around each API call, and the
  program's own named ranges where the slice has them.
"""
from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Tuple

K1_KERNEL = "fused_txq16_kernel"


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def _innermost(spans: List[Tuple[int, int, str]]
               ) -> Tuple[List[int], List[str]]:
    """Flatten nested host ranges into (starts, labels): from each start
    on, the innermost range open there ("" where none is)."""
    marks = []
    for s, e, n in spans:
        marks.append((s, 1, e, n))
        marks.append((e, 0, e, n))
    marks.sort(key=lambda m: (m[0], m[1], -m[2]))
    stack: List[Tuple[int, str]] = []
    starts, labels = [], []
    for t, opening, end, name in marks:
        if opening:
            stack.append((end, name))
        else:
            for i in range(len(stack) - 1, -1, -1):
                if stack[i] == (end, name):
                    del stack[i]
                    break
        starts.append(t)
        labels.append(stack[-1][1] if stack else "")
    return starts, labels


def reduce_events(events, slice_span: Tuple[int, int],
                  host_spans: List[Tuple[int, int, str]] = (),
                  span_prefixes=("p1.", "p2")) -> dict:
    """Reduce raw profiler events to the slice's readings.  ``slice_span``
    and ``host_spans`` are (start_ns, end_ns[, name]) on the wall clock of
    the profiler's events (``time.time_ns``); the program's own ranges
    named with ``span_prefixes`` come from the events.  Returns dict
    window_s, busy_s, kernels {name: [count, device_s]} (copies and
    memsets under their own names), launches (kernels without copies and
    memsets), gaps [(label, seconds)], or None when the events hold no
    device operation inside the slice."""
    from torch.autograd import DeviceType
    spans = list(host_spans)
    dev: List[Tuple[int, int]] = []
    kernels: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    for ev in events:
        name = ev.name()
        if ev.device_type() == DeviceType.CPU:
            if ev.is_user_annotation() and name.startswith(span_prefixes):
                spans.append((ev.start_ns(), ev.end_ns(), name))
        elif ev.device_type() == DeviceType.CUDA and \
                not ev.is_user_annotation():
            s, e = ev.start_ns(), ev.end_ns()
            dev.append((s, e))
            k = kernels[name]
            k[0] += 1
            k[1] += (e - s) * 1e-9
    lo, hi = slice_span
    dev.sort()
    merged: List[List[int]] = []
    for s, e in dev:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    if not merged:
        return None
    busy = sum(e - s for s, e in merged)
    starts, labels = _innermost(spans)
    gaps: Dict[str, float] = defaultdict(float)
    prev = lo
    for s, e in merged + [[hi, hi]]:
        if s > prev:
            mid = (prev + s) // 2
            i = bisect.bisect_right(starts, mid) - 1
            label = (labels[i] if i >= 0 else "") or "host outside API calls"
            gaps[label] += (s - prev) * 1e-9
        prev = max(prev, e)
    return dict(
        window_s=(hi - lo) * 1e-9, busy_s=busy * 1e-9,
        kernels={k: list(v) for k, v in kernels.items()},
        launches=sum(v[0] for k, v in kernels.items() if not _is_copy(k)),
        gaps=sorted(gaps.items(), key=lambda kv: -kv[1]))


class Profiled:
    """Profile the code inside ``with run(spans)``: CPU and CUDA
    activities, the device synchronised before the slice ends; the slice
    is timed on the host's wall clock.  ``readings`` holds reduce_events'
    result afterwards (with the harness's ``spans`` as labels), and
    ``parse_s`` the seconds the reduction took.  The CPU activity costs
    host time (a 1080p chunk took 18.2 s profiled against 16.7 s with the
    CUDA activity alone and 10.6 s without the profiler), but it is what
    records the program's named ranges that label the gaps."""

    def __init__(self, device):
        self.device = device
        self.readings = None
        self.parse_s = None

    @contextlib.contextmanager
    def run(self, spans: list):
        import torch
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            lo = time.time_ns()
            yield
            torch.cuda.synchronize(self.device)
            hi = time.time_ns()
        t = time.perf_counter()
        self.readings = reduce_events(prof.profiler.kineto_results.events(),
                                      (lo, hi), spans)
        self.parse_s = time.perf_counter() - t


def top(items, n=10):
    """The ``n`` largest (name, seconds) pairs, names cut to 120 chars."""
    return [[k[:120], v] for k, v in sorted(items, key=lambda kv: -kv[1])[:n]]
