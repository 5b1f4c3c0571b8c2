"""Drive one cell of the benchmark: set-up, the window, the traced slice,
the check, and the result line.

The traffic file names the entry and its calls:

- ``entry``: ``send_pictures`` (all-intra batches of ``frames_per_call``
  frames, each call returning its packets) or ``send_picture`` (one frame
  a call, the segment ended by ``flush``);
- ``segment_frames``: a new ``Encoder`` every this many frames, an
  independent segment;
- ``pool_frames``: the seeded clip's length; segment ``s``'s frame ``j``
  is clip frame ``(s * segment_frames + j) % pool_frames``;
- ``content``: the clip's pattern (``clip.make_frames``);
- ``check_frames``: the number of displayed packets the check samples
  (0: all of the window's).

The loop is closed: the next call goes out when the last one returns.
Set-up warms up on a throwaway encoder by driving the same traffic until
its first burst of packets is out: that compiles nothing (the port runs
eagerly), but it builds the CUDA kernel library and the C range coder in
the checkout's ``build/`` on a first run, loads every kernel the cell
uses, and grows the allocator's pool to the cell's size.
"""
from __future__ import annotations

import gc
import os
import time
from typing import Dict, List, Optional

from pbench import check, clip, window
from pbench.trace import Profiled, top
from pbench.window import Emit

T_START = time.perf_counter()


def _schedule(traffic: dict):
    """The calls of one segment: (kind, frame indices in the segment)."""
    n = int(traffic["segment_frames"])
    if traffic["entry"] == "send_pictures":
        f = int(traffic["frames_per_call"])
        for j in range(0, n, f):
            yield "send_pictures", list(range(j, min(n, j + f)))
    elif traffic["entry"] == "send_picture":
        for j in range(n):
            yield "send_picture", [j]
        yield "flush", []
    else:
        raise ValueError(f"unknown entry {traffic['entry']!r}")


class Runner:
    """One cell's encoder, clip and calls."""

    def __init__(self, cell, seed: int, device, fault: Optional[str] = None):
        from svt_av1_tpu_torch.api.config import EncoderConfig
        from svt_av1_tpu_torch.codec import obu
        self.cell, self.seed, self.device = cell, seed, device
        self.fault = fault
        self.key_type = obu.KEY_FRAME
        self.cfg = EncoderConfig(**cell.config["encoder"])
        self.width = self.cfg.source_width
        self.height = self.cfg.source_height
        t = cell.traffic
        self.seg_frames = int(t["segment_frames"])
        self.pool = int(t["pool_frames"])
        self.frames = clip.make_frames(self.pool, self.width, self.height,
                                       t["content"], seed, device)

    def frame(self, seg: int, j: int):
        return self.frames[(seg * self.seg_frames + j) % self.pool]

    def source_y(self, seg: int, j: int):
        return self.frame(seg, j)[0]

    def encoder(self):
        from svt_av1_tpu_torch.api.encoder import Encoder
        enc = Encoder(self.cfg, device=self.device)
        if self.fault is not None:
            from pbench.alter import Altered
            enc = Altered(enc, self.fault)
        return enc

    def call(self, enc, kind: str, seg: int, idx: List[int]):
        """Make one API call and take every packet it left; returns them.
        With ``self.spans`` a list, each call's host span is appended to
        it as (start_ns, end_ns, name) on the wall clock the profiler's
        events use."""
        spans = self.spans
        t = time.time_ns()
        if kind == "send_pictures":
            enc.send_pictures([self.frame(seg, j) for j in idx])
        elif kind == "send_picture":
            enc.send_picture(*self.frame(seg, idx[0]))
        else:
            enc.flush()
        t1 = time.time_ns()
        out = []
        while (p := enc.get_packet()) is not None:
            out.append(p)
        if spans is not None:
            spans.append((t, t1, "bench." + kind))
            spans.append((t1, time.time_ns(), "bench.get_packet"))
        return out

    spans = None

    def _emits(self, pkts, t: float, seg: int) -> List[Emit]:
        return [Emit(t, seg, int(p.pts), len(p.data), bool(p.displayed),
                     p.frame_type == self.key_type, p) for p in pkts]

    def warm_up(self):
        """Drive a throwaway encoder until its first burst is out."""
        enc = self.encoder()
        for kind, idx in _schedule(self.cell.traffic):
            if self.call(enc, kind, 0, idx):
                break
        self.sync()

    def sync(self):
        if self.device.type == "cuda":
            import torch
            torch.cuda.synchronize(self.device)

    def drive(self, seconds: float):
        """The window.  Returns dict(t0, emits, n_in, t_end, sent, first,
        stages) where emits holds the window's packets then those that a
        flush after the close brought, n_in counts the window's, sent maps
        each segment to the frames sent in the window, first each segment
        to its first packet's data, and stages the program's stage seconds
        over the window."""
        from svt_av1_tpu_torch.utils import profiling
        emits: List[Emit] = []
        sent: Dict[int, List[int]] = {}
        first: Dict[int, bytes] = {}
        profiling.reset_stages()
        cpu0 = os.times()
        bursts = []
        t0 = time.perf_counter()
        t_prev = t0
        seg, enc, closed = 0, None, None
        while closed is None:
            enc = self.encoder()
            sent[seg] = []
            for kind, idx in _schedule(self.cell.traffic):
                pkts = self.call(enc, kind, seg, idx)
                t = time.perf_counter()
                sent[seg] += idx
                emits += self._emits(pkts, t, seg)
                if not pkts:
                    continue
                first.setdefault(seg, pkts[0].data)
                bursts.append(t - t_prev)
                t_prev = t
                closed = window.close(emits, t0, seconds)
                if closed is not None:
                    break
            else:
                enc = None
                seg += 1
        cpu1 = os.times()
        stages = {k: v[0] for k, v in profiling.stage_stats().items()}
        if enc is not None:
            # frames sent in the window but still held by the encoder: the
            # check waits for their packets (not timed)
            emits += self._emits(self.call(enc, "flush", seg, []),
                                 time.perf_counter(), seg)
        host_s = (cpu1.user - cpu0.user) + (cpu1.system - cpu0.system)
        return dict(t0=t0, emits=emits, n_in=closed[0], t_end=closed[1],
                    sent=sent, first=first, stages=stages, bursts=bursts,
                    host_cpu_s=host_s)

    def traced_slice(self, profiled: Profiled) -> dict:
        """The traced slice: a fresh segment's first burst (its encoder's
        construction included) under the profiler.  Returns its coded and
        inter frames and K1's launches and batches in it."""
        from svt_av1_tpu_torch.ops import fused_txq
        fused_txq.batches.clear()
        before = fused_txq.launches
        self.spans = []
        pkts = []
        with profiled.run(self.spans):
            enc = self.encoder()
            for kind, idx in _schedule(self.cell.traffic):
                pkts = self.call(enc, kind, 0, idx)
                if pkts:
                    break
        self.spans = None
        coded = {int(p.pts) for p in pkts}
        keys = {int(p.pts) for p in pkts if p.frame_type == self.key_type}
        return dict(frames=len(coded), inter_frames=len(coded - keys),
                    k1_launches=fused_txq.launches - before,
                    k1_batches=sorted(fused_txq.batches))


def readings(run: dict, n_in: int, sl: dict, profiled: Profiled) -> dict:
    """What the per-layer readers read: the window's coded frames and the
    program's stage seconds over it (host time, read without the
    profiler), and the traced slice's frames, K1 counters and device
    trace."""
    win = run["emits"][:n_in]
    coded = {(e.seg, e.pts) for e in win}
    keys = {(e.seg, e.pts) for e in win if e.key}
    return dict(frames=len(coded), inter_frames=len(coded - keys),
                stages=run["stages"], slice_frames=sl["frames"],
                slice_inter_frames=sl["inter_frames"],
                k1_launches=sl["k1_launches"], k1_batches=sl["k1_batches"],
                trace=profiled.readings)


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             fault: Optional[str] = None, warm: bool = True,
             t_start: float = T_START) -> dict:
    """One run of ``cell``; set-up counts from ``t_start``.  Returns
    dict(result=the result line's object, lines=earlier lines to print,
    check_lines=the check's lines, numbers=the compared numbers,
    window=the window's arithmetic)."""
    import torch
    lines = []
    runner = Runner(cell, seed, device, fault)
    if warm:
        runner.warm_up()
    gc.collect()
    setup_s = time.perf_counter() - t_start
    run = runner.drive(seconds)
    runner.sync()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    emits, n_in = run["emits"], run["n_in"]
    win = window.metrics(emits[:n_in], run["t0"], run["t_end"],
                         runner.width, runner.height, runner.source_y)
    lines.append(f"window: {win['frames']} frames in "
                 f"{win['seconds']:.6f} s, overrun "
                 f"{win['seconds'] - seconds:.6f} s past --seconds "
                 f"{seconds}; {len(emits) - n_in} packets after the close")
    lines.append(f"bursts: seconds between packet bursts "
                 f"{[round(b, 3) for b in run['bursts']]}; this process's "
                 f"CPU seconds in the window {run['host_cpu_s']:.3f}")
    lines.append(f"memory: peak {peak} bytes allocated on {device}")
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    dev = dict(platform="gpu" if device.type == "cuda" else device.type,
               kind=(torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
               count=cell.chips, memory_peak_bytes=int(peak))
    if trace:
        profiled = Profiled(device)
        r = readings(run, n_in, runner.traced_slice(profiled), profiled)
        tr = profiled.readings
        lines.append(f"trace: slice of {r['slice_frames']} frames, "
                     f"{tr['window_s'] if tr else 'nan'} s, parsed in "
                     f"{profiled.parse_s:.3f} s; stages over the window's "
                     f"{r['frames']} frames "
                     f"{ {k: round(v, 6) for k, v in r['stages'].items()} }")
        metrics = {}
        for name, read in cell.readers.items():
            v = read(r)
            if v is not None:
                metrics[name] = dict(value=v, unit=units[name])
        breakdown = None
        if tr is not None:
            dev["busy_s"] = tr["busy_s"]
            dev["window_s"] = tr["window_s"]
            breakdown = dict(
                device_ops=top((k, v[1]) for k, v in tr["kernels"].items()),
                idle_gaps=top(tr["gaps"]))
    else:
        values = dict(fps=win["fps"], bpp=win["bpp"],
                      psnr_y_db=win["psnr_y_db"], setup_s=setup_s)
        metrics = {m["name"]: dict(value=values[m["name"]], unit=m["unit"])
                   for m in cell.end_to_end}
    # the program's state (its encoders) is gone before the reference runs
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    picks = check.sample(emits[:n_in], int(cell.traffic["check_frames"]),
                         seed)
    numbers = check.compare(emits, run["first"], picks, runner.source_y,
                            device=device)
    numbers["missing_frames"] = check.missing_frames(run["sent"], emits)
    numbers["mse_y_worst"] = max(numbers["mse_y_worst"],
                                 check.recon_mse_worst(emits[:n_in],
                                                       runner.source_y))
    numbers["mean_shift_y"] = check.mean_shift(emits[:n_in], runner.source_y)
    limits = cell.limits["limits"]
    ok, table = check.judge(numbers, limits)
    attempted = sum(len(v) for v in run["sent"].values())
    lines.append(f"check: {numbers['frames_compared']} frames decoded by "
                 f"the reference and compared in "
                 f"{time.perf_counter() - t:.3f} s; {attempted} frames sent")
    failed = (numbers["missing_frames"] + numbers["decode_errors"]
              + sum(numbers[k] > limits[k] for k in
                    ("mismatch_px", "mean_shift_y", "mse_y_worst")))
    result = dict(correct=bool(ok), attempted=attempted, failed=int(failed),
                  metrics=metrics, device=dev)
    if trace and breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = table
    check_lines = [f"check {k}: {v['value']} (limit {v['limit']})"
                   for k, v in table.items()]
    return dict(result=result, lines=lines, check_lines=check_lines,
                numbers=numbers, window=win)
