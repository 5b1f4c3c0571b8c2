"""Per-stage host timers + leveled logging — the observability analog of
the reference's SVT_LOG (svt_log.c) and SRM occupancy reports.

Usage:
    with stage("device_md"):
        ...
    print(stage_report())

Env:
    SVT_LOG       log level (0 fatal .. 4 debug; default 2=info)
    SVT_TPU_TRACE if set, Encoder prints a stage report at EOS
"""
from __future__ import annotations

import contextlib
import os
import sys
import time
from collections import defaultdict
from typing import Dict

_totals: Dict[str, float] = defaultdict(float)
_counts: Dict[str, int] = defaultdict(int)


@contextlib.contextmanager
def stage(name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        _totals[name] += dt
        _counts[name] += 1


def stage_stats() -> Dict[str, tuple]:
    """{stage: (total_seconds, calls)}"""
    return {k: (_totals[k], _counts[k]) for k in _totals}


def reset_stages() -> None:
    _totals.clear()
    _counts.clear()


def stage_report() -> str:
    if not _totals:
        return "(no stages recorded)"
    width = max(len(k) for k in _totals)
    lines = ["stage timings:"]
    total = sum(_totals.values())
    for k in sorted(_totals, key=lambda k: -_totals[k]):
        t, n = _totals[k], _counts[k]
        lines.append(f"  {k:<{width}}  {t:8.3f}s  x{n:<5d} "
                     f"{100 * t / max(total, 1e-9):5.1f}%")
    return "\n".join(lines)


def trace_enabled() -> bool:
    return bool(os.environ.get("SVT_TPU_TRACE"))


# -- leveled logger (svt_log.c analog) ---------------------------------------

FATAL, ERROR, WARN, INFO, DEBUG = range(5)
_NAMES = ["FATAL", "ERROR", "WARN", "INFO", "DEBUG"]


def _level() -> int:
    try:
        return int(os.environ.get("SVT_LOG", "2"))
    except ValueError:
        return 2


def svt_log(level: int, msg: str) -> None:
    if level <= _level():
        out = os.environ.get("SVT_LOG_FILE")
        line = f"Svt[{_NAMES[min(level, 4)]}]: {msg}\n"
        if out:
            with open(out, "a") as f:
                f.write(line)
        else:
            sys.stderr.write(line)
