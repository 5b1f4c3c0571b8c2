"""The window's arithmetic: where it closes, and fps, bpp and Y-PSNR over
the packets inside it.

Packets come out in bursts: every packet that one API call leaves behind
carries that call's return time.  The window opens at ``t0`` and closes
at the first burst returned at or after ``t0 + seconds``; that burst is in
the window, whole, and its return time is the window's end.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Emit:
    """One packet as the harness received it."""
    t: float               # return time of the call that produced it
    seg: int               # the encoder (64-frame segment) it came from
    pts: int               # the frame's index in its segment
    nbytes: int
    displayed: bool
    key: bool
    packet: object = None  # the program's Packet (data, recon)


def close(emits: List[Emit], t0: float, seconds: float
          ) -> Optional[Tuple[int, float]]:
    """(number of emits inside the window, the window's end) for emits in
    the order received, or None when no burst came at or after the
    deadline."""
    deadline = t0 + seconds
    for i, e in enumerate(emits):
        if e.t >= deadline:
            n = i
            while n < len(emits) and emits[n].t == e.t:
                n += 1
            return n, e.t
    return None


def sse_y(recon_y: np.ndarray, src_y: np.ndarray) -> float:
    d = recon_y.astype(np.int64) - src_y.astype(np.int64)
    return float(np.einsum("ij,ij->", d, d))


def metrics(emits: List[Emit], t0: float, t_end: float, width: int,
            height: int, source_y: Callable[[int, int], np.ndarray]) -> dict:
    """fps, bpp and psnr_y_db over the window's emits.

    fps: displayed frames over the window's length.  bpp: 8 x the bytes of
    every packet (hidden frames included) over the luma pixels of the
    displayed frames.  psnr_y_db: 10 log10(255^2 / MSE), the MSE pooled over
    every displayed frame's recon against its source."""
    shown = [e for e in emits if e.displayed]
    n = len(shown)
    nbytes = sum(e.nbytes for e in emits)
    px = n * width * height
    sse = sum(sse_y(e.packet.recon["y"], source_y(e.seg, e.pts))
              for e in shown)
    mse = sse / px if px else float("nan")
    return dict(
        frames=n, bytes=nbytes, seconds=t_end - t0,
        fps=n / (t_end - t0),
        bpp=8.0 * nbytes / px if px else float("nan"),
        psnr_y_db=(10.0 * math.log10(255.0 ** 2 / mse) if mse > 0
                   else float("inf")))
