"""Hierarchical prediction structure (random access).

TPU-first re-expression of the reference's picture-decision mini-GoP
assembly + RPS (pd_process.c:639-860, pred_structure.c): the host builds
an explicit decode-order schedule per mini-GoP — no reorder queues are
needed because the whole mini-GoP is scheduled at once when its source
frames are in the lookahead.

A mini-GoP of N displayed frames after a coded anchor produces events:

  code(end)          — the base-layer (ALTREF-role) frame, hidden
  recursively: code(mid, last=lo, bwd=hi), hidden unless it is the
  next frame to display; show_existing events display hidden frames
  in order.

Works for any N >= 1 (non-dyadic tails from scene cuts / EOS flush).
Temporal layer = recursion depth (0 = base), used for per-layer QP
offsets (the rc_process.c layered-q analog).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional


@dataclasses.dataclass
class CodeEvent:
    poc: int                 # display index
    last_poc: int            # forward anchor (coded)
    bwd_poc: Optional[int]   # backward anchor (coded), None for base
    shown: bool              # show_frame at code time
    layer: int               # temporal layer (0 = base)
    store: bool              # must occupy a DPB slot
    gld_poc: Optional[int] = None  # third (GOLDEN-role) forward ref:
    # a farther-past coded frame searched beside LAST/ALTREF (the
    # multi-ref RPS role, pic_manager_process.c:325-409 Table 5).
    # Mids: the mini-GoP anchor when it is not already LAST; the base
    # frame's is filled by the encoder with the previous anchor.


@dataclasses.dataclass
class ShowEvent:
    poc: int                 # display a previously coded hidden frame


def minigop_schedule(anchor_poc: int, n: int) -> List[object]:
    """Decode-order events for displayed frames anchor+1 .. anchor+n."""
    assert n >= 1
    end = anchor_poc + n
    events: List[object] = [
        CodeEvent(end, anchor_poc, None, shown=(n == 1), layer=0,
                  store=True)]

    def walk(lo: int, hi: int, layer: int):
        if hi - lo <= 1:
            return
        mid = (lo + hi) // 2
        shown = (mid - lo == 1)
        events.append(CodeEvent(mid, lo, hi, shown=shown, layer=layer,
                                store=not shown or (hi - mid > 1),
                                gld_poc=(anchor_poc
                                         if anchor_poc != lo else None)))
        walk(lo, mid, layer + 1)
        if not shown:
            events.append(ShowEvent(mid))
        walk(mid, hi, layer + 1)

    walk(anchor_poc, end, 1)
    if n > 1:
        events.append(ShowEvent(end))
    return events


def layer_qindex(base_q: int, layer: int, n_layers: int) -> int:
    """Layered quantizer offsets (rc_process.c hierarchical-q analog):
    base layer gets a boost (widely referenced), leaves pay extra."""
    if layer == 0:
        q = base_q - base_q // 4
    elif layer + 1 >= n_layers:
        q = base_q + base_q // 8
    else:
        q = base_q + (layer - 1) * max(1, base_q // 16)
    return max(1, min(255, q))


def max_live_slots(n: int) -> int:
    """Upper bound on simultaneously stored frames for a mini-GoP of n
    (anchor + base + one path of mids)."""
    depth = 0
    while (1 << depth) < n:
        depth += 1
    return depth + 2
