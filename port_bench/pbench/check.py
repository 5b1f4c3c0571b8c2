"""What decides ``correct``: every frame sent came back, a seeded sample of
the window's packets decodes, with the benchmark's frozen copy of the
port's decoder (``av1ref``), to exactly the reconstruction that the packet
carries, and the window's reconstructions lie near their sources.

``av1ref`` rebuilds each frame with the same reconstruction code as the
encoder it was copied from (prediction, inverse transforms, the in-loop
filters), so ``mismatch_px`` holds the stream and the reconstruction to
each other and to this copy, not to the AV1 specification: a fault that
the encoder's reconstruction and this copy share reads 0 there.

Numbers compared, each against the cell's limit (``cells/<cell>.json``):

- ``missing_frames``: frames sent in the window whose displayed packet
  never came (after the encoder was flushed past the close), plus
  displayed packets that came twice, for a frame never sent, or without
  a reconstruction.  Exact: limit 0.
- ``decode_errors``: sampled packets that the reference could not decode,
  or that decoded to another number of shown frames than the packet says.
  Exact: limit 0.
- ``mismatch_px``: samples (Y, U and V) where the reference's decode of a
  sampled frame differs from the packet's reconstruction.  Exact: limit 0.
  This holds the bitstream (OBU syntax, the range coder) and the
  reconstruction (prediction, transforms, quantizer, K1, the in-loop
  filters) to each other.
- ``mean_shift_y``: the luma reconstructions' mean minus their sources'
  mean, pooled over the window's displayed key frames, as a size.  An
  encode of the source carried at a lower bit depth (its low bits
  cleared) decodes to its own reconstruction and lands near the right
  MSE, but shifts the picture's level by about half of what it cleared.
  Inter frames are left out: their skipped blocks keep the upward
  rounding of compound and sub-pel prediction, which grows with the
  frame's depth in the pyramid (0.1-0.4 of a level at qp 35), while a key
  frame codes its level directly.
- ``mse_y_worst``: the largest luma mean squared error against its
  source of any displayed frame of the window, read from the packet's
  reconstruction, and of any frame the reference decoded: a right stream
  of the wrong picture fails here, where the others hold.

A sampled packet is decoded from the last key frame before it, in the
order the packets came, so that every frame it predicts from is decoded
too; every displayed frame decoded on the way is compared as well.
"""
from __future__ import annotations

import random
from collections import Counter
from typing import Callable, Dict, List, Tuple

import numpy as np

from pbench.window import Emit

NUMBERS = ("missing_frames", "decode_errors", "mismatch_px", "mean_shift_y",
           "mse_y_worst")


def missing_frames(sent: Dict[int, List[int]], emits: List[Emit]) -> int:
    """Frames of ``sent`` ({segment: pts sent}) with no displayed packet,
    plus displayed packets that are duplicates, unexpected, or carry no
    reconstruction."""
    got = Counter((e.seg, e.pts) for e in emits if e.displayed)
    want = {(s, p) for s, ps in sent.items() for p in ps}
    bad = sum(1 for k in want if k not in got)
    bad += sum(c - 1 for c in got.values() if c > 1)
    bad += sum(c for k, c in got.items() if k not in want)
    bad += sum(1 for e in emits if e.displayed
               and getattr(e.packet, "recon", None) is None)
    return bad


def sample(emits: List[Emit], n: int, seed: int) -> List[int]:
    """Indices of ``n`` displayed emits drawn from the seed (all of them
    when ``n`` is 0 or larger than their number)."""
    shown = [i for i, e in enumerate(emits) if e.displayed]
    if n <= 0 or n >= len(shown):
        return shown
    return sorted(random.Random(seed).sample(shown, n))


def _decode_runs(emits: List[Emit], picks: List[int]
                 ) -> List[Tuple[int, int]]:
    """Per segment, the (first, last) emit indices to decode, in order:
    from the last key frame at or before each pick through the pick,
    merged where runs overlap."""
    runs: List[Tuple[int, int]] = []
    for i in picks:
        seg = emits[i].seg
        mine = [k for k in range(i + 1) if emits[k].seg == seg]
        keys = [k for k in mine if emits[k].key]
        j = keys[-1] if keys else mine[0]
        if runs and emits[runs[-1][0]].seg == seg and runs[-1][1] >= j:
            runs[-1] = (runs[-1][0], max(runs[-1][1], i))
        else:
            runs.append((j, i))
    return runs


def compare(emits: List[Emit], first: Dict[int, bytes], picks: List[int],
            source_y: Callable[[int, int], np.ndarray], device=None
            ) -> dict:
    """Decode the runs that reach the picked emits with the reference
    decoder and compare every displayed frame on the way.  ``first`` maps
    a segment to its first packet's data (which holds the sequence
    header).  Returns decode_errors, mismatch_px, mse_y_worst and the
    number of frames compared."""
    from av1ref.codec import obu
    from av1ref.codec.decoder import Decoder
    errors, mismatch, worst, compared = 0, 0, 0.0, 0
    for lo, hi in _decode_runs(emits, picks):
        dec = Decoder(device=device)
        seg = emits[lo].seg
        for t, payload in obu.parse_obus(first[seg]):
            if t == obu.OBU_SEQUENCE_HEADER:
                dec.sp = obu.read_sequence_header(payload)
        for e in emits[lo:hi + 1]:
            try:
                out = dec.decode_temporal_unit(e.packet.data)
            except Exception as exc:  # a stream the reference cannot read
                errors += 1
                print(f"check: segment {seg} pts {e.pts}: the reference "
                      f"decoder raised {type(exc).__name__}: {exc}")
                break
            if len(out) != int(e.displayed):
                errors += 1
                break
            if not e.displayed:
                continue
            recon = e.packet.recon
            if recon is None:
                continue   # counted by missing_frames
            compared += 1
            src = source_y(e.seg, e.pts)
            h, w = src.shape
            # the decoder puts out the coded size: crop to the render size
            crop = dict(y=(h, w), u=((h + 1) // 2, (w + 1) // 2),
                        v=((h + 1) // 2, (w + 1) // 2))
            for k, (ph, pw) in crop.items():
                a, b = out[0][k][:ph, :pw], recon[k]
                if a.shape != b.shape:
                    mismatch += int(b.size)
                else:
                    mismatch += int(np.count_nonzero(a != b))
            d = (out[0]["y"][:h, :w].astype(np.int64) - src.astype(np.int64))
            worst = max(worst, float(np.einsum("ij,ij->", d, d)) / d.size)
    return dict(decode_errors=errors, mismatch_px=mismatch,
                mse_y_worst=worst, frames_compared=compared)


def recon_mse_worst(emits: List[Emit],
                    source_y: Callable[[int, int], np.ndarray]) -> float:
    """The largest luma MSE of a displayed emit's reconstruction against
    its source."""
    worst = 0.0
    for e in emits:
        recon = getattr(e.packet, "recon", None) if e.displayed else None
        if recon is not None:
            d = recon["y"].astype(np.int64) - source_y(e.seg, e.pts)
            worst = max(worst, float(np.einsum("ij,ij->", d, d)) / d.size)
    return worst


def mean_shift(emits: List[Emit],
               source_y: Callable[[int, int], np.ndarray]) -> float:
    """|sum of (reconstruction - source) luma samples| over the samples of
    every displayed key-frame emit that carries a reconstruction (0
    without one)."""
    total, n = 0, 0
    for e in emits:
        recon = (getattr(e.packet, "recon", None)
                 if e.displayed and e.key else None)
        if recon is not None:
            total += int(recon["y"].sum(dtype=np.int64)) - int(
                source_y(e.seg, e.pts).sum(dtype=np.int64))
            n += recon["y"].size
    return abs(total) / n if n else 0.0


def judge(numbers: dict, limits: dict) -> Tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): each number at or under its
    limit."""
    table = {k: {"value": numbers[k], "limit": limits[k]} for k in NUMBERS}
    ok = all(v["value"] <= v["limit"] for v in table.values())
    return ok, table
