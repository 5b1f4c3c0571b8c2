"""Inputs of the C-reference golden vectors in ``tests/golden/``.

The goldens hold the C reference's outputs for deterministic inputs; this
module regenerates those inputs (the same generators as
``tests/golden_defs.py``, on the port's constants) so that the port's
inverse transform and intra predictors can be held against the goldens
where the JAX package is not installed, as on the GPU machine.
"""
from __future__ import annotations

import os

import numpy as np

from svt_av1_tpu_torch.codec import constants as cc

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests", "golden")

INTRA_SIZES = [(4, 4), (8, 8), (16, 16), (32, 32), (64, 64),
               (8, 4), (4, 8), (16, 8), (8, 16), (32, 16), (16, 32)]


def legal_tx_types(tx_size):
    w, h = int(cc.tx_size_wide[tx_size]), int(cc.tx_size_high[tx_size])
    if max(w, h) > 32:
        return [cc.DCT_DCT]
    out = []
    for t in range(cc.TX_TYPES):
        vt, ht = cc.tx_type_1d[t]
        ok = True
        for kind, n in ((vt, h), (ht, w)):
            if kind in (cc.TX1D_ADST, cc.TX1D_FLIPADST) and n > 16:
                ok = False
        if ok:
            out.append(t)
    return out


def inv_txfm_input(tx_size: int, tx_type: int, bd: int = 8):
    """(coeffs (h,w) int32, pred (h,w) int32) — deterministic."""
    rng = np.random.default_rng(1000 * (tx_size + 1) + 7 * tx_type + bd)
    w, h = int(cc.tx_size_wide[tx_size]), int(cc.tx_size_high[tx_size])
    kw, kh = min(w, 32), min(h, 32)
    lim = 1 << (15 if bd == 8 else 17)
    coeffs = np.zeros((h, w), dtype=np.int32)
    coeffs[:kh, :kw] = rng.integers(-lim, lim, size=(kh, kw))
    pred = rng.integers(0, 1 << bd, size=(h, w)).astype(np.int32)
    return coeffs, pred


def inv_txfm_cases():
    for tx_size in range(cc.TX_SIZES_ALL):
        for tx_type in legal_tx_types(tx_size):
            yield tx_size, tx_type, 8
    for tx_type in (cc.DCT_DCT, cc.ADST_ADST, cc.IDTX):
        yield cc.TX_16X16, tx_type, 10


def intra_input(mode: int, w: int, h: int):
    """(above (w,), left (h,), corner scalar) uint8 — deterministic."""
    rng = np.random.default_rng(500 + mode * 31 + w * 3 + h)
    full = rng.integers(0, 256, size=w + 1).astype(np.uint8)
    left = rng.integers(0, 256, size=h).astype(np.uint8)
    return full[1:].copy(), left, int(full[0])
