"""Preset feature matrix: enc_mode (M0..M13) -> tool levels.

The reference's enc_mode_config.c (8.8k LoC) maps presets to feature
levels for every tool; this is our analog controlling mode-decision
width and in-loop search effort.  Speed presets shrink the intra
candidate set, the CDEF/LR search spaces, and the motion search,
trading quality for throughput.

Round-4 calibration: exact_rates measured -9% mean BD-rate (tools/
bdrate.py A/B, BDRATE.md); hp_mv and rdoq measured BD-negative on the
bdrate suite and stay dark.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Tuple

from svt_av1_tpu_torch.codec import constants as cc

_ALL_MODES = (cc.DC_PRED, cc.V_PRED, cc.H_PRED, cc.SMOOTH_PRED,
              cc.PAETH_PRED, cc.D135_PRED, cc.D113_PRED, cc.D157_PRED,
              cc.D45_PRED, cc.D67_PRED, cc.D203_PRED)


@dataclasses.dataclass(frozen=True)
class PresetFeatures:
    intra_modes: Tuple[int, ...]
    hme_rad2: int          # coarse HME radius (1/4 res)
    hme_rad0: int          # full-res refinement radius
    subpel_ring: bool      # quarter-pel ring in inter pass A
    cdef_candidates: int   # prefix of cdef_stage.SEARCH_SET
    lr_eps: Tuple[int, ...]
    kf_boost_div: int      # key-frame qindex boost = qindex // div
    varpart: bool = False  # 32/16 square partition MD (intra frames)
    rdoq: bool = False     # RD-optimized quantization (ops/rdoq.py;
                           # measured BD-negative here, see its doc)
    tx_search: bool = False  # luma tx-type search (DTT4+IDTX set)
    angle_deltas: bool = False  # directional-mode angle refinement
    cfl: bool = False        # chroma-from-luma candidate
    dlf_search: bool = False  # per-plane DLF level search (vs heuristic)
    cdef_sb: bool = False     # per-SB CDEF strengths (cdef_bits > 0)
    filter_intra: bool = False  # recursive filter-intra candidates
    adapted_rates: bool = False  # per-frame MD rate tables from the
                                 # primary-ref adapted CDFs
    exact_rates: bool = False  # context-exact device coefficient rate
                               # model (ops/coef_rate) in MD costs
    exact_rates_intra: bool = True  # apply exact_rates on intra/key
                                    # MD too (A/B split: the exact
                                    # model wins on skip-vs-code inter
                                    # decisions; intra mode ranking may
                                    # prefer the biased curves)
    hp_mv: bool = False      # 1/8-pel MVs + subpel refinement ring
                             # (allow_high_precision_mv; measured
                             # BD-negative on the bdrate suite)
    obmc: bool = False       # OBMC_CAUSAL motion mode (overlapped MC)
    interintra: bool = False  # inter-intra compound (smooth blend)
    part8: bool = False      # 8x8 partition-split alternative in the
                             # inter pass-A MD (per-sub MV, TX_8X8)
    tmvp: bool = False       # temporal MV prediction (spec 7.9
                             # projected motion field in the MV stacks)
    palette: bool = False    # screen-content palette MD on key frames
                             # (+ sequence SELECT screen content tools)
    mref: bool = False       # third (GOLDEN-role) reference in the
                             # inter pass-A merge: mids also search the
                             # mini-GoP anchor, bases the previous
                             # anchor (RPS role, Table 5 of
                             # svt-av1-encoder-design.md:528-545)


# Per-preset operating points (enc_mode_config.c role): a lookup key is
# the smallest ladder entry >= enc_mode.  Columns most sensitive to
# speed: intra candidate count, HME radii, CDEF/LR search width;
# quality tools turn off top-down.
_QUALITY_EXTRAS = dict(varpart=True, tx_search=True, angle_deltas=True,
                       cfl=True, dlf_search=True, cdef_sb=True,
                       filter_intra=True, obmc=True, interintra=True,
                       exact_rates=True, part8=True, tmvp=True,
                       palette=True, mref=True)
_LADDER = {
    # m: (n_modes, rad2, rad0, ring, cdef_n, lr_step, extras)
    0:  (11, 10, 7, True, 8, 1, _QUALITY_EXTRAS),
    2:  (11, 8, 7, True, 8, 1, _QUALITY_EXTRAS),
    4:  (10, 8, 6, True, 8, 2, _QUALITY_EXTRAS),
    6:  (8, 8, 5, True, 6, 2, dict(tx_search=True, angle_deltas=True,
                                   cfl=True, dlf_search=True,
                                   obmc=True, interintra=True,
                                   exact_rates=True, part8=True,
                                   tmvp=True, palette=True)),
    8:  (8, 8, 5, True, 6, 2, dict(tx_search=True, angle_deltas=True,
                                   cfl=True, dlf_search=True,
                                   obmc=True, interintra=True,
                                   exact_rates=True, palette=True)),
    10: (6, 6, 4, True, 4, 4, dict(exact_rates=True)),
    11: (6, 6, 4, True, 4, 4, dict()),
    12: (4, 4, 3, False, 3, 8, dict()),
    13: (4, 4, 3, False, 2, 8, dict()),
}


def features_for(enc_mode: int) -> PresetFeatures:
    m = max(0, min(13, int(enc_mode)))
    key = min(k for k in _LADDER if k >= m)
    nmod, rad2, rad0, ring, cdef_n, lr_step, extras = _LADDER[key]
    f = PresetFeatures(_ALL_MODES[:nmod], rad2, rad0, ring, cdef_n,
                       tuple(range(0, 16, lr_step)),
                       3 if m <= 8 else 4, **extras)
    env = os.environ.get("SVT_TPU_FEAT")
    if env:
        # A/B hook (tools/bdrate.py): "adapted_rates=1,exact_rates=0"
        kw = {}
        for item in env.split(","):
            k, _, v = item.partition("=")
            cur = getattr(f, k.strip())   # raises on unknown field
            kw[k.strip()] = type(cur)(int(v))
        f = dataclasses.replace(f, **kw)
    return f
