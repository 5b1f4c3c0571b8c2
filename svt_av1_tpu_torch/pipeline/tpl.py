"""TPL — the temporal dependency model, the PyTorch port of
svt_av1_tpu/pipeline/tpl.py (the reference's TPL machine,
src_ops_process.c: the dispenser, the synthesizer and
svt_aom_generate_r0beta).

  * dispenser (``tpl_costs_core``, on the device): every 16x16 block of a
    lookahead frame gets an open-loop DC-intra SATD cost and an inter SATD
    cost at its HME motion vector; pipeline/gop_fast.tpl_group_stats runs
    it over a whole lookahead group.
  * synthesizer (``synthesize``, numpy, float64): the propagated
    distortion, pushed back over the group's dependency graph in reverse
    decode order onto the (up to 4) reference blocks each block's motion
    overlaps, weighted by overlap area.

Outputs per frame: r0 = intra / (intra + propagated), which sets a
frame's qindex (rate_control.crf_qindex_calc), and a per-64x64 qindex
map from the per-SB beta, which codes key frames with delta-q.
``synthesize``, ``r0_of`` and ``beta_qmap`` are copies of the
reference's numpy functions.  ``tpl_frame_stats`` is the stage path's
dispenser, one frame at a time over pipeline/me.hierarchical_me (GOPs
off the fast path: 10 bits, film grain, tile columns).
"""
from __future__ import annotations

import functools
from typing import Dict, List

import numpy as np
import torch

from svt_av1_tpu_torch import device as device_mod
from svt_av1_tpu_torch.ops import mc, satd
from svt_av1_tpu_torch.pipeline import gop
from svt_av1_tpu_torch.pipeline import me as me_pipe

BLK = 16


def _satd16(diff: torch.Tensor) -> torch.Tensor:
    """(B, 16, 16) residuals -> (B,) int32 SATD via four 8x8 Hadamards
    (the reference's tpl satd path tiles 8x8 the same way)."""
    b = diff.shape[0]
    tiles = diff.reshape(b, 2, 8, 2, 8).permute(0, 1, 3, 2, 4)
    tiles = tiles.reshape(b * 4, 8, 8)
    return satd.satd(tiles).reshape(b, 4).sum(dim=1, dtype=torch.int32)


@functools.lru_cache(maxsize=16)
def _grid_on(h: int, w: int, device):
    gw = w // BLK
    ar = torch.arange((h // BLK) * gw, device=device, dtype=torch.int32)
    return ar // gw * BLK, ar % gw * BLK


def tpl_costs_core(h: int, w: int):
    """The dispenser's cost step for (h, w) frames (h, w multiples of 16):
    run(src, refp=None, mvs=None, intra=True) -> (intra_cost, inter_cost),
    (nb,) int32 SATDs in raster block order for an (h, w) int32 source on
    a device, its reference padded by mc.PAD and (nb, 2) 1/8-pel MVs; a
    cost not asked for (no reference, or ``intra`` False) is None."""
    gh, gw = h // BLK, w // BLK
    nb = gh * gw

    def blocks_of(a):
        return a.reshape(gh, BLK, gw, BLK).permute(0, 2, 1, 3).reshape(
            nb, BLK, BLK)

    def run(src, refp=None, mvs=None, intra=True):
        blocks = blocks_of(src).to(torch.int32)
        intra_cost = inter_cost = None
        if intra:
            # open-loop DC prediction from source neighbours: the row
            # above / column left of each block, the frame's first row or
            # column repeated at its edge
            edge = lambda n: (torch.arange(n, device=src.device) * BLK
                              - 1).clamp(min=0)
            above = src[edge(gh)].reshape(nb, BLK)
            left = src[:, edge(gw)].reshape(gh, BLK, gw).permute(0, 2, 1)
            dc = ((above.sum(1) + left.reshape(nb, BLK).sum(1) + BLK)
                  // (2 * BLK))[:, None, None]
            intra_cost = _satd16(blocks - dc)
        if refp is not None:
            ys_t, xs_t = _grid_on(h, w, src.device)
            pred = mc.mc_blocks(refp, ys_t, xs_t, mvs, BLK, mc.PAD, 0, 8)
            inter_cost = _satd16(blocks - pred)
        return intra_cost, inter_cost

    return run


def tpl_frame_stats(src_y, refs, device=None) -> Dict[str, np.ndarray]:
    """The dispenser step for one frame on ``device`` (default: the
    current CUDA device): per 16x16 block the open-loop DC-intra SATD and,
    against each reference, the inter SATD at its HME MV (TPL's radii,
    clamped to the padded reference); per block the cheapest reference
    wins (first on equal cost).  src_y: (h, w) plane (numpy or tensor, 8
    or 10 bits); refs: a list of reference source planes, one plane, or
    None / empty for an intra-only anchor.  As in the reference, the
    inter prediction clips at 8 bits whatever the samples' depth.
    Returns the dict that ``synthesize`` takes, costs as float64."""
    dev = device_mod.resolve(device)
    if refs is not None and not isinstance(refs, (list, tuple)):
        refs = [refs]
    src = me_pipe.as_plane(src_y, dev)
    h, w = src.shape
    gh, gw = h // BLK, w // BLK
    nb = gh * gw
    run = tpl_costs_core(h, w)
    intra, _ = run(src)
    intra = intra.cpu().numpy().astype(np.float64)
    if not refs:
        return dict(intra=intra, inter=np.full(nb, np.inf),
                    mv=np.zeros((nb, 2), np.int32),
                    ref_sel=np.zeros(nb, np.int32), gh=gh, gw=gw)
    ys = (np.arange(nb) // gw * BLK).astype(np.int32)
    xs = (np.arange(nb) % gw * BLK).astype(np.int32)
    best_inter = best_mv = ref_sel = None
    for ri, ref_y in enumerate(refs):
        ref = me_pipe.as_plane(ref_y, dev)
        mv_y, mv_x, _ = me_pipe.hierarchical_me(src, ref, rad2=8, rad0=4,
                                                device=dev)
        mvs = np.stack([mv_y.reshape(nb) * 8, mv_x.reshape(nb) * 8],
                       axis=-1).astype(np.int32)
        mvs = mc.clamp_mvs_for_pad(mvs[:, None], ys[:, None], xs[:, None],
                                   BLK, h, w)[:, 0]
        _, ec = run(src, mc.pad_plane(ref, mc.PAD),
                    torch.as_tensor(mvs, device=dev), intra=False)
        ec = ec.cpu().numpy().astype(np.float64)
        if best_inter is None:
            best_inter, best_mv = ec, mvs
            ref_sel = np.zeros(nb, np.int32)
        else:
            take = ec < best_inter
            best_inter = np.where(take, ec, best_inter)
            best_mv = np.where(take[:, None], mvs, best_mv)
            ref_sel = np.where(take, ri, ref_sel)
    return dict(intra=intra, inter=best_inter, mv=best_mv, ref_sel=ref_sel,
                gh=gh, gw=gw)


def minigop_group(anchor: int, events, tail):
    """A mini-GoP's TPL group as the encoder builds it: the anchor, then
    the coded frames of ``events`` (gop.minigop_schedule) in decode order,
    each with its LAST (and ALTREF) reference, then the IPP ``tail`` pocs
    after the mini-GoP's last frame, each referencing the one before it.
    Decode order lets the synthesizer's reverse pass see every child
    before its reference.  Returns (pocs, deps: indices into pocs)."""
    order, deps, idx = [anchor], [None], {anchor: 0}
    for ev in events:
        if not isinstance(ev, gop.CodeEvent):
            continue
        idx[ev.poc] = len(order)
        order.append(ev.poc)
        deps.append([idx[ev.last_poc]]
                    + ([idx[ev.bwd_poc]] if ev.bwd_poc is not None else []))
    prev = max(order)
    for p in tail:
        deps.append([idx[prev]])
        idx[p] = len(order)
        order.append(p)
        prev = p
    return order, deps


def synthesize(stats: List[Dict], deps: List) -> List[np.ndarray]:
    """Backprop propagated distortion (synthesizer analog).

    stats[i]: dispenser output for lookahead frame i; deps[i]: list of
    the reference indices within ``stats`` matching the refs passed to
    tpl_frame_stats (None/[] for anchors).  Frames are processed in
    reverse list order — callers order the list so every frame precedes
    the frames that reference it.  Returns mc_dep[i]: (nb,) propagated
    distortion arriving at each block."""
    gh, gw = stats[0]["gh"], stats[0]["gw"]
    nb = gh * gw
    mc_dep = [np.zeros(nb) for _ in stats]
    bys = np.arange(nb) // gw * BLK
    bxs = np.arange(nb) % gw * BLK
    for i in range(len(stats) - 1, -1, -1):
        dep_i = deps[i]
        if dep_i is None:
            continue
        if not isinstance(dep_i, (list, tuple)):
            dep_i = [dep_i]
        if not dep_i:
            continue
        st = stats[i]
        intra = st["intra"]
        inter = np.minimum(st["inter"], intra)
        saved = intra - inter                      # distortion avoided
        ratio = np.where(intra > 0, saved / np.maximum(intra, 1e-9), 0.0)
        flow = saved + mc_dep[i] * ratio           # total value of ref
        # scatter onto the <=4 overlapped ref blocks (bilinear by area),
        # into the per-block winning reference frame
        ry = np.clip(bys + st["mv"][:, 0] // 8, 0, gh * BLK - BLK)
        rx = np.clip(bxs + st["mv"][:, 1] // 8, 0, gw * BLK - BLK)
        b0y, b0x = ry // BLK, rx // BLK
        fy, fx = ry - b0y * BLK, rx - b0x * BLK
        for ri, r in enumerate(dep_i):
            sel = st["ref_sel"] == ri
            acc = mc_dep[r]
            for dy, wy in ((0, BLK - fy), (1, fy)):
                for dx, wx in ((0, BLK - fx), (1, fx)):
                    w = (wy * wx) / (BLK * BLK) * sel
                    by = np.minimum(b0y + dy, gh - 1)
                    bx = np.minimum(b0x + dx, gw - 1)
                    np.add.at(acc, by * gw + bx, flow * w)
    return mc_dep


def r0_of(stats: Dict, mc_dep: np.ndarray) -> float:
    """Frame-level r0 (generate_r0beta): intra energy over intra +
    propagated — in (0, 1]; small = heavily referenced."""
    intra = float(stats["intra"].sum())
    dep = float(mc_dep.sum())
    return intra / max(intra + dep, 1e-9)


def beta_qmap(stats: Dict, mc_dep: np.ndarray, base_q: int,
              bd: int = 8) -> np.ndarray:
    """Per-64x64 qindex map from per-SB beta (generate_r0beta per-SB
    path): SBs feeding the future more than average get a lower q.
    Deltas are multiples of 1 << delta_q_res (= 4), clamped to keep the
    decoder's CurrentQIndex congruence (see api.encoder._variance_qmap)."""
    gh, gw = stats["gh"], stats["gw"]
    intra = stats["intra"].reshape(gh, gw)
    dep = mc_dep.reshape(gh, gw)
    sh, sw = (gh + 3) // 4, (gw + 3) // 4
    ph, pw = sh * 4 - gh, sw * 4 - gw
    intra = np.pad(intra, ((0, ph), (0, pw)), mode="edge")
    dep = np.pad(dep, ((0, ph), (0, pw)), mode="edge")
    i_sb = intra.reshape(sh, 4, sw, 4).sum(axis=(1, 3))
    d_sb = dep.reshape(sh, 4, sw, 4).sum(axis=(1, 3))
    r_sb = i_sb / np.maximum(i_sb + d_sb, 1e-9)
    r_fr = intra.sum() / max(intra.sum() + dep.sum(), 1e-9)
    beta = r_fr / np.maximum(r_sb, 1e-9)   # >1: SB more load-bearing
    delta = np.clip(np.round(-2.0 * np.log2(beta)), -3, 3) * 4
    res_mask = (1 << 2) - 1
    delta_hi = (255 - base_q) & ~res_mask
    delta = np.clip(delta.astype(np.int32), None, delta_hi)
    return np.clip(base_q + delta, 1, 255)
