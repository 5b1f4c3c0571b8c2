"""Variable square partitions (64 / 32 / 16) for intra frames: the PyTorch
port of svt_av1_tpu/pipeline/varpart.py (presets M0-M4, all-intra
``send_picture``).

A 2:1 wavefront over the 64x64 superblock grid.  Each wave step walks
the wave's superblocks, batched across them:

  for each 32x32 quadrant in z-order:
      run the four 16x16 sub-blocks in z-order (writing recon, so that
      the intra prediction chains stay exact), then price the 32x32
      PARTITION_NONE candidate from the same outside neighbours (the
      subs' writes are interior, so its gathers are unaffected) and keep
      whichever costs less;
  then price the 64x64 PARTITION_NONE candidate (TX_64X64, a coded
  32x32 coefficient region) against the chosen quadrant total and
  overwrite the superblock's recon where it wins.

Where the frame's width (height) is not a multiple of 64, a 64x64 leaf
in the last whole superblock column may see its top-right superblock
stick out of the frame: its samples past the edge repeat the frame's
last one, as the AV1 specification has it (7.11.2); the reference reads
the padding's zeros there and its decoder takes the top-right as
unavailable (ROADMAP.md queue C item 4 (c)).  Elsewhere the program is
the reference's.

The reference runs the wave loop as one jitted fori_loop; here it is a
Python loop of eager ops (the wave steps of pipeline/intra_encoder.py at
n = 16, 32 and 64, with the analytic rate proxy, as the reference's
program prices them), and the decisions come back to the host in one
copy at the end.  The 16x16 steps' transform + quantizer is K1
(ops/fused_txq) on the card.
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch

from svt_av1_tpu_torch import device as device_mod
from svt_av1_tpu_torch.codec import constants as cc
from svt_av1_tpu_torch.codec.syntax import BlockDecision
from svt_av1_tpu_torch.ops import quant
from svt_av1_tpu_torch.pipeline.intra_encoder import (
    MODES, _check_slice, _rd_step, _rd_step_chroma, _scatter_blocks,
    _wave_schedule, frame_lambda, pixel_dtype, split_fi_mode, tr_bl_avail)

# z-order of sub-blocks within their parent
_SUBS = ((0, 0), (0, 1), (1, 0), (1, 1))
# net extra signaling of SPLIT (3 extra partition/mode/uv symbol groups)
SPLIT_EXTRA_BITS = 24.0


def _schedule64(gh64, gw64, gh16, gw16, maxb):
    """2:1 wavefront over the 64-grid + static per-slot availability for
    every level of the SB's square tree."""
    gh32, gw32 = (gh16 + 1) // 2, (gw16 + 1) // 2
    waves = _wave_schedule(gh64, gw64, maxb)
    nw = len(waves)
    sh = (nw, maxb)
    bys = np.zeros(sh, np.int32)
    bxs = np.zeros(sh, np.int32)
    valid = np.zeros(sh, bool)
    v64 = np.zeros(sh, bool)
    tr64 = np.zeros(sh, bool)
    bl64 = np.zeros(sh, bool)
    q_valid = np.zeros(sh + (4,), bool)     # full 32 quadrant in frame
    q_any = np.zeros(sh + (4,), bool)       # quadrant overlaps frame
    q_tr = np.zeros(sh + (4,), bool)
    q_bl = np.zeros(sh + (4,), bool)
    s_valid = np.zeros(sh + (4, 4), bool)   # 16 sub inside frame
    s_tr = np.zeros(sh + (4, 4), bool)
    s_bl = np.zeros(sh + (4, 4), bool)
    for i, wave in enumerate(waves):
        for j, (by, bx) in enumerate(wave):
            bys[i, j] = by
            bxs[i, j] = bx
            valid[i, j] = True
            v64[i, j] = (by * 4 + 4 <= gh16) and (bx * 4 + 4 <= gw16)
            t, b = tr_bl_avail(by, bx, gh64, gw64, m=1)
            tr64[i, j], bl64[i, j] = t, b
            for q, (qr, qc) in enumerate(_SUBS):
                qy, qx = by * 2 + qr, bx * 2 + qc
                if qy * 2 < gh16 and qx * 2 < gw16:
                    q_any[i, j, q] = True
                full = (qy * 2 + 2 <= gh16) and (qx * 2 + 2 <= gw16)
                q_valid[i, j, q] = full and qy < gh32 and qx < gw32
                if qy < gh32 and qx < gw32:
                    t, b = tr_bl_avail(qy, qx, gh32, gw32, m=2)
                    q_tr[i, j, q], q_bl[i, j, q] = t, b
                for s, (sr, sc) in enumerate(_SUBS):
                    sy, sx = qy * 2 + sr, qx * 2 + sc
                    if sy < gh16 and sx < gw16:
                        s_valid[i, j, q, s] = True
                        st, sb = tr_bl_avail(sy, sx, gh16, gw16, m=4)
                        s_tr[i, j, q, s], s_bl[i, j, q, s] = st, sb
    return (waves, bys, bxs, valid, v64, tr64, bl64, q_valid, q_any,
            q_tr, q_bl, s_valid, s_tr, s_bl)


@functools.lru_cache(maxsize=8)
def _device_schedule64(gh64, gw64, gh16, gw16, device):
    """The schedule as per-wave dicts of device tensors over the wave's
    superblocks (slots past a wave's end are left out: each slot's work
    is independent of the others')."""
    maxb = max(1, min(gh64, (gw64 + 1) // 2))
    (waves, bys, bxs, valid, v64, tr64, bl64, q_valid, q_any, q_tr, q_bl,
     s_valid, s_tr, s_bl) = _schedule64(gh64, gw64, gh16, gw16, maxb)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
    out = []
    for i, wave in enumerate(waves):
        nb = len(wave)
        out.append(dict(
            by=t(bys[i, :nb].astype(np.int64)),
            bx=t(bxs[i, :nb].astype(np.int64)),
            v64=t(v64[i, :nb]), tr64=t(tr64[i, :nb]), bl64=t(bl64[i, :nb]),
            q_valid=t(q_valid[i, :nb]), q_any=t(q_any[i, :nb]),
            q_tr=t(q_tr[i, :nb]), q_bl=t(q_bl[i, :nb]),
            s_valid=t(s_valid[i, :nb]), s_tr=t(s_tr[i, :nb]),
            s_bl=t(s_bl[i, :nb])))
    return waves, out


def _frame_program(ry, ru, rv, sy, su, sv, sched, modes, qp, lam, bd=8,
                   edge=None):
    """The wave loop over (1, H, W) int32 recon / source planes padded to
    whole superblocks (recon updated in place); edge: the frame's last
    luma (column, row), past which top-right / bottom-left samples repeat
    the frame's last one.  Returns the per-wave decision tensors: a list
    of dicts, one per wave."""
    dev = ry.device
    uv_dct = (cc.DCT_DCT,) * 4
    acc = []
    for w in sched:
        by, bx = w["by"], w["bx"]
        nb = by.shape[0]
        fi = torch.zeros(nb, dtype=torch.int64, device=dev)
        allv = torch.arange(nb, device=dev)
        total_sb = torch.zeros(nb, dtype=torch.float32, device=dev)
        a = dict(ch32=[], m32=[], uv32=[], q32=[], qu32=[], qv32=[],
                 m16=[], uv16=[], q16=[], qu16=[], qv16=[])
        for q, (qr, qc) in enumerate(_SUBS):
            qy16 = by * 4 + qr * 2         # quadrant top in the 16-grid
            qx16 = bx * 4 + qc * 2
            total16 = torch.zeros(nb, dtype=torch.float32, device=dev)
            subs = []
            for s, (sr, sc) in enumerate(_SUBS):
                ys = (qy16 + sr) * 16
                xs = (qx16 + sc) * 16
                sva = w["s_valid"][:, q, s]
                sel = torch.nonzero(sva).flatten()
                ha = (ys > 0) & sva
                hl = (xs > 0) & sva
                m, qy_c, rec, cost = _rd_step(
                    ry, sy, fi, ys, xs, sel, ha, hl, qp, lam, modes, None,
                    bd=bd, tr_avail=w["s_tr"][:, q, s] & sva,
                    bl_avail=w["s_bl"][:, q, s] & sva, no_write=True,
                    edge=edge)
                _scatter_blocks(ry, rec, fi, ys, xs, sel)
                total16 = total16 + torch.where(sva, cost, 0.0)
                um, qu, qvq, ru, rv = _rd_step_chroma(
                    ru, rv, su, sv, fi, ys // 2, xs // 2, sel, ha, hl, qp,
                    lam, None, bd=bd)
                subs.append((m, qy_c, um, qu, qvq))

            # the 32x32 candidate from the outside neighbours
            va32 = w["q_valid"][:, q]
            ys32, xs32 = qy16 * 16, qx16 * 16
            ha32 = (ys32 > 0) & va32
            hl32 = (xs32 > 0) & va32
            m32, q32c, rec32, c32 = _rd_step(
                ry, sy, fi, ys32, xs32, allv, ha32, hl32, qp, lam, modes,
                None, bd=bd, tr_avail=w["q_tr"][:, q] & va32,
                bl_avail=w["q_bl"][:, q] & va32, n=32, tx_size=cc.TX_32X32,
                no_write=True, edge=edge)
            choose = va32 & (c32 < total16 + lam * SPLIT_EXTRA_BITS)
            csel = torch.nonzero(choose).flatten()
            _scatter_blocks(ry, rec32, fi, ys32, xs32, csel)
            uvm32, qu32, qv32, recu32, recv32 = _rd_step_chroma(
                ru, rv, su, sv, fi, ys32 // 2, xs32 // 2, csel,
                ha32 & choose, hl32 & choose, qp, lam, None, bd=bd, n=16,
                tx_size=cc.TX_16X16, no_write=True)
            _scatter_blocks(ru, recu32, fi, ys32 // 2, xs32 // 2, csel)
            _scatter_blocks(rv, recv32, fi, ys32 // 2, xs32 // 2, csel)
            chosen_cost = torch.where(choose, c32 + lam * 0.0,
                                      total16 + lam * SPLIT_EXTRA_BITS)
            total_sb = total_sb + torch.where(w["q_any"][:, q], chosen_cost,
                                              0.0)
            for k, v in zip(("ch32", "m32", "uv32", "q32", "qu32", "qv32"),
                            (choose, m32, uvm32, q32c, qu32, qv32)):
                a[k].append(v)
            for k, i in zip(("m16", "q16", "uv16", "qu16", "qv16"),
                            range(5)):
                a[k].append(torch.stack([t[i] for t in subs], dim=1))
        out = {k: torch.stack(v, dim=1) for k, v in a.items()}
        # the 64x64 candidate (TX_64X64: 32x32 coded coefficients)
        va64 = w["v64"]
        ys64, xs64 = by * 64, bx * 64
        ha64 = (ys64 > 0) & va64
        hl64 = (xs64 > 0) & va64
        m64, q64c, rec64, c64 = _rd_step(
            ry, sy, fi, ys64, xs64, allv, ha64, hl64, qp, lam, modes, None,
            bd=bd, tr_avail=w["tr64"] & va64, bl_avail=w["bl64"] & va64,
            n=64, tx_size=cc.TX_64X64, no_write=True, edge=edge)
        ch64 = va64 & (c64 < total_sb + lam * SPLIT_EXTRA_BITS)
        csel = torch.nonzero(ch64).flatten()
        _scatter_blocks(ry, rec64, fi, ys64, xs64, csel)
        uvm64, qu64, qv64, recu64, recv64 = _rd_step_chroma(
            ru, rv, su, sv, fi, ys64 // 2, xs64 // 2, csel, ha64 & ch64,
            hl64 & ch64, qp, lam, None, bd=bd, n=32, tx_size=cc.TX_32X32,
            uv_tx_types=uv_dct, no_write=True)
        _scatter_blocks(ru, recu64, fi, ys64 // 2, xs64 // 2, csel)
        _scatter_blocks(rv, recv64, fi, ys64 // 2, xs64 // 2, csel)
        out.update(ch64=ch64, m64=m64, uv64=uvm64, q64=q64c, qu64=qu64,
                   qv64=qv64)
        acc.append(out)
    return acc


def encode_intra_frame_varpart(src_y, src_u, src_v, qindex: int,
                               modes=MODES, bd: int = 8, device=None
                               ) -> Tuple[Dict, Dict[str, torch.Tensor]]:
    """Intra frame with 64/32/16 square partition decisions on ``device``
    (default: the current CUDA device).  Returns ({(r4, c4):
    BlockDecision}, recon dict(y, u, v) of pixel_dtype(bd) tensors on
    ``device``)."""
    h, w = src_y.shape
    _check_slice(modes, bd, h, w)
    dev = device_mod.resolve(device)
    gh16, gw16 = h // 16, w // 16
    gh64, gw64 = (gh16 + 3) // 4, (gw16 + 3) // 4
    waves, sched = _device_schedule64(gh64, gw64, gh16, gw16, dev)
    qp = quant.params_on(int(qindex), dev, bd)
    lam = torch.tensor(frame_lambda(qindex, bd), dtype=torch.float32,
                       device=dev)
    # recon planes padded up to whole SBs so that the 64-level gathers
    # stay in bounds; the coded size (h, w) is cropped at the end
    ph, pw = gh64 * 64, gw64 * 64
    planes = [torch.from_numpy(_pad_to(np.asarray(p).astype(np.int32), hh,
                                       ww))[None].to(dev)
              for p, hh, ww in ((src_y, ph, pw), (src_u, ph // 2, pw // 2),
                                (src_v, ph // 2, pw // 2))]
    ry = torch.zeros((1, ph, pw), dtype=torch.int32, device=dev)
    ru = torch.zeros((1, ph // 2, pw // 2), dtype=torch.int32, device=dev)
    rv = torch.zeros_like(ru)
    acc = _frame_program(ry, ru, rv, *planes, sched, tuple(modes), qp, lam,
                         bd=bd, edge=(w - 1, h - 1))
    # one copy of every wave's decisions to the host
    keys = sorted(acc[0])
    parts = [acc[i][k] for i in range(len(acc)) for k in keys]
    host = torch.cat([t.to(torch.int32).reshape(-1) for t in parts]).cpu() \
        .numpy()
    got, at = [], 0
    for t in parts:
        got.append(host[at:at + t.numel()].reshape(t.shape))
        at += t.numel()
    decisions = {}
    for i, wave in enumerate(waves):
        a = dict(zip(keys, got[i * len(keys):(i + 1) * len(keys)]))
        for j, (by, bx) in enumerate(wave):
            if a["ch64"][j]:
                r4, c4 = by * 16, bx * 16
                decisions[(r4, c4)] = BlockDecision(
                    r4=r4, c4=c4, bsize=cc.BLOCK_64X64,
                    y_mode=int(a["m64"][j]), uv_mode=int(a["uv64"][j]),
                    tx_type=cc.DCT_DCT, qcoeff_y=a["q64"][j],
                    qcoeff_u=a["qu64"][j], qcoeff_v=a["qv64"][j])
                continue  # (64: filter-intra illegal, modes are raw)
            for q, (qr, qc) in enumerate(_SUBS):
                qy16, qx16 = by * 4 + qr * 2, bx * 4 + qc * 2
                if qy16 >= gh16 or qx16 >= gw16:
                    continue
                if a["ch32"][j, q]:
                    r4, c4 = qy16 * 4, qx16 * 4
                    ym32, fi32 = split_fi_mode(int(a["m32"][j, q]))
                    decisions[(r4, c4)] = BlockDecision(
                        r4=r4, c4=c4, bsize=cc.BLOCK_32X32,
                        y_mode=ym32, uv_mode=int(a["uv32"][j, q]),
                        tx_type=cc.DCT_DCT, qcoeff_y=a["q32"][j, q],
                        qcoeff_u=a["qu32"][j, q], qcoeff_v=a["qv32"][j, q],
                        filter_intra_mode=fi32)
                    continue
                for s, (sr, sc) in enumerate(_SUBS):
                    sy16, sx16 = qy16 + sr, qx16 + sc
                    if sy16 >= gh16 or sx16 >= gw16:
                        continue
                    r4, c4 = sy16 * 4, sx16 * 4
                    ym16, fi16 = split_fi_mode(int(a["m16"][j, q, s]))
                    decisions[(r4, c4)] = BlockDecision(
                        r4=r4, c4=c4, bsize=cc.BLOCK_16X16,
                        y_mode=ym16, uv_mode=int(a["uv16"][j, q, s]),
                        tx_type=cc.DCT_DCT, qcoeff_y=a["q16"][j, q, s],
                        qcoeff_u=a["qu16"][j, q, s],
                        qcoeff_v=a["qv16"][j, q, s],
                        filter_intra_mode=fi16)
    pdt = pixel_dtype(bd)
    recon = dict(y=ry[0, :h, :w].to(pdt),
                 u=ru[0, :h // 2, :w // 2].to(pdt),
                 v=rv[0, :h // 2, :w // 2].to(pdt))
    return decisions, recon


def _pad_to(x: np.ndarray, h: int, w: int) -> np.ndarray:
    if x.shape == (h, w):
        return x
    return np.pad(x, ((0, h - x.shape[0]), (0, w - x.shape[1])),
                  mode="edge")


def v32_ok(by, bx, gh16, gw16) -> bool:
    """Whether the 32x32 block (by, bx) of the 32-grid lies inside a frame
    of gh16 x gw16 16x16 blocks."""
    return by * 2 + 2 <= gh16 and bx * 2 + 2 <= gw16
