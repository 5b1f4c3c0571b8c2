"""Mode-decision rate tables for the port.

Two parts:

* The numpy derivations, copied from the reference's
  svt_av1_tpu/codec/rate_est.py with their names (``_sym_bits``,
  ``true_tables_for_qindex``, ``tables_for_qindex``,
  ``rdoq_tables_for_qindex``, ``adapted_decision_tables`` and their
  helpers).  ``tables_for_qindex``
  holds the tables MD decides with: a sparsity-calibrated level curve
  plus fitted eob-position costs, and zero mode-signaling costs, because
  pricing candidates with accurate static bits loses BD-rate against a
  coder whose CDFs adapt to what the encoder concentrates on.  The fitted
  tables are read from codec/data/md_rate_fit*.npz.
  ``adapted_decision_tables`` re-derives the decision tables from an
  adapted CDF state (the ``adapted_rates`` override).
* The context-exact ``CoefTables`` bundle and ``md_rate_args`` with its
  tensors on a device.
"""
from __future__ import annotations

import functools
import os
from typing import Dict

import numpy as np
import torch

from svt_av1_tpu_torch import device as device_mod
from svt_av1_tpu_torch.codec import constants as cc
from svt_av1_tpu_torch.codec import tables as tb
from svt_av1_tpu_torch.codec.cdf import FrameCDFs, get_q_ctx
from svt_av1_tpu_torch.codec.coeff import eob_pos_token
from svt_av1_tpu_torch.ops.coef_rate import CoefTables, stack_tables

MAX_LEVEL = 63   # cost tables cover |level| 0..MAX_LEVEL


def _sym_bits(icdf_row: np.ndarray, nsyms: int) -> np.ndarray:
    """Per-symbol bits from one inverse-CDF row (icdf = 32768 - cdf).

    Coder-effective, not ideal -log2(p): the od_ec range coder allocates
    symbol s the range [u, v) with u/v computed from the TRUNCATED
    probabilities (icdf >> EC_PROB_SHIFT, plus the EC_MIN_PROB floor per
    remaining symbol; entropy.py _encode_q15).  For low-probability
    symbols the truncation costs up to ~0.2 bit each — measured ~8% of
    total txb bits on dense blocks — so rate tables must price the
    quantized allocation.  Averaged over the renormalized range
    r in [32768, 65536) with the coder's stationary 1/r density (the
    nominal-r=32768 estimate still underprices dense blocks by
    ~0.02 bit/symbol)."""
    f = np.concatenate([[32768], icdf_row[:nsyms].astype(np.int64)])
    n = nsyms - 1
    s = np.arange(nsyms, dtype=np.int64)
    r = _R_GRID[:, None]                      # (R, 1)
    fl, fh = f[:-1], f[1:]
    hi = np.where(fl >= 32768, r,
                  ((r >> 8) * (fl >> 6) >> 1) + 4 * (n - (s - 1)))
    lo = ((r >> 8) * (fh >> 6) >> 1) + 4 * (n - s)
    bits = -np.log2(np.maximum(hi - lo, 1) / r)
    return np.average(bits, axis=0, weights=_R_WEIGHTS).astype(np.float32)


# geometric r grid with 1/r (log-uniform) stationary weights
_R_GRID = np.unique(np.geomspace(32768, 65535, 48).astype(np.int64))
_R_WEIGHTS = 1.0 / _R_GRID


def _avg_bits(rows: np.ndarray, nsyms: int) -> np.ndarray:
    """Average per-symbol bits over all leading context axes."""
    flat = rows.reshape(-1, rows.shape[-1])
    return np.mean(np.stack([_sym_bits(r, nsyms) for r in flat]), axis=0)


@functools.lru_cache(maxsize=1)
def _fitted():
    """Calibrated tables from tools/fit_md_rate.py (real-coder bits)."""
    path = os.path.join(os.path.dirname(__file__), "data",
                        "md_rate_fit.npz")
    if not os.path.exists(path):
        return None
    return dict(np.load(path))


@functools.lru_cache(maxsize=1)
def _fitted_adapted():
    """tools/fit_md_rate.py --adapted: marginal bits with LIVE CDF
    adaptation (what the emitted stream pays; RDOQ prices with these)."""
    path = os.path.join(os.path.dirname(__file__), "data",
                        "md_rate_fit_adapted.npz")
    if not os.path.exists(path):
        return None
    return dict(np.load(path))


@functools.lru_cache(maxsize=32)
def rdoq_tables_for_qindex(qindex: int) -> Dict[str, np.ndarray]:
    """(coef+eob) bundles for RDOQ: rq_y (64+257,), rq_uv (64+65,).
    Adapted-fit preferred; falls back to the true static tables."""
    ad = _fitted_adapted()
    bk = get_q_ctx(qindex)
    if ad is not None and f"b{bk}_coef_y" in ad:
        cy = ad[f"b{bk}_coef_y"].astype(np.float32)
        ey = ad[f"b{bk}_eob_y"].astype(np.float32)
        cu = ad[f"b{bk}_coef_uv"].astype(np.float32)
        eu = ad[f"b{bk}_eob_uv"].astype(np.float32)
    else:
        t = true_tables_for_qindex(qindex)
        cy, ey = t["coef_y"], t["eob_y"]
        cu, eu = t["coef_uv"], t["eob_uv"]
    return dict(rq_y=np.concatenate([cy, ey]).astype(np.float32),
                rq_uv=np.concatenate([cu, eu]).astype(np.float32))


def _eob_table_from_cls(cls: np.ndarray, ncoeffs: int) -> np.ndarray:
    out = np.zeros(ncoeffs + 1, np.float32)
    for eob in range(1, ncoeffs + 1):
        pt = (1 if eob == 1 else 2 if eob == 2
              else int(np.floor(np.log2(eob - 1))) + 2)
        b = cls[pt - 1]
        if pt >= 3:
            b += pt - 2   # eob_extra + literal magnitude bits
        out[eob] = b
    return out


def _analytic_eob_table(c: FrameCDFs, ncoeffs: int) -> np.ndarray:
    npt = int(np.log2(ncoeffs)) + 1
    return _eob_table_from_cls(_avg_bits(c.eob_flag[ncoeffs], npt),
                               ncoeffs)


def _level_curve(base: np.ndarray, br: np.ndarray) -> np.ndarray:
    """|level| -> bits from base/br per-symbol costs (the coeff coding
    ladder: base symbol, up to 4 br rounds, exp-golomb tail, sign)."""
    lv = np.zeros(MAX_LEVEL + 1, np.float32)
    for level in range(MAX_LEVEL + 1):
        b = base[min(level, 3)]
        if level >= 3:
            extra = level - 3
            rounds = 0
            while rounds < 4 and extra >= 0:
                step = min(extra, 3)
                b += br[step]
                if step < 3:
                    break
                extra -= 3
                rounds += 1
            if level > 14:
                rem = level - 15 + 1
                b += 2 * int(np.floor(np.log2(rem))) + 1  # exp-golomb
        if level > 0:
            b += 1.0  # sign
        lv[level] = b
    return lv


@functools.lru_cache(maxsize=32)
def true_tables_for_qindex(qindex: int) -> Dict[str, np.ndarray]:
    """Accurate per-level / eob / mode bit costs (rate PREDICTION)."""
    c = FrameCDFs(qindex)
    lv = _level_curve(_avg_bits(c.coeff_base, 4), _avg_bits(c.coeff_br, 4))
    txb = float(_avg_bits(c.txb_skip, 2)[0])
    out = dict(coef_y=lv, coef_uv=lv,
               txb_base=np.array([txb, txb], np.float32),
               eob_y=_analytic_eob_table(c, 256),
               eob_uv=_analytic_eob_table(c, 64))
    fit = _fitted()
    bk = get_q_ctx(qindex)
    if fit is not None and f"b{bk}_coef_y" in fit:
        out["coef_y"] = fit[f"b{bk}_coef_y"].astype(np.float32)
        out["eob_y"] = fit[f"b{bk}_eob_y"].astype(np.float32)
        out["coef_uv"] = fit[f"b{bk}_coef_uv"].astype(np.float32)
        out["eob_uv"] = fit[f"b{bk}_eob_uv"].astype(np.float32)
        out["txb_base"] = np.zeros(2, np.float32)  # in the eob tables
    return out


@functools.lru_cache(maxsize=32)
def tables_for_qindex(qindex: int) -> Dict[str, np.ndarray]:
    """MD DECISION tables (see module docstring for why these are a
    sparsity-calibrated curve rather than the true static costs)."""
    t = true_tables_for_qindex(qindex)
    lvl = np.arange(MAX_LEVEL + 1)
    spars = (2.0 * np.log2(1.0 + lvl) + (lvl > 0)).astype(np.float32)
    c = FrameCDFs(qindex)
    kf = _avg_bits(c.kf_y_mode, cc.INTRA_MODES)
    angle0 = _avg_bits(c.angle_delta, 7)[3]
    y_mode = kf.copy()
    for m in range(cc.V_PRED, cc.D67_PRED + 1):
        y_mode[m] += angle0
    uv = _avg_bits(c.uv_mode[1], cc.UV_INTRA_MODES)[:cc.INTRA_MODES]
    return dict(coef_y=spars, coef_uv=spars,
                txb_base=np.zeros(2, np.float32),
                eob_y=t["eob_y"], eob_uv=t["eob_uv"],
                # informational (decision weight 0, see docstring)
                y_mode_bits=np.zeros_like(y_mode),
                uv_mode_bits=np.zeros(cc.INTRA_MODES, np.float32),
                y_mode_bits_true=y_mode.astype(np.float32),
                uv_mode_bits_true=uv.astype(np.float32))


def _avg_bits_vec(rows: np.ndarray, nsyms: int) -> np.ndarray:
    """Vectorized _avg_bits (per-frame refresh path: hundreds of context
    rows, host time must stay negligible)."""
    flat = rows.reshape(-1, rows.shape[-1])[:, :nsyms].astype(np.int64)
    v = np.concatenate(
        [np.full((len(flat), 1), 32768, np.int64), flat], axis=1)
    p = (v[:, :-1] - v[:, 1:]) / 32768.0
    return (-np.log2(np.maximum(p, 1.0 / 32768.0))).mean(axis=0) \
        .astype(np.float32)


# get_txsize_entropy_ctx(TX_16X16) / (TX_8X8)
_TXS_CTX_16, _TXS_CTX_8 = 2, 1


def adapted_decision_tables(c) -> Dict[str, np.ndarray]:
    """MD rate tables re-derived from an ADAPTED CDF state (the
    primary-ref chain) — per-frame analog of the reference's rolling-CDF
    rate refresh (enc_dec_process.c:3304-3318 av1_estimate_coef_rate /
    md_rate_estimation.c).

    MEASURED (round 3, preset-6 GOP pan clip, 4 CRFs): ~-2 dB at equal
    bits versus the sparsity/fitted tables — SHIPS DISABLED
    (presets.adapted_rates=False).  Root cause: _txb_bits evaluates
    nonzero levels with the analytic VPU formula (no per-coefficient
    table gather on the TPU), so only the zero-symbol cost, eob table
    and txb flag from this derivation actually flow into decisions, and
    pricing those "accurately" re-opens the same skip-bias trap the
    round-2 static-accurate experiment hit.  The real counterpart of
    the reference's rate refresh needs context-exact per-coefficient
    pricing inside the device program — a rate-model redesign, not a
    table swap."""
    base_y = _avg_bits_vec(c.coeff_base[_TXS_CTX_16, 0], 4)
    br_y = _avg_bits_vec(c.coeff_br[_TXS_CTX_16, 0], 4)
    base_uv = _avg_bits_vec(c.coeff_base[_TXS_CTX_8, 1], 4)
    br_uv = _avg_bits_vec(c.coeff_br[_TXS_CTX_8, 1], 4)
    eob_y = _eob_table_from_cls(_avg_bits_vec(c.eob_flag[256][0], 9),
                                256)
    eob_uv = _eob_table_from_cls(_avg_bits_vec(c.eob_flag[64][1], 7),
                                 64)
    txb_y = float(_avg_bits_vec(c.txb_skip[_TXS_CTX_16], 2)[0])
    txb_uv = float(_avg_bits_vec(c.txb_skip[_TXS_CTX_8], 2)[0])
    return dict(coef_y=_level_curve(base_y, br_y),
                coef_uv=_level_curve(base_uv, br_uv),
                eob_y=eob_y, eob_uv=eob_uv,
                txb_base=np.array([txb_y, txb_uv], np.float32))


def exact_coef_tables(c: FrameCDFs, tx_size: int, plane: int,
                      luma_skip_ctx: int = 0) -> CoefTables:
    """Context-exact bit-cost tables (numpy float32 fields) for
    ops/coef_rate.txb_bits_exact, derived from a CDF state.

    txb_skip context: luma MD blocks have tx == plane bsize, so the
    coder's skip context is 0; chroma blocks use ctx 7+ca+cl, priced
    with the mean of rows 7..9."""
    sctx = tb.txs_ctx(tx_size)
    brc = min(sctx, cc.TX_32X32)
    base = np.stack([_sym_bits(r, 4) for r in c.coeff_base[sctx][plane]])
    base_eob = np.stack(
        [_sym_bits(r, 3) for r in c.coeff_base_eob[sctx][plane]])
    br = np.stack([_sym_bits(r, 4) for r in c.coeff_br[brc][plane]])
    _, w, h = tb.txb_dims(tx_size)
    ncoeffs = w * h
    nsyms = tb.txsize_log2_minus4(tx_size) + 5
    pt_bits = _sym_bits(c.eob_flag[ncoeffs][plane][0], nsyms)
    eob_tbl = np.zeros(ncoeffs + 1, np.float32)
    for e in range(1, ncoeffs + 1):
        pt, extra = eob_pos_token(e)
        cost = pt_bits[pt - 1]
        ob = int(tb.K_EOB_OFFSET_BITS[pt])
        if ob > 0:
            bit = (extra >> (ob - 1)) & 1
            cost += _sym_bits(c.eob_extra[sctx][plane][pt], 2)[bit]
            cost += ob - 1
        eob_tbl[e] = cost
    if plane == 0:
        sk = _sym_bits(c.txb_skip[sctx][luma_skip_ctx], 2)
    else:
        sk = np.mean(np.stack(
            [_sym_bits(c.txb_skip[sctx][k], 2) for k in (7, 8, 9)]), axis=0)
    dcs = float(np.mean(_sym_bits(c.dc_sign[plane][0], 2)))
    return CoefTables(base=base.astype(np.float32),
                      base_eob=base_eob.astype(np.float32),
                      br=br.astype(np.float32),
                      eob=eob_tbl,
                      skip=sk.astype(np.float32),
                      dc_sign=np.float32(dcs))


@functools.lru_cache(maxsize=32)
def _default_exact_tables(qindex: int, tx_size: int, plane: int,
                          luma_skip_ctx: int = 0) -> CoefTables:
    return exact_coef_tables(FrameCDFs(int(qindex)), tx_size, plane,
                             luma_skip_ctx)


def exact_rates_override(exact: bool) -> bool:
    """``exact`` under the SVT_TPU_EXACT_RATES A/B override, which wins
    where it is set: "0" or "" turns the context-exact model off, any
    other value on (the reference reads it in its md_rate_args)."""
    env = os.environ.get("SVT_TPU_EXACT_RATES")
    if env is not None:
        return env not in ("0", "")
    return bool(exact)


def md_rate_args(qindex: int, modes, uv_modes, cdf_state=None,
                 inter_frame: bool = False, exact: bool = False,
                 device=None) -> tuple:
    """(coef_y, coef_uv, txb_base (2,), mode_bits (len(modes),),
    uv_bits (len(uv_modes),), eob_y (257,), eob_uv (65,), rq_y, rq_uv)
    as float32 tensors on ``device`` (default: the current CUDA device),
    for the MD programs; rq_y / rq_uv are RDOQ's level + eob bundles.

    exact: context-exact CoefTables in the coef_y / coef_uv slots instead
    of the (64,) level curves (SVT_TPU_EXACT_RATES overrides it, see
    exact_rates_override).  inter_frame: intra modes priced with their
    true signaling cost plus the intra_inter flag (an inter frame's
    choice is intra against inter).  cdf_state: an adapted FrameCDFs
    (the primary-ref chain, ``adapted_rates``): the decision curves, eob
    tables and txb flags come from adapted_decision_tables, and the
    exact model's tables from this state instead of the default one."""
    t = tables_for_qindex(int(qindex))
    if cdf_state is not None:
        t = dict(t)
        t.update(adapted_decision_tables(cdf_state))
    ykey = "y_mode_bits_true" if inter_frame else "y_mode_bits"
    ukey = "uv_mode_bits_true" if inter_frame else "uv_mode_bits"
    intra_flag = 1.5 if inter_frame else 0.0   # intra_inter symbol
    # filter-intra pseudo-modes (>= FI_MODE_BASE) signal as DC
    mode_bits = np.array(
        [t[ykey][m if m < cc.INTRA_MODES else cc.DC_PRED] + intra_flag
         for m in modes], np.float32)
    uv_bits = np.array([t[ukey][m] for m in uv_modes], np.float32)
    rq = rdoq_tables_for_qindex(int(qindex))
    coef_y, coef_uv = t["coef_y"], t["coef_uv"]
    if exact_rates_override(exact):
        if cdf_state is not None:
            coef_y = exact_coef_tables(cdf_state, cc.TX_16X16, 0)
            coef_uv = exact_coef_tables(cdf_state, cc.TX_8X8, 1)
        else:
            coef_y = _default_exact_tables(int(qindex), cc.TX_16X16, 0)
            coef_uv = _default_exact_tables(int(qindex), cc.TX_8X8, 1)
    return rate_args_to(
        (coef_y, coef_uv, t["txb_base"], mode_bits, uv_bits,
         t["eob_y"], t["eob_uv"], rq["rq_y"], rq["rq_uv"]),
        device_mod.resolve(device))


def rate_args_to(rt, device) -> tuple:
    """An md_rate_args tuple (numpy arrays; a CoefTables of either
    package in the coef_y / coef_uv slots) as float32 tensors on
    ``device``."""
    out = []
    for a in rt:
        if hasattr(a, "_fields"):
            out.append(CoefTables(*a).to(device))
        else:
            out.append(torch.as_tensor(np.asarray(a, np.float32),
                                       device=device))
    return tuple(out)


def stack_rate_args(rts) -> tuple:
    """The md_rate_args tuples of S streams (one qindex each, on one
    device) as one tuple whose tensors carry a leading stream axis, read
    per block through the block's stream index (``_txb_bits``,
    ``txb_bits_exact``); CoefTables are stacked field-wise, as the
    reference stacks its per-stream rate pytrees
    (svt_av1_tpu/parallel/multistream.py:211-215).  txb_base is stacked
    plane-major, (2, S), so that ``txb_base[plane]`` selects a plane as in
    a one-stream tuple."""
    out = []
    for k, slot in enumerate(zip(*rts)):
        if isinstance(slot[0], CoefTables):
            out.append(stack_tables(slot))
        elif k == 2:
            out.append(torch.stack(slot, dim=1))
        else:
            out.append(torch.stack(slot))
    return tuple(out)
