"""Mode-decision rate tables for the port (thin layer).

The numpy derivations live in svt_av1_tpu/codec/rate_est.py and are
reused as they are (``_sym_bits``, ``tables_for_qindex``,
``rdoq_tables_for_qindex``).  What this module adds is the context-exact
``CoefTables`` bundle (the reference's ``exact_coef_tables`` builds the
JAX package's class) and ``md_rate_args`` with its tensors on a device.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from svt_av1_tpu.codec import constants as cc
from svt_av1_tpu.codec import tables as tb
from svt_av1_tpu.codec.cdf import FrameCDFs
from svt_av1_tpu.codec.coeff import eob_pos_token
from svt_av1_tpu.codec.rate_est import (_sym_bits, rdoq_tables_for_qindex,
                                        tables_for_qindex)

from svt_av1_tpu_torch.ops.coef_rate import CoefTables


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


def md_rate_args(qindex: int, modes, uv_modes, exact: bool = False,
                 device=None) -> tuple:
    """(coef_y, coef_uv, txb_base (2,), mode_bits (len(modes),),
    uv_bits (len(uv_modes),), eob_y (257,), eob_uv (65,), rq_y, rq_uv)
    as float32 tensors on ``device``, for the intra MD programs.

    exact: context-exact CoefTables in the coef_y / coef_uv slots instead
    of the (64,) level curves.  The key-frame subset of the reference's
    md_rate_args: default CDF state, intra-frame mode pricing."""
    t = tables_for_qindex(int(qindex))
    mode_bits = np.array(
        [t["y_mode_bits"][m if m < cc.INTRA_MODES else cc.DC_PRED]
         for m in modes], np.float32)
    uv_bits = np.array([t["uv_mode_bits"][m] for m in uv_modes],
                       np.float32)
    rq = rdoq_tables_for_qindex(int(qindex))
    coef_y, coef_uv = t["coef_y"], t["coef_uv"]
    if exact:
        coef_y = _default_exact_tables(int(qindex), cc.TX_16X16, 0)
        coef_uv = _default_exact_tables(int(qindex), cc.TX_8X8, 1)
    return rate_args_to(
        (coef_y, coef_uv, t["txb_base"], mode_bits, uv_bits,
         t["eob_y"], t["eob_uv"], rq["rq_y"], rq["rq_uv"]), device)


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
