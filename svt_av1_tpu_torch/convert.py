"""The reference's encoder state as the port's tensors.

An encoder has no weights: its "parameters" are the quantizer constants,
the transform matrices and stage programs (data files both packages read)
and the mode-decision rate arguments.  These functions take values the
JAX package computes — ``ops.quant.make_quant_params(q)``,
``ops.coef_rate.CoefTables``, ``codec.rate_est.md_rate_args(...)`` (for
any candidate list: with tx search the mode ids repeat, one entry per
candidate) and ``palette_md_candidates(...)``, handed over as numpy
arrays and NamedTuples — and return the port's
tensors on ``device`` (default: the current CUDA device), so that both
packages can be fed identical tables.  Nothing here imports the JAX
package: a NamedTuple is read by its fields.
"""
from __future__ import annotations

import numpy as np
import torch

from svt_av1_tpu_torch import device as device_mod
from svt_av1_tpu_torch.codec.rate_est import rate_args_to
from svt_av1_tpu_torch.ops import quant
from svt_av1_tpu_torch.ops.coef_rate import CoefTables


def quant_params_from_jax(qp, device=None) -> quant.QuantParams:
    """A QuantParams (five (2,) int32 arrays) as int32 tensors."""
    return quant.to_device(qp, device_mod.resolve(device))


def coef_tables_from_jax(t, device=None) -> CoefTables:
    """A CoefTables (six float32 arrays) as the port's CoefTables."""
    return CoefTables(*t).to(device_mod.resolve(device))


def rate_args_from_jax(rt, device=None) -> tuple:
    """An md_rate_args tuple (with CoefTables in the coef slots when it
    was built with exact=True) as float32 tensors."""
    return rate_args_to(rt, device_mod.resolve(device))


def palette_cands_from_jax(cands, device=None):
    """A ``palette_md_candidates`` result of the JAX package — (cost (nb,)
    float32, rec (nb, 16, 16) int32, qy (nb, 256) int16, info) numpy — as
    the tuple the port's ``encode_intra_frame`` takes: the three arrays
    as tensors on ``device``, the host-side info dict as it is.  None
    (no block qualifies) stays None."""
    if cands is None:
        return None
    dev = device_mod.resolve(device)
    cost, rec, qy, info = cands
    return (torch.as_tensor(np.asarray(cost, np.float32), device=dev),
            torch.as_tensor(np.array(rec, np.int32), device=dev),
            torch.as_tensor(np.asarray(qy, np.int16), device=dev), info)
