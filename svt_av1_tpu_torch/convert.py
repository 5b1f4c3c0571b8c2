"""The reference's encoder state as the port's tensors.

An encoder has no weights: its "parameters" are the quantizer constants,
the transform matrices and stage programs (data files both packages read)
and the mode-decision rate arguments.  These functions take the JAX
package's numpy values — ``ops.quant.make_quant_params(q)``,
``ops.coef_rate.CoefTables`` and ``codec.rate_est.md_rate_args(...)`` —
and return the port's tensors on ``device``, so that both packages can be
fed identical tables.
"""
from __future__ import annotations

from svt_av1_tpu_torch.codec.rate_est import rate_args_to
from svt_av1_tpu_torch.ops import quant
from svt_av1_tpu_torch.ops.coef_rate import CoefTables


def quant_params_from_jax(qp, device=None) -> quant.QuantParams:
    """A QuantParams (five (2,) int32 arrays) as int32 tensors."""
    return quant.to_device(qp, device)


def coef_tables_from_jax(t, device=None) -> CoefTables:
    """A CoefTables (six float32 arrays) as the port's CoefTables."""
    return CoefTables(*t).to(device)


def rate_args_from_jax(rt, device=None) -> tuple:
    """An md_rate_args tuple (with CoefTables in the coef slots when it
    was built with exact=True) as float32 tensors."""
    return rate_args_to(rt, device)
