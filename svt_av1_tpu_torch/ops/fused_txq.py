"""Fused DCT_DCT 16x16 forward transform + quantize + dequantize.

Port of the TPU kernel svt_av1_tpu/ops/pallas/fused_txq.py:_kernel
(entered through fwd_txfm_quant_16x16_qp), the only Pallas kernel of the
reference.  On a CUDA tensor ``fused_txq`` launches the hand-written
kernel in csrc/fused_txq.cu (sm_90a; built by kernels.py); on a CPU
tensor it runs ``fused_txq_plain``, the same function written with the
port's ops (fwd_txfm2d + quantize).  There is no fallback between the
two: a CUDA tensor launches the kernel or raises.  ``fused_txq_rows`` is
the same kernel with a quantizer row per block (a StreamQuant: one row
per stream of a multi-stream batch, the form the reference's jax.vmap of
the pallas_call takes), its plain twin ``fused_txq_rows_plain``.

Bound on the H100: about 16 KFLOP per 4 KB moved for each 16x16 block,
so memory-bound (see the source note in csrc/fused_txq.cu).  The
kernel's float32 sums run in a fixed sequential order that differs from
cuBLAS's and XLA's; a coefficient on a rounding tie may therefore differ
by one from the plain version, and qcoeff/dqcoeff always equal the
quantizer applied to the kernel's own coefficients.  rintf rounds half to
even like torch.round; the int32 quantizer products stay below 2^31.

The encode's path is bound by the host's issue of small ops, so the
wrapper keeps its own work small: the (transposed) device matrices are
made once per device, the quantizer constants are read through one pointer
(``quant.to_device`` packs them), and the three outputs are views of one
allocation.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from svt_av1_tpu_torch import kernels
from svt_av1_tpu_torch.codec import constants as cc
from svt_av1_tpu_torch.ops import quant, transforms as tf

N = 16

launches = 0   # kernel launches made by fused_txq (the wrapper only)
batches = set()   # the batch sizes B those launches had
launches_rows = 0   # the same for fused_txq_rows
batches_rows = set()

_P = ctypes.c_void_p


@functools.lru_cache(maxsize=None)
def entry(name: str = "svt_fused_txq16"):
    """A C entry point of csrc/fused_txq.cu with its argtypes declared:
    ``svt_fused_txq16`` (the encode's kernel), ``svt_fused_txq16_rows``
    (its per-row form) or ``svt_fused_txq16_v1`` (the first kernel, kept
    for comparison)."""
    fn = getattr(kernels.lib(), name)
    if name == "svt_fused_txq16":
        fn.argtypes = [_P, ctypes.c_longlong, _P, _P, _P, _P, _P]
    elif name == "svt_fused_txq16_rows":
        fn.argtypes = [_P, ctypes.c_longlong, _P, _P, _P, _P, _P, _P]
    else:
        fn.argtypes = [_P, ctypes.c_longlong] + [_P] * 11
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def matrices_t(index: int):
    """(fv^T, fh^T): the DCT_DCT 16x16 forward matrices transposed, as
    contiguous float32 tensors on CUDA device ``index`` (the layout the
    kernel copies into shared memory); made once per device.  Keyed by
    the index: hashing a torch.device costs more than the lookup saves."""
    fv, fh = tf.fwd_matrices_on(cc.DCT_DCT, cc.TX_16X16,
                                torch.device("cuda", index))
    return fv.t().contiguous(), fh.t().contiguous()


def packed_constants(qp: quant.QuantParams) -> torch.Tensor:
    """The ten quantizer constants ([zbin, round, quant, quant_shift,
    dequant] x [DC, AC]) as one contiguous int32 tensor: the (5, 2)
    tensor ``quant.to_device`` made, when qp's fields are its rows,
    else a stacked copy."""
    base = qp.zbin.data_ptr()
    if all(a.data_ptr() == base + 8 * k for k, a in enumerate(qp)):
        return qp.zbin
    return torch.stack(tuple(qp))


def fused_txq_plain(resid: torch.Tensor, qp: quant.QuantParams):
    """(coeff, qcoeff, dqcoeff), each (B, 16, 16) int32, from the port's
    plain ops on any device."""
    coeff = tf.fwd_txfm2d(resid, cc.DCT_DCT, cc.TX_16X16)
    qc, dq = quant.quantize(coeff, qp, cc.TX_16X16)
    return coeff, qc, dq


def fused_txq_rows_plain(resid: torch.Tensor, sq: quant.StreamQuant):
    """The per-row form's plain twin: fwd_txfm2d + quantize with each
    block's row gathered from the table."""
    coeff = tf.fwd_txfm2d(resid, cc.DCT_DCT, cc.TX_16X16)
    qc, dq = quant.quantize(coeff, sq, cc.TX_16X16)
    return coeff, qc, dq


def _check_resid(resid: torch.Tensor):
    if resid.dtype is not torch.int32:
        raise TypeError(f"resid must be int32, got {resid.dtype}")
    if resid.dim() != 3 or resid.shape[1:] != (N, N):
        raise ValueError(f"resid must be (B, 16, 16), got "
                         f"{tuple(resid.shape)}")
    if not resid.is_contiguous():
        raise ValueError("resid must be contiguous")
    if resid.data_ptr() % 16:
        raise ValueError("resid must start on a 16-byte boundary")


def _check(resid: torch.Tensor, qp: quant.QuantParams):
    _check_resid(resid)
    dev = resid.device
    for name, a in zip(qp._fields, qp):
        if (type(a) is not torch.Tensor or a.dtype is not torch.int32
                or a.shape != (2,) or a.device != dev
                or not a.is_contiguous()):
            raise ValueError(f"qp.{name} must be a contiguous int32 (2,) "
                             f"tensor on {dev}")


def fused_txq(resid: torch.Tensor, qp: quant.QuantParams):
    """Fused 16x16 DCT_DCT forward transform + quantizer over a block
    batch.  resid: (B, 16, 16) int32; qp: QuantParams of int32 (2,)
    tensors on the same device (the frame quantizer).  Returns (coeff,
    qcoeff, dqcoeff), each (B, 16, 16) int32."""
    global launches
    if resid.device.type == "cpu":
        return fused_txq_plain(resid, qp)
    if resid.device.type != "cuda":
        raise ValueError(f"fused_txq runs on cpu or cuda, not "
                         f"{resid.device}")
    _check(resid, qp)
    qc = packed_constants(qp)
    fvt, fht = matrices_t(resid.get_device())
    out = torch.empty((3,) + tuple(resid.shape), dtype=torch.int32,
                      device=resid.device)
    with torch.cuda.device(resid.device):     # launch on resid's card
        stream = torch.cuda.current_stream(resid.device).cuda_stream
        rc = entry()(resid.data_ptr(), resid.shape[0], fvt.data_ptr(),
                     fht.data_ptr(), qc.data_ptr(), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"fused_txq16 launch failed: CUDA error {rc}")
    launches += 1
    batches.add(int(resid.shape[0]))
    return out.unbind(0)


def _check_rows(resid: torch.Tensor, sq: quant.StreamQuant):
    _check_resid(resid)
    dev = resid.device
    t, sid = sq.table, sq.sid
    if (type(t) is not torch.Tensor or t.dtype is not torch.int32
            or t.dim() != 3 or t.shape[1:] != (5, 2) or t.device != dev
            or not t.is_contiguous()):
        raise ValueError(f"the quantizer table must be a contiguous int32 "
                         f"(S, 5, 2) tensor on {dev}")
    if (type(sid) is not torch.Tensor or sid.dim() != 1
            or sid.shape[0] != resid.shape[0] or sid.device != dev):
        raise ValueError(f"the row index must be a ({resid.shape[0]},) "
                         f"tensor on {dev}")
    if sid.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"the row index must be integer, got {sid.dtype}")


def fused_txq_rows(resid: torch.Tensor, sq: quant.StreamQuant):
    """K1 with a quantizer row per block: resid (B, 16, 16) int32 and a
    StreamQuant whose sid (B,) picks each block's row of its (S, 5, 2)
    table.  Returns (coeff, qcoeff, dqcoeff), each (B, 16, 16) int32.
    The row indices are the caller's (a stream index, in range by
    construction)."""
    global launches_rows
    if resid.device.type == "cpu":
        return fused_txq_rows_plain(resid, sq)
    if resid.device.type != "cuda":
        raise ValueError(f"fused_txq_rows runs on cpu or cuda, not "
                         f"{resid.device}")
    _check_rows(resid, sq)
    rows = sq.sid.to(torch.int32)
    fvt, fht = matrices_t(resid.get_device())
    out = torch.empty((3,) + tuple(resid.shape), dtype=torch.int32,
                      device=resid.device)
    with torch.cuda.device(resid.device):
        stream = torch.cuda.current_stream(resid.device).cuda_stream
        rc = entry("svt_fused_txq16_rows")(
            resid.data_ptr(), resid.shape[0], fvt.data_ptr(), fht.data_ptr(),
            sq.table.data_ptr(), rows.data_ptr(), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"fused_txq16_rows launch failed: CUDA error "
                           f"{rc}")
    launches_rows += 1
    batches_rows.add(int(resid.shape[0]))
    return out.unbind(0)
