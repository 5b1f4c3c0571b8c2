"""Fused DCT_DCT 16x16 forward transform + quantize + dequantize.

Port of the TPU kernel svt_av1_tpu/ops/pallas/fused_txq.py:_kernel
(entered through fwd_txfm_quant_16x16_qp), the only Pallas kernel of the
reference.  On a CUDA tensor ``fused_txq`` launches the hand-written
kernel in csrc/fused_txq.cu (sm_90a; built by kernels.py); on a CPU
tensor it runs ``fused_txq_plain``, the same function written with the
port's ops (fwd_txfm2d + quantize).  There is no fallback between the
two: a CUDA tensor launches the kernel or raises.

Bound on the H100: about 16 KFLOP per 4 KB moved for each 16x16 block,
so memory- and launch-bound at the main path's batch sizes.  The
kernel's float32 sums run in a fixed sequential order (see the source
note in csrc/fused_txq.cu) that differs from cuBLAS's and XLA's; a
coefficient on a rounding tie may therefore differ by one from the plain
version, and qcoeff/dqcoeff always equal the quantizer applied to the
kernel's own coefficients.  rintf rounds half to even like torch.round;
the int32 quantizer products stay below 2^31.
"""
from __future__ import annotations

import ctypes

import torch

from svt_av1_tpu.codec import constants as cc

from svt_av1_tpu_torch import kernels
from svt_av1_tpu_torch.ops import quant, transforms as tf

N = 16

launches = 0   # kernel launches made by fused_txq (the wrapper only)

_bound = None


def _entry():
    """The C entry point with its argtypes declared."""
    global _bound
    if _bound is None:
        fn = kernels.lib().svt_fused_txq16
        p = ctypes.c_void_p
        fn.argtypes = [p, ctypes.c_longlong, p, p, p, p, p, p, p, p, p, p, p]
        fn.restype = ctypes.c_int
        _bound = fn
    return _bound


def fused_txq_plain(resid: torch.Tensor, qp: quant.QuantParams):
    """(coeff, qcoeff, dqcoeff), each (B, 16, 16) int32, from the port's
    plain ops on any device."""
    coeff = tf.fwd_txfm2d(resid, cc.DCT_DCT, cc.TX_16X16)
    qc, dq = quant.quantize(coeff, qp, cc.TX_16X16)
    return coeff, qc, dq


def _check(resid: torch.Tensor, qp: quant.QuantParams):
    if resid.dtype != torch.int32:
        raise TypeError(f"resid must be int32, got {resid.dtype}")
    if resid.dim() != 3 or tuple(resid.shape[1:]) != (N, N):
        raise ValueError(f"resid must be (B, 16, 16), got "
                         f"{tuple(resid.shape)}")
    if not resid.is_contiguous():
        raise ValueError("resid must be contiguous")
    for name, a in zip(qp._fields, qp):
        if (not isinstance(a, torch.Tensor) or a.device != resid.device
                or a.dtype != torch.int32 or tuple(a.shape) != (2,)
                or not a.is_contiguous()):
            raise ValueError(f"qp.{name} must be a contiguous int32 (2,) "
                             f"tensor on {resid.device}")


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
    fv, fh = tf.fwd_matrices_on(cc.DCT_DCT, cc.TX_16X16, resid.device)
    coeff = torch.empty_like(resid)
    qc = torch.empty_like(resid)
    dq = torch.empty_like(resid)
    with torch.cuda.device(resid.device):     # launch on resid's card
        stream = torch.cuda.current_stream(resid.device).cuda_stream
        rc = _entry()(resid.data_ptr(), resid.shape[0], fv.data_ptr(),
                      fh.data_ptr(), qp.zbin.data_ptr(), qp.round.data_ptr(),
                      qp.quant.data_ptr(), qp.quant_shift.data_ptr(),
                      qp.dequant.data_ptr(), coeff.data_ptr(), qc.data_ptr(),
                      dq.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"fused_txq16 launch failed: CUDA error {rc}")
    launches += 1
    return coeff, qc, dq
