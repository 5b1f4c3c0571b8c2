"""svt_av1_tpu_torch — the PyTorch/CUDA port of the svt_av1_tpu encoder.

The JAX package ``svt_av1_tpu`` stays the reference; this package keeps
its module names so that each counterpart is easy to find:

  api/encoder.py            Encoder (all-intra slice) + Packet
  codec/decoder.py          key-frame, single-tile verification decoder
  codec/rate_est.py         MD rate tables, context-exact CoefTables
  pipeline/intra_encoder.py wave-batched intra mode decision + recon
  ops/                      quantizer, transforms, intra predictors,
                            coefficient rates, the fused txfm+quant op
  csrc/                     CUDA C++ kernels for sm_90a
  kernels.py                nvcc build + ctypes load of csrc/*.cu
  goldens.py                inputs of the C-reference goldens
  convert.py                the reference's tables as port tensors
  device.py                 device resolution and numeric settings

The host side (OBU syntax, CDFs, the native range coder in native/,
rate control, presets, configuration, the data files in codec/data/) is
a verbatim copy of the reference's numpy/C modules with the package name
rewritten.  This package imports neither ``jax`` nor anything of
``svt_av1_tpu``, and runs on the current CUDA device unless a caller
passes ``device="cpu"``.
"""

__version__ = "0.1.0"
