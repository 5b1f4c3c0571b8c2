"""svt_av1_tpu_torch — the PyTorch/CUDA port of the svt_av1_tpu encoder.

The JAX package ``svt_av1_tpu`` stays the reference; this package keeps
its module names so that each counterpart is easy to find:

  api/encoder.py            Encoder (all-intra slice) + Packet
  codec/decoder.py          key-frame, single-tile verification decoder
  codec/rate_est.py         context-exact MD rate tables (CoefTables)
  pipeline/intra_encoder.py wave-batched intra mode decision + recon
  ops/                      quantizer, transforms, intra predictors,
                            coefficient rates, the fused txfm+quant op
  csrc/                     CUDA C++ kernels for sm_90a
  kernels.py                nvcc build + ctypes load of csrc/*.cu
  convert.py                the reference's tables as port tensors
  device.py                 device resolution and numeric settings

The host side (OBU syntax, CDFs, the native range coder, rate control,
presets, configuration) is numpy/C and is imported from ``svt_av1_tpu``;
none of those imports loads JAX.  This package never imports ``jax``.
"""

__version__ = "0.1.0"
