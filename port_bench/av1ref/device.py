"""Device resolution and the numeric settings the port relies on.

Every entry point takes a ``device`` and passes it through ``resolve``;
with none given the port runs on the current CUDA device, and without
CUDA it raises rather than fall back to the CPU.  Float32 matmuls must
run in full float32: TF32 keeps about three decimal digits and would
move forward-transform coefficients off their rounding points, so both
TF32 switches are turned off here.  Integer tensors are int32 wherever
the JAX package's are (torch defaults to int64)."""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """The torch.device the caller names; ``None`` is the current CUDA
    device.  CUDA that is not present raises, whether named or implied:
    there is no silent fallback to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError('no CUDA device is available: the port runs '
                               'on the GPU by default; pass device="cpu" '
                               'to run on the CPU')
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not "
                               "available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
