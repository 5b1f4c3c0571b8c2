"""Build and load the port's CUDA kernels (svt_av1_tpu_torch/csrc/*.cu).

All sources compile with nvcc into one shared library with a plain C
interface, ``build/kernels/libsvt_av1_tpu_torch.so`` under the
repository root, at first use; the library is rebuilt when a source is
newer than it.  It is loaded with ctypes; each op module declares the
argtypes of the entry points it calls.  A failed build raises with
nvcc's output.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
LIB_PATH = os.path.join(BUILD_DIR, "libsvt_av1_tpu_torch.so")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_lib = None


def _nvcc() -> str:
    """nvcc on PATH, else under $CUDA_HOME (default /usr/local/cuda)."""
    path = shutil.which("nvcc")
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    if path is None and os.path.exists(os.path.join(home, "bin", "nvcc")):
        path = os.path.join(home, "bin", "nvcc")
    if path is None:
        raise RuntimeError(f"nvcc not found (looked on PATH and in "
                           f"{home}/bin): the CUDA kernels cannot be built")
    return path


def sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def stale() -> bool:
    """True when the library is missing or older than a source."""
    if not os.path.exists(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    return any(os.path.getmtime(s) > built for s in sources())


def build() -> str:
    """Compile every csrc/*.cu into the shared library; returns nvcc's
    combined output (ptxas resource usage included)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-Xptxas", "-v",
           "-shared", "-Xcompiler", "-fPIC", "-o", tmp, *sources()]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, LIB_PATH)
    return proc.stdout + proc.stderr


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if stale."""
    global _lib
    if _lib is None:
        if stale():
            build()
        _lib = ctypes.CDLL(LIB_PATH)
    return _lib
