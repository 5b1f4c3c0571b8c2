"""Build and run the port's C ABI: the EbSvtAv1Enc-compatible shim
``capi.c`` (libSvtAv1EncTorch.so, which embeds Python and drives
svt_av1_tpu_torch.api.encoder) and its standalone-layout client
``capi_client.c``.

``build()`` compiles both with ``gcc`` into ``build/capi/`` under the
repository root at first use (again when a source is newer than its
output), taking the include and link flags of the running interpreter's
``python3-config --includes`` / ``--ldflags --embed``; a failed build
raises RuntimeError with the compiler's output.  ``run_client()`` runs
the client on raw I420 frames and returns its IVF output.  The shim
encodes on the CUDA device unless ``SVT_AV1_TORCH_DEVICE`` names another
(``device=`` here sets it for the client's process).
"""
from __future__ import annotations

import os
import subprocess
import sys
import sysconfig

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(_DIR))
SHIM_SRC = os.path.join(_DIR, "capi.c")
CLIENT_SRC = os.path.join(_DIR, "capi_client.c")
HEADER = os.path.join(_DIR, "capi_standalone.h")
BUILD_DIR = os.path.join(REPO, "build", "capi")
LIB = os.path.join(BUILD_DIR, "libSvtAv1EncTorch.so")
CLIENT = os.path.join(BUILD_DIR, "capi_client")
DEVICE_ENV = "SVT_AV1_TORCH_DEVICE"


def _python_config(*flags) -> list:
    """The flags of the running interpreter's python3-config (the one
    beside sys.executable, else the one on PATH)."""
    beside = os.path.join(os.path.dirname(sys.executable), "python3-config")
    exe = beside if os.path.exists(beside) else "python3-config"
    try:
        proc = subprocess.run([exe, *flags], capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"the C ABI shim cannot be built: {e}")
    if proc.returncode != 0:
        raise RuntimeError(f"{exe} {' '.join(flags)} -> {proc.returncode}\n"
                           f"{proc.stdout}{proc.stderr}")
    return proc.stdout.split()


def _stale(out, *srcs) -> bool:
    return not os.path.exists(out) or any(
        os.path.getmtime(out) < os.path.getmtime(s) for s in srcs)


def _compile(cmd, out):
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [tmp if c == out else c for c in cmd]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"the C ABI shim cannot be built: {e}")
    if proc.returncode != 0:
        raise RuntimeError(f"the C ABI shim did not build: {' '.join(cmd)} "
                           f"-> {proc.returncode}\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, out)


def build() -> tuple:
    """(shim library, client executable), built first where missing or
    stale."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    if _stale(LIB, SHIM_SRC, HEADER):
        libdir = sysconfig.get_config_var("LIBDIR") or ""
        _compile(["gcc", "-shared", "-fPIC", "-O2",
                  *_python_config("--includes"), SHIM_SRC, "-o", LIB,
                  *_python_config("--ldflags", "--embed"),
                  f"-Wl,-rpath,{libdir}"], LIB)
    if _stale(CLIENT, CLIENT_SRC, HEADER, LIB):
        _compile(["gcc", "-O2", f"-I{_DIR}", CLIENT_SRC, "-o", CLIENT,
                  f"-L{BUILD_DIR}", "-lSvtAv1EncTorch",
                  f"-Wl,-rpath,{BUILD_DIR}"], CLIENT)
    return LIB, CLIENT


def run_client(frames, out_path, preset=10, qp=35, keyint=-2, levels=0,
               device=None, timeout=600):
    """Encode 8-bit 4:2:0 ``frames`` [(y, u, v)] through the C client;
    ``device`` sets SVT_AV1_TORCH_DEVICE (None: unset, the CUDA device).
    Returns the finished process; its IVF is at ``out_path``."""
    _, client = build()
    h, w = frames[0][0].shape
    raw = f"{out_path}.yuv"
    with open(raw, "wb") as f:
        for plane in (p for fr in frames for p in fr):
            f.write(np.ascontiguousarray(plane, np.uint8).tobytes())
    env = dict(os.environ)
    env.pop(DEVICE_ENV, None)
    if device is not None:
        env[DEVICE_ENV] = str(device)
    # the embedded interpreter finds this repository and the running
    # interpreter's packages (torch, numpy) through PYTHONPATH
    env["PYTHONPATH"] = os.pathsep.join([REPO] + [p for p in sys.path if p])
    try:
        return subprocess.run(
            [client, raw, out_path, str(w), str(h), str(preset), str(qp),
             str(keyint), str(levels)], env=env, capture_output=True,
            text=True, timeout=timeout)
    finally:
        os.remove(raw)
