"""The native (C) range coder and coefficient loop, ``ec_native.c``.

``get_ec()`` returns the compiled CPython extension, building it with the
system C compiler (``cc``) at first use into ``build/native/`` under the
repository root; it is rebuilt when the source is newer than the library.
A failed build raises with the compiler's output: the port has no
pure-Python fallback for its entropy coder.
"""
from __future__ import annotations

import importlib.util
import os
import subprocess
import sysconfig

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_DIR, "ec_native.c")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                         "native")
SO = os.path.join(BUILD_DIR, "ec_native.so")

_mod = None


def build() -> None:
    """Compile ec_native.c into SO; raises RuntimeError with the
    compiler's output on failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{SO}.{os.getpid()}.tmp"
    inc = sysconfig.get_paths()["include"]
    cmd = ["cc", "-O2", "-shared", "-fPIC", f"-I{inc}", SRC, "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"the native range coder cannot be built: {e}")
    if proc.returncode != 0:
        raise RuntimeError(f"the native range coder did not build: "
                           f"{' '.join(cmd)} -> {proc.returncode}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, SO)


def get_ec():
    """The loaded ec_native module, built first if missing or stale."""
    global _mod
    if _mod is None:
        if not os.path.exists(SO) or (os.path.getmtime(SO)
                                      < os.path.getmtime(SRC)):
            build()
        spec = importlib.util.spec_from_file_location("ec_native", SO)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _mod = mod
    return _mod
