"""Stored outputs of the JAX package for the port's slowest comparisons.

A JAX wave step or batch encode spends seconds compiling before it runs
for milliseconds, and each test file compiles its own.  The comparisons
that need only the JAX package's outputs (not its live behaviour) read
them from tests/golden/torch_port_refs.npz instead; the file also holds a
fingerprint of each comparison's inputs, and a test whose inputs no
longer match fails with a pointer to the script that remakes it:

    JAX_PLATFORMS=cpu python tools/make_torch_port_refs.py

That script runs the same tests with ``recording`` set, so that
``jax_ref`` calls the JAX package live and keeps what it returns.
"""
import functools
import hashlib
import os

import numpy as np

PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                    "torch_port_refs.npz")
# {key: (fingerprint, outputs)} while tools/make_torch_port_refs.py runs
recording = None


def fingerprint(*inputs) -> str:
    """sha1 over the dtype, shape and bytes of every input array."""
    h = hashlib.sha1()
    for a in inputs:
        a = np.ascontiguousarray(np.asarray(a))
        h.update(f"{a.dtype.str}{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


@functools.lru_cache(maxsize=1)
def _stored():
    with np.load(PATH) as z:
        return {k: z[k] for k in z.files}


def jax_ref(key, compute, *inputs):
    """The JAX package's outputs for ``inputs``: ``compute()`` returns
    them as a tuple of arrays.  Read from the stored file (checked against
    the inputs' fingerprint), or computed live while recording."""
    fp = fingerprint(*inputs)
    if recording is not None:
        outs = tuple(np.asarray(o) for o in compute())
        recording[key] = (fp, outs)
        return outs
    z = _stored()
    if f"{key}/inputs" not in z or str(z[f"{key}/inputs"]) != fp:
        raise AssertionError(
            f"{key}: the inputs differ from those of {PATH}; remake it with "
            "JAX_PLATFORMS=cpu python tools/make_torch_port_refs.py")
    return tuple(z[f"{key}/{i}"] for i in range(int(z[f"{key}/n"])))


def save(path=PATH):
    """Write what ``recording`` holds."""
    arrays = {}
    for key, (fp, outs) in sorted(recording.items()):
        arrays[f"{key}/inputs"] = np.array(fp)
        arrays[f"{key}/n"] = np.array(len(outs))
        for i, o in enumerate(outs):
            arrays[f"{key}/{i}"] = o
    np.savez_compressed(path, **arrays)
