"""The import check: no module whose top-level name is JAX's, its
compiler's, Flax's or the JAX package's may be loaded in the process that
prints a result.  Names are compared whole, at the part before the first
dot, so ``svt_av1_tpu_torch`` (the port) passes and ``svt_av1_tpu`` (the
JAX package) does not."""
from __future__ import annotations

from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "svt_av1_tpu")


def forbidden(modules: Iterable[str]) -> List[str]:
    """The loaded module names whose top-level name is forbidden."""
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)
