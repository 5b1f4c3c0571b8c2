#!/usr/bin/env python3
"""Remake tests/golden/torch_port_refs.npz, the JAX package's outputs that
the port's slowest comparisons are held to (see tests/port_refs.py).

    JAX_PLATFORMS=cpu python tools/make_torch_port_refs.py

Runs those tests in this process with ``port_refs.recording`` set, so that
each comparison computes the JAX package's outputs live (and still checks
the port against them), then writes every recorded output with the
fingerprint of its inputs.  Exits non-zero, writing nothing, if a test
fails.
"""
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = (
    "tests/test_torch_intra_encoder.py::test_rd_step_wave_matches_jax",
    "tests/test_torch_intra_encoder.py::test_rd_step_chroma_wave_matches_jax",
    "tests/test_torch_intra_tools.py::"
    "test_luma_wave_62_candidates_matches_jax",
    "tests/test_torch_intra_tools.py::"
    "test_luma_wave_palette_override_matches_jax",
    "tests/test_torch_intra_tools.py::test_chroma_wave_cfl_matches_jax",
    "tests/test_torch_key_frame.py::test_send_pictures_m6_matches_jax",
)


def main():
    os.chdir(REPO)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import port_refs
    port_refs.recording = {}
    rc = pytest.main(["-q", "-p", "no:cacheprovider", "-p", "no:randomly",
                      *TESTS])
    if rc != 0:
        print("make_torch_port_refs: a test failed; nothing written",
              file=sys.stderr)
        return 1
    port_refs.save()
    print(f"wrote {len(port_refs.recording)} references to {port_refs.PATH}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
