"""Tests of the benchmark harness.  They import the harness (``pbench``),
its reference decoder (``av1ref``) and the port from the checkout, and
run on the CPU; the ``cuda``-marked ones skip without a card.

    python -m pytest -q -p no:cacheprovider port_bench/tests
"""
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")
