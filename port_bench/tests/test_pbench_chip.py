"""On the card: a traced run of a tiny cell gives every per-layer reading
its cell lists, a busy device, a breakdown, and loads nothing of JAX.

    python -m pytest -q -p no:cacheprovider port_bench/tests -m cuda
"""
import sys

import pytest
import torch

from pbench import drive, isolation, spec
import tiny


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the traced run needs the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(tiny.TINY_CELLS))
def test_traced_tiny_run_on_the_card(card, cell, tmp_path):
    root = tiny.make(tmp_path)
    c = spec.resolve(cell, root=root)
    out = drive.run_cell(c, 12345, 0, True, card)
    r = out["result"]
    assert r["correct"], r["check"]
    assert r["device"]["busy_s"] > 0
    assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
    assert {"launches_per_frame", "device_idle_pct",
            "host_ec_ms_per_frame"} <= set(r["metrics"])
    assert len(r["breakdown"]["device_ops"]) <= 10
    assert isolation.forbidden(sys.modules) == []
