"""A whole run of the harness on the CPU (the look for a card skipped) at
tiny sizes, sound and with the timed path broken underneath: every fault
the cells can have and the control must turn ``correct`` false."""
import pytest
import torch

from pbench import drive, spec
from pbench.alter import FAULTS
import tiny

SEED = 2 ** 31 + 977


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("bench"))


def _run(root, cell, fault):
    torch.set_num_threads(2)
    return drive.run_cell(spec.resolve(cell, root=root), SEED, 0, False,
                          torch.device("cpu"), fault=fault)


@pytest.mark.parametrize("cell", sorted(tiny.TINY_CELLS))
def test_sound_run_is_correct(root, cell):
    out = _run(root, cell, None)
    r = out["result"]
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    n = out["numbers"]
    assert n["frames_compared"] > 0
    assert (n["missing_frames"], n["decode_errors"], n["mismatch_px"]) == \
        (0, 0, 0)
    assert list(r)[-1] == "check"
    assert set(r["metrics"]) == {"fps", "bpp", "psnr_y_db", "setup_s"}


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", sorted(tiny.TINY_CELLS))
def test_fault_turns_correct_false(root, cell, fault):
    out = _run(root, cell, fault)
    assert not out["result"]["correct"], out["numbers"]
