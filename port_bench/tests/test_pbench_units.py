"""The window's arithmetic, K1's bytes, the import check and the trace
reduction, on made-up records."""
import math
from types import SimpleNamespace

import numpy as np
import pytest

from pbench import check, isolation, peaks, trace, window
from pbench.window import Emit


def _pkt(y):
    return SimpleNamespace(data=b"", recon=dict(y=y))


def test_window_closes_at_the_first_burst_after_the_deadline():
    ts = [1.0, 1.0, 2.5, 2.5, 2.5, 4.0, 4.0]
    emits = [Emit(t, 0, i, 10, True, False) for i, t in enumerate(ts)]
    assert window.close(emits, 0.0, 2.0) == (5, 2.5)
    assert window.close(emits, 0.0, 2.5) == (5, 2.5)
    assert window.close(emits, 0.0, 0.0) == (2, 1.0)
    assert window.close(emits, 0.0, 4.5) is None


def test_fps_bpp_and_psnr_on_made_up_packets():
    w, h = 8, 4
    src = np.full((h, w), 100, np.uint8)
    r1 = src.copy()
    r1[0, :4] = 104                        # SSE 4 * 16 = 64
    r2 = src.copy()                        # SSE 0
    emits = [Emit(2.0, 0, 0, 100, True, True, _pkt(r1)),
             Emit(2.0, 0, 2, 50, False, False, _pkt(None)),   # hidden
             Emit(4.0, 0, 1, 30, True, False, _pkt(r2))]
    m = window.metrics(emits, 0.0, 4.0, w, h, lambda s, p: src)
    assert m["frames"] == 2 and m["bytes"] == 180
    assert m["fps"] == pytest.approx(0.5)
    assert m["bpp"] == pytest.approx(8 * 180 / (2 * w * h))
    assert m["psnr_y_db"] == pytest.approx(
        10 * math.log10(255 ** 2 / (64 / (2 * w * h))))


def test_missing_frames_counts_lost_duplicate_unexpected_and_bare():
    y = np.zeros((2, 2), np.uint8)
    sent = {0: [0, 1, 2, 3]}
    emits = [Emit(0, 0, 0, 1, True, True, _pkt(y)),
             Emit(0, 0, 1, 1, True, False, _pkt(y)),
             Emit(0, 0, 1, 1, True, False, _pkt(y)),    # duplicate
             Emit(0, 0, 9, 1, True, False, _pkt(y)),    # never sent
             Emit(0, 0, 2, 1, True, False, SimpleNamespace(recon=None))]
    # frame 3 lost, one duplicate, one unexpected, one without recon
    assert check.missing_frames(sent, emits) == 4


def test_decode_runs_start_at_the_last_key_frame():
    keys = [True, False, False, True, False, True]
    emits = [Emit(0, 0, i, 1, True, k) for i, k in enumerate(keys)]
    emits += [Emit(0, 1, 0, 1, True, True), Emit(0, 1, 1, 1, True, False)]
    assert check._decode_runs(emits, [2]) == [(0, 2)]
    assert check._decode_runs(emits, [1, 4]) == [(0, 1), (3, 4)]
    assert check._decode_runs(emits, [2, 3, 7]) == [(0, 2), (3, 3), (6, 7)]
    assert check._decode_runs(emits, [1, 2]) == [(0, 2)]
    assert check.sample(emits, 0, 5) == list(range(8))
    pick = check.sample(emits, 3, 5)
    assert pick == check.sample(emits, 3, 5) and len(set(pick)) == 3


@pytest.mark.parametrize("batch,nbytes", [(66, 272_424), (360, 1_476_648),
                                          (2112, 8_652_840)])
def test_k1_bytes_match_the_kernel_table(batch, nbytes):
    assert peaks.k1_bytes(batch) == nbytes
    assert peaks.k1_bound_s(batch) == pytest.approx(nbytes / 3.35e12)


@pytest.mark.parametrize("name,bad", [
    ("svt_av1_tpu_torch", False), ("svt_av1_tpu_torch.ops.quant", False),
    ("av1ref.codec.decoder", False), ("jaxtyping", False),
    ("svt_av1_tpu", True), ("svt_av1_tpu.api.encoder", True),
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True),
    ("flax.linen", True)])
def test_import_check_compares_whole_top_level_names(name, bad):
    assert isolation.forbidden([name]) == ([name] if bad else [])


class _Ev:
    def __init__(self, name, dev, s, e, ann=False):
        from torch.autograd import DeviceType
        self._n, self._s, self._e, self._a = name, s, e, ann
        self._d = DeviceType.CUDA if dev else DeviceType.CPU

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def is_user_annotation(self):
        return self._a


def test_trace_reduction_takes_the_union_and_labels_the_gaps():
    ms = 1_000_000
    host = [(0, 60 * ms, "bench.send_pictures"),
            (60 * ms, 100 * ms, "bench.get_packet")]
    events = [
        _Ev("p1.pass_b", False, 20 * ms, 40 * ms, True),
        _Ev("p9.other", False, 20 * ms, 40 * ms, True),    # not a prefix
        _Ev("aten::add", False, 1 * ms, 2 * ms),          # not a range
        _Ev("k_a", True, 10 * ms, 20 * ms),
        _Ev("k_a", True, 15 * ms, 25 * ms),                # overlaps
        _Ev("fused_txq16_kernel<false>", True, 50 * ms, 55 * ms),
        _Ev("Memcpy DtoH", True, 70 * ms, 80 * ms),
        _Ev("Memcpy DtoH", True, 95 * ms, 130 * ms),       # past the end
        _Ev("bench.x", True, 0, 100 * ms, True),           # gpu range
    ]
    r = trace.reduce_events(events, (0, 100 * ms), host)
    assert r["window_s"] == pytest.approx(0.1)
    assert r["busy_s"] == pytest.approx(0.035)   # 15 + 5 + 10 + 5 ms
    assert r["launches"] == 3
    assert r["kernels"]["k_a"] == [2, pytest.approx(0.020)]
    gaps = dict(r["gaps"])
    # a gap goes to the innermost range open at its middle: 0-10 ms to
    # send_pictures, 25-50 ms to pass B (37.5 ms), 55-70 ms (62.5 ms) and
    # 80-95 ms to get_packet
    assert gaps == pytest.approx({"bench.send_pictures": 0.010,
                                  "p1.pass_b": 0.025,
                                  "bench.get_packet": 0.030})
    assert trace.reduce_events(events[:3], (0, 100 * ms), host) is None


def test_mean_shift_pools_every_shown_key_frame_and_takes_its_size():
    src = np.full((4, 8), 100, np.uint8)
    lo = src - np.uint8(1)                 # a shift of -1 over a frame
    hi = src.copy()
    hi[:2] += 1                            # +0.5 over the next
    emits = [Emit(0, 0, 0, 1, True, True, _pkt(lo)),
             Emit(0, 0, 1, 1, True, True, _pkt(hi)),
             Emit(0, 0, 2, 1, False, True, _pkt(None)),    # hidden
             Emit(0, 0, 3, 1, True, False, _pkt(lo + 9))]  # inter
    assert check.mean_shift(emits, lambda s, p: src) == pytest.approx(0.25)
    assert check.mean_shift(emits[1:2], lambda s, p: src) == \
        pytest.approx(0.5)
    assert check.mean_shift(emits[2:], lambda s, p: src) == 0.0
