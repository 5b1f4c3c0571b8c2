"""The deep GOP shapes of the reference's fast path against the JAX package
on the CPU: hierarchical_levels 4 and 5 (mini-GoPs of 16 and 32 frames)
and intra_period_length -1 (one key frame, then key frames at scene cuts
only).

- levels 4 at 64x64 x17 with keyint -1 and TPL on (a 16-frame IPP chain
  for the key frame, a 16-frame group plus its tail for the mini-GoP);
- levels 5 at 64x64 x33 with keyint -1 (one 32-frame mini-GoP);
- levels 4 at 64x64 x17 with keyint 9: the key frame at poc 10 cuts the
  first mini-GoP to 9 frames, and the flush leaves one of 6.

The clip is ``clips.seam_clip``, whose scene activity stays under the
encoder's threshold for halving the pyramid (the natural clip's noise at
64x64 halves it).  Each stream is byte-identical to the JAX package's
stored stream (tests/golden/torch_port_refs.npz, made by
tools/make_torch_port_refs.py); the port's decoder reproduces every shown
frame; the JAX decoder's stored frames of the JAX stream equal the port's
recon; every inter frame refers to the frames the schedule
(pipeline/gop.py) names, by order hint, and each reference slot holds
that frame's picture when the frame is decoded; each temporal layer
0..levels is coded.
"""
import functools
from collections import Counter

import numpy as np
import pytest
import torch

import clips
import test_torch_gop as tg
from svt_av1_tpu_torch.api.encoder import Encoder, EncoderConfig
from svt_av1_tpu_torch.codec import mv_pred, obu
from svt_av1_tpu_torch.pipeline import gop

torch.set_num_threads(2)
SHAPES = {
    # name: (frames, config fields, preset)
    "levels4_keyint_m1": (lambda: clips.seam_clip(17, back=True),
                          dict(qp=35, intra_period_length=-1,
                               hierarchical_levels=4, enable_tpl_la=1), 10),
    "levels5_keyint_m1": (lambda: clips.seam_clip(33, back=True),
                          dict(qp=35, intra_period_length=-1,
                               hierarchical_levels=5), 10),
    "levels4_keyint9": (lambda: clips.seam_clip(17, back=True),
                        dict(qp=35, intra_period_length=9,
                             hierarchical_levels=4), 10),
}
# (first poc, frames) of every mini-GoP the encoder schedules
MINIGOPS = {"levels4_keyint_m1": [(1, 16)], "levels5_keyint_m1": [(1, 32)],
            "levels4_keyint9": [(1, 9), (11, 6)]}
KEYS = {"levels4_keyint_m1": [0], "levels5_keyint_m1": [0],
        "levels4_keyint9": [0, 10]}


def expected_refs(minigops):
    """{poc: (LAST, ALTREF) display indices} of every coded inter frame
    of the schedule (the ALTREF role holds LAST's frame on a base)."""
    out = {}
    for p0, n in minigops:
        for ev in gop.minigop_schedule(p0 - 1, n):
            if isinstance(ev, gop.CodeEvent):
                out[ev.poc] = (ev.last_poc, ev.bwd_poc if ev.bwd_poc
                               is not None else ev.last_poc)
    return out


def layers_of(minigops):
    """Counter of temporal layer -> coded frames."""
    return Counter(ev.layer for p0, n in minigops
                   for ev in gop.minigop_schedule(p0 - 1, n)
                   if isinstance(ev, gop.CodeEvent))


@functools.lru_cache(maxsize=None)
def _shape(name):
    """(frames, packets, the JAX stream, the mini-GoPs the encoder
    scheduled)."""
    scheduled = []
    orig = Encoder._encode_minigop

    def spy(self, p0, n):
        scheduled.append((p0, n))
        return orig(self, p0, n)

    Encoder._encode_minigop = spy
    try:
        frames, pkts, jax = tg.stream_slice(name, SHAPES[name], decode=True)
    finally:
        Encoder._encode_minigop = orig
    return frames, pkts, jax, scheduled


def decode_and_check_refs(pkts):
    """The port's decoder over the stream: (shown frames, {poc: (LAST,
    ALTREF) order hints}), each reference slot checked against the recon
    of the frame its hint names when the frame is decoded."""
    recon = {p.pts: p.recon for p in pkts if p.displayed}
    dec = tg.Decoder(device="cpu")
    roles = (mv_pred.LAST_FRAME, mv_pred.ALTREF_FRAME)
    refs, shown = {}, []
    for p in pkts:
        slots = list(dec.slots)
        shown += dec.decode_temporal_unit(p.data)
        if (p.frame_type != obu.INTER_FRAME
                or obu.OBU_FRAME not in [t for t, _ in obu.parse_obus(
                    p.data)]):
            continue
        fp = dec.last_frame_header
        refs[p.pts] = tuple(fp.ref_hints[e - 1] for e in roles)
        for e, hint in zip(roles, refs[p.pts]):
            s = slots[fp.ref_frame_idx[e - 1]]
            for k in "yuv":
                np.testing.assert_array_equal(
                    s[k].numpy(), recon[hint][k],
                    err_msg=f"poc {p.pts} ref {e} (poc {hint}) {k}")
    return shown, refs


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_gop_shape_matches_jax(name):
    frames, pkts, jax, scheduled = _shape(name)
    levels = SHAPES[name][1]["hierarchical_levels"]
    identical = [p.data for p in pkts] == jax["data"]
    shown, refs = decode_and_check_refs(pkts)
    disp = [p for p in pkts if p.displayed]
    assert [p.pts for p in disp] == list(range(len(frames)))
    assert len(shown) == len(disp)
    for rec, p in zip(shown, disp):
        for k in "yuv":
            np.testing.assert_array_equal(rec[k], p.recon[k],
                                          err_msg=f"{name} poc {p.pts} {k}")
    jax_rt = all(np.array_equal(j[k], p.recon[k])
                 for j, p in zip(jax["decoded"], disp) for k in "yuv")
    layers = layers_of(scheduled)
    print(f"{name}: mini-GoPs {scheduled}, frames per layer "
          f"{dict(sorted(layers.items()))}, {len(pkts)} packets, "
          f"{sum(len(p.data) for p in pkts)} bytes; byte-identical to the "
          f"JAX stream {identical}; JAX decoder equal {jax_rt}")
    assert identical
    assert jax_rt and len(jax["decoded"]) == len(disp)
    assert scheduled == MINIGOPS[name]
    assert [p.pts for p in pkts if p.frame_type == obu.KEY_FRAME] \
        == KEYS[name]
    assert refs == expected_refs(scheduled)
    if name.endswith("keyint_m1"):
        assert sorted(layers) == list(range(levels + 1))
        assert layers[levels] == 1 << (levels - 1)


def test_keyint_m1_has_no_periodic_key():
    """intra_period_length -1: only poc 0 and scene cuts are key frames
    (no modulo of the period)."""
    enc = Encoder(EncoderConfig(source_width=64, source_height=64,
                                intra_period_length=-1,
                                hierarchical_levels=5), device="cpu")
    enc._h_cuts.add(300)
    assert [p for p in range(400) if enc._is_key_poc(p)] == [0, 300]

