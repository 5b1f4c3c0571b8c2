"""AVIF stills through the port's Encoder (EncoderConfig(avif=True))
against the JAX package on the CPU.

- One still key frame with the reduced still-picture header
  (still_picture = reduced_still_picture_header = 1: no timing or
  operating points, the frame header's type and show bits implied), at 8
  and at 10 bits: byte-identical to the JAX package's stored stream
  (tests/golden/torch_port_refs.npz), decoded exactly to Packet.recon by
  the port's decoder and by the JAX package's decoder (its stored
  output).
- A second picture raises ValueError, through send_picture or
  send_pictures, as the reference's enc_handle.c rejects it.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import clips
import port_refs
from svt_av1_tpu_torch.api.encoder import Encoder, EncoderConfig
from svt_av1_tpu_torch.codec import obu
from svt_av1_tpu_torch.codec.decoder import Decoder

torch.set_num_threads(2)
FILTERS = dict(enable_dlf_flag=1, cdef_level=1,
               enable_restoration_filtering=1)
CASES = {
    8: lambda: clips.natural_clip(1, 96, 64, seed=11)[0],
    10: lambda: clips.natural_clip10(1, 96, 64, seed=11)[0],
}


def config(cls, bd):
    return cls(source_width=96, source_height=64, qp=30, avif=True,
               encoder_bit_depth=bd, **FILTERS)


def jax_still(bd, frame, port_data):
    """The JAX package's still (its bytes and recon planes) and its
    decoder's planes of the port's still."""
    from svt_av1_tpu.api.config import EncoderConfig as JConfig
    from svt_av1_tpu.api.encoder import Encoder as JEncoder
    from svt_av1_tpu.codec.decoder import Decoder as JDecoder
    enc = JEncoder(config(JConfig, bd))
    enc.send_picture(*frame, eos=True)
    pkt = enc.get_packet()
    (dec,) = JDecoder().decode_temporal_unit(port_data)
    return ((np.frombuffer(pkt.data, np.uint8),)
            + tuple(pkt.recon[k] for k in "yuv")
            + tuple(np.asarray(dec[k]) for k in "yuv"))


def encode(bd, frame, device="cpu"):
    """The port's one packet of the still on ``device``."""
    enc = Encoder(config(EncoderConfig, bd), device=device)
    enc.send_picture(*frame)
    enc.flush()
    (pkt,) = list(iter(enc.get_packet, None))
    return pkt


def stored(bd, frame, data):
    """The JAX package's stored outputs for the still whose port stream is
    ``data``: its bytes, its recon planes, its decoder's planes of
    ``data``; computed live while tools/make_torch_port_refs.py
    records."""
    return port_refs.jax_ref(f"avif_{bd}",
                             lambda: jax_still(bd, frame, data), *frame,
                             np.frombuffer(data, np.uint8))


@functools.lru_cache(maxsize=None)
def still(bd):
    """(the frame, the port's packet, the JAX package's stored outputs)."""
    frame = CASES[bd]()
    pkt = encode(bd, frame)
    return frame, pkt, stored(bd, frame, pkt.data)


@pytest.mark.parametrize("bd", [8, 10])
def test_still_matches_jax(bd):
    _, pkt, ref = still(bd)
    assert pkt.data == bytes(ref[0])
    for k, r in zip("yuv", ref[1:4]):
        assert np.array_equal(pkt.recon[k], r)


@pytest.mark.parametrize("bd", [8, 10])
def test_still_header_and_round_trip(bd):
    """The reduced still-picture header, read back by the port's decoder,
    and both decoders' planes equal to Packet.recon."""
    _, pkt, ref = still(bd)
    types = [t for t, _ in obu.parse_obus(pkt.data)]
    assert types.count(obu.OBU_SEQUENCE_HEADER) == 1
    assert types.count(obu.OBU_FRAME) == 1
    dec = Decoder(device="cpu")
    (rec,) = dec.decode_temporal_unit(pkt.data)
    assert dec.sp.still_picture and dec.sp.reduced_still_picture_header
    assert dec.sp.bit_depth == bd
    assert dec.last_frame_header.frame_type == obu.KEY_FRAME
    want = np.uint8 if bd == 8 else np.uint16
    for k, j in zip("yuv", ref[4:7]):
        assert rec[k].dtype == pkt.recon[k].dtype == want
        assert np.array_equal(rec[k], pkt.recon[k])
        assert np.array_equal(j, pkt.recon[k])
    # the reduced header is the shorter one
    full = dataclasses.replace(dec.sp, still_picture=False,
                               reduced_still_picture_header=False)
    assert (len(obu.write_sequence_header(dec.sp))
            < len(obu.write_sequence_header(full)))


@pytest.mark.parametrize("route", ["send_picture", "send_pictures"])
def test_second_picture_raises(route):
    frame = CASES[8]()
    enc = Encoder(config(EncoderConfig, 8), device="cpu")
    if route == "send_picture":
        enc.send_picture(*frame)
        with pytest.raises(ValueError, match="AVIF"):
            enc.send_picture(*frame)
        assert len(list(iter(enc.get_packet, None))) == 1
    else:
        with pytest.raises(ValueError, match="AVIF"):
            enc.send_pictures([frame, frame])
        assert enc.get_packet() is None
