"""The port's EbSvtAv1Enc-compatible C ABI (svt_av1_tpu_torch/native/
capi.c) and its standalone-layout client (native/capi_client.c): both
build with gcc into build/capi/, and the client's stream, encoded on the
CPU through the embedded interpreter (SVT_AV1_TORCH_DEVICE=cpu), equals
the JAX package's stream of the same frames and settings byte for byte,
as does the port's Python API's (the JAX stream is stored in
tests/golden/torch_port_refs.npz; tools/make_torch_port_refs.py remakes
it).  With the variable unset the shim encodes on the CUDA device, so
without CUDA svt_av1_enc_init returns an error and the client stops
there.
"""
import functools

import numpy as np
import pytest
import torch

import clips
import port_refs
from svt_av1_tpu_torch.api.encoder import Encoder, EncoderConfig
from svt_av1_tpu_torch.native import capi
from svt_av1_tpu_torch.utils.ivf import read_ivf

torch.set_num_threads(2)
# (frames, preset, qp, intra_period_length, hierarchical_levels): a
# key frame and a 2-frame mini-GoP with the default lookahead
CASE = (lambda: clips.natural_clip(3, 64, 64, seed=2), 12, 40, -1, 1)


def _api_stream(encoder, config, frames, preset, qp, keyint, levels,
                **kw):
    """The packets' bytes of an Encoder class under the shim's settings
    (its defaults: 60 fps, CRF, 8 bits, one tile)."""
    h, w = frames[0][0].shape
    enc = encoder(config(
        source_width=w, source_height=h, qp=qp, enc_mode=preset,
        intra_period_length=keyint, hierarchical_levels=levels,
        frame_rate_numerator=60, frame_rate_denominator=1), **kw)
    for f in frames:
        enc.send_picture(*f)
    enc.flush()
    return [p.data for p in iter(enc.get_packet, None)]


def python_api_stream(frames, preset, qp, keyint, levels, device="cpu"):
    """The port's Python API's packets on ``device``."""
    return _api_stream(Encoder, EncoderConfig, frames, preset, qp, keyint,
                       levels, device=device)


def jax_stream(frames, preset, qp, keyint, levels):
    """The JAX package's packets of the same frames and settings (stored,
    fingerprinted by the frames and the settings)."""
    def compute():
        from svt_av1_tpu.api.config import EncoderConfig as JConfig
        from svt_av1_tpu.api.encoder import Encoder as JEncoder
        datas = _api_stream(JEncoder, JConfig, frames, preset, qp, keyint,
                            levels)
        return [np.frombuffer(d, np.uint8) for d in datas]
    ref = port_refs.jax_ref("capi_stream", compute,
                            *[a for f in frames for a in f],
                            np.array([preset, qp, keyint, levels]))
    return [bytes(a) for a in ref]


@functools.lru_cache(maxsize=None)
def _case():
    """(frames, the JAX package's stream, the Python API's stream on the
    CPU) of CASE."""
    frames = CASE[0]()
    return (frames, jax_stream(frames, *CASE[1:]),
            python_api_stream(frames, *CASE[1:]))


def test_python_api_stream_equals_jax():
    _, want, got = _case()
    print(f"Python API: {len(got)} packets, {sum(map(len, got))} bytes; "
          f"identical to the JAX package's {got == want}")
    assert got == want


def test_client_stream_equals_python_api(tmp_path, monkeypatch):
    """The client's stream equals the Python API's and the JAX
    package's."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")   # the client's torch
    frames, want, api = _case()
    out = str(tmp_path / "capi.ivf")
    proc = capi.run_client(frames, out, *CASE[1:], device="cpu")
    assert proc.returncode == 0, (proc.stdout, proc.stderr)
    assert "CAPI OK" in proc.stdout
    hdr, pkts = read_ivf(out)
    assert (hdr["width"], hdr["height"]) == (64, 64)
    assert hdr["frame_count"] == len(pkts)
    got = [d for _, d in pkts]
    print(f"C ABI: {len(got)} packets, {sum(map(len, got))} bytes; "
          f"identical to the Python API's {got == api}, to the JAX "
          f"package's {got == want}")
    assert got == api
    assert got == want


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the shim without CUDA")
def test_init_without_cuda_returns_an_error(tmp_path, monkeypatch):
    """No device named and no CUDA: svt_av1_enc_init fails (the client's
    exit code 3), naming device="cpu" on stderr; no fallback."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    proc = capi.run_client(clips.natural_clip(1, 64, 64), str(tmp_path /
                                                             "x.ivf"))
    assert proc.returncode == 3, (proc.stdout, proc.stderr)
    assert 'device="cpu"' in proc.stderr
    assert "CAPI OK" not in proc.stdout


def test_build_raises_with_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "capi.c"
    bad.write_text("this is not C\n")
    monkeypatch.setattr(capi, "SHIM_SRC", str(bad))
    monkeypatch.setattr(capi, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(capi, "LIB", str(tmp_path / "build" / "lib.so"))
    with pytest.raises(RuntimeError, match="did not build") as e:
        capi.build()
    assert "error" in str(e.value)
