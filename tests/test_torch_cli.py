"""The port's command-line app (svt_av1_tpu_torch/app/cli.py) against the
JAX package's (svt_av1_tpu/app/cli.py) on the CPU: the same y4m files and
arguments give byte-identical IVF files.

Cases (CASES):
- ``roundtrip``: the reference's tests/test_cli.py (64x48 x2, CRF 40);
- ``multichannel``: tests/test_sframe_multichannel.py::
  test_multichannel_cli (two 96x64 x3 channels, one IVF each);
- ``tenbit``: a 10-bit y4m (C420p10) all-intra at 64x64 x2;
- ``gop_levels4``: a small hierarchical GOP through --svtav1-params
  (levels 4, keyint -1, M12, TPL on: a 9-frame clip, the key frame and
  an 8-frame mini-GoP at the end of the input).

The JAX CLI's IVF files are stored in tests/golden/torch_port_refs.npz
(fingerprinted by the y4m bytes and the arguments; remade by
tools/make_torch_port_refs.py).  Every IVF decodes through the port's
decoder to frames of the input's size, one per input frame.
"""
import functools
import os
import tempfile

import numpy as np
import pytest
import torch

import clips
import port_refs
from svt_av1_tpu_torch.app import cli
from svt_av1_tpu_torch.codec.decoder import Decoder
from svt_av1_tpu_torch.utils.ivf import read_ivf
from svt_av1_tpu_torch.utils.y4m import Frame, write_y4m

torch.set_num_threads(2)


def synth_frame(w, h, seed=0):
    """The frames of the reference's tests/test_cli.py
    (tests/test_e2e_intra.py synth_frame)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    y = (96 + 60 * np.sin(xx / 17.0) + 50 * np.cos(yy / 23.0)
         + rng.integers(-6, 7, (h, w)))
    y[h // 3:h // 2, :] = 200
    y[:, w // 4:w // 4 + 6] = 30
    y = np.clip(y, 0, 255).astype(np.uint8)
    u = np.clip(128 + 40 * np.sin(xx[::2, ::2] / 31.0), 0, 255).astype(
        np.uint8)
    v = np.clip(128 + 40 * np.cos(yy[::2, ::2] / 29.0), 0, 255).astype(
        np.uint8)
    return y, u, v


def multichannel_frames(n, h=64, w=96):
    """The frames of tests/test_sframe_multichannel.py::_frames."""
    yy, xx = np.mgrid[0:h, 0:w]
    u = np.full((h // 2, w // 2), 120, np.uint8)
    v = np.full((h // 2, w // 2), 130, np.uint8)
    return [(np.clip(120 + 50 * np.sin(xx / 11.0 + t * 0.3)
                     + 30 * np.cos(yy / 9.0), 0, 255).astype(np.uint8), u, v)
            for t in range(n)]


# name: (channels: a list of (frames, bit depth), arguments after -i / -b)
CASES = {
    "roundtrip": (lambda: [([synth_frame(64, 48, seed=i) for i in range(2)],
                            8)],
                  ["--crf", "40"]),
    "multichannel": (lambda: [(multichannel_frames(3), 8)] * 2,
                     ["--crf", "40"]),
    "tenbit": (lambda: [(clips.natural_clip10(2, 64, 64, seed=3), 10)],
               ["--crf", "35"]),
    "gop_levels4": (lambda: [(clips.seam_clip(9, back=True), 8)],
                    ["--preset", "12", "--crf", "35", "--keyint", "-1",
                     "--svtav1-params",
                     "hierarchical-levels=4:enable-tpl-la=1"]),
}


def write_inputs(name, folder):
    """The case's y4m files in ``folder``: (argv, IVF paths, y4m bytes)."""
    channels, args = CASES[name][0](), CASES[name][1]
    argv, outs, raw = [], [], []
    for i, (frames, bd) in enumerate(channels):
        src = os.path.join(folder, f"in{i}.y4m")
        write_y4m(src, [Frame(*f, bit_depth=bd) for f in frames],
                  bit_depth=bd)
        with open(src, "rb") as f:
            raw.append(f.read())
        outs.append(os.path.join(folder, f"out{i}.ivf"))
        argv += ["-i", src]
    for out in outs:
        argv += ["-b", out]
    return argv + args + ["--progress", "0"], outs, raw


def run(main, name, folder, **kw):
    """The IVF files' bytes of ``main`` (either package's cli.main) on the
    case."""
    argv, outs, _ = write_inputs(name, folder)
    assert main(argv, **kw) == 0
    data = []
    for out in outs:
        with open(out, "rb") as f:
            data.append(f.read())
    return data


def stored(name):
    """The JAX CLI's IVF files of the case (computed live while
    tools/make_torch_port_refs.py records)."""
    with tempfile.TemporaryDirectory() as folder:
        _, _, raw = write_inputs(name, folder)

        def jax_ivfs():
            from svt_av1_tpu.app import cli as jcli
            with tempfile.TemporaryDirectory() as f2:
                return [np.frombuffer(d, np.uint8)
                        for d in run(jcli.main, name, f2)]

        ref = port_refs.jax_ref(f"cli_{name}", jax_ivfs,
                                *[np.frombuffer(r, np.uint8) for r in raw],
                                np.array(CASES[name][1]))
    return [bytes(a) for a in ref]


@functools.lru_cache(maxsize=None)
def run_case(name):
    """(the port CLI's IVF files on the CPU, the JAX CLI's stored ones)."""
    with tempfile.TemporaryDirectory() as folder:
        return run(cli.main, name, folder, device="cpu"), stored(name)


@pytest.mark.parametrize("name", sorted(CASES))
def test_ivf_matches_jax_cli(name):
    port, jax = run_case(name)
    print(f"{name}: {[len(d) for d in port]} bytes; identical to the JAX "
          f"CLI's {port == jax}")
    assert port == jax


@pytest.mark.parametrize("name", sorted(CASES))
def test_ivf_decodes(name, tmp_path):
    """Every channel's IVF names AV01 and the input's size and decodes
    through the port's decoder to one frame of that size per input
    frame."""
    port, _ = run_case(name)
    channels = CASES[name][0]()
    for (frames, bd), data in zip(channels, port):
        path = tmp_path / "x.ivf"
        path.write_bytes(data)
        hdr, pkts = read_ivf(str(path))
        h, w = frames[0][0].shape
        assert hdr["fourcc"] == b"AV01"
        assert (hdr["width"], hdr["height"]) == (w, h)
        dec = Decoder(device="cpu")
        shown = [r for _, d in pkts for r in dec.decode_temporal_unit(d)]
        assert len(shown) == len(frames)
        assert all(r["y"].shape == (h, w) for r in shown)
        assert shown[0]["y"].dtype == (np.uint16 if bd > 8 else np.uint8)


def test_cli_prints_fps_and_psnr(tmp_path, capsys):
    argv, _, _ = write_inputs("roundtrip", str(tmp_path))
    assert cli.main(argv, device="cpu") == 0
    err = capsys.readouterr().err.strip().splitlines()[-1]
    assert err.startswith("Encoded 2 frames in ") and "fps), mean Y-PSNR" \
        in err, err


def test_channel_count_mismatch(tmp_path, capsys):
    assert cli.main(["-i", "a.y4m", "-i", "b.y4m", "-b", "a.ivf"],
                    device="cpu") == 1
    assert "channel count mismatch" in capsys.readouterr().err
