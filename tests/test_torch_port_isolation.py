"""The port stands alone: it imports nothing of the JAX package, its
copies of the reference's host modules and data files have not drifted
from their sources, and its entry points run on the card unless asked
for the CPU.

The copies are the reference's numpy/C host side (OBU syntax, CDFs, the
range coder, rate control, presets, configuration) and its data files,
kept verbatim in svt_av1_tpu_torch/ with the package name rewritten.
"""
import ast
import filecmp
import importlib
import importlib.util
import os
import re

import numpy as np
import pytest
import torch

import golden_defs
from svt_av1_tpu_torch import device as device_mod
from svt_av1_tpu_torch import goldens, native
from svt_av1_tpu_torch.api.encoder import Encoder, EncoderConfig
from svt_av1_tpu_torch.codec import rate_est
from svt_av1_tpu_torch.codec.decoder import Decoder
from svt_av1_tpu_torch.ops import fused_txq, quant
from svt_av1_tpu_torch.pipeline import intra_encoder as tie

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(REPO, "svt_av1_tpu")
PORT = os.path.join(REPO, "svt_av1_tpu_torch")

# host modules copied verbatim (package name rewritten)
HOST_COPIES = (
    "codec/constants.py", "codec/tables.py", "codec/cdf.py",
    "codec/entropy.py", "codec/coeff.py", "codec/mv.py", "codec/mv_pred.py",
    "codec/segmentation.py", "codec/subexp.py", "codec/palette.py",
    "codec/lr.py", "codec/film_grain.py", "codec/syntax.py",
    "codec/fast_ec.py", "codec/obu.py", "utils/bitio.py",
    "utils/profiling.py", "api/config.py", "pipeline/presets.py",
    "pipeline/rate_control.py", "pipeline/rc_onepass.py",
    "native/ec_native.c", "ops/wedge.py", "ops/obmc.py",
    "ops/interintra.py", "pipeline/gop.py", "pipeline/noise_model.py",
    "utils/metrics.py")
DATA_FILES = (
    "av1_default_cdfs", "av1_intra_tables", "av1_inv_txfm_programs",
    "av1_quant_tables", "av1_scan_tables", "md_rate_fit",
    "md_rate_fit_adapted", "av1_sgr_tables", "av1_gaussian_sequence",
    "av1_interp_filters", "av1_warp_filters", "av1_resize_filters")
# the numpy half of codec/rate_est.py, copied by name
RATE_EST_NAMES = (
    "MAX_LEVEL", "_sym_bits", "_R_GRID", "_R_WEIGHTS", "_avg_bits",
    "_fitted", "_fitted_adapted", "rdoq_tables_for_qindex",
    "_eob_table_from_cls", "_analytic_eob_table", "_level_curve",
    "true_tables_for_qindex", "tables_for_qindex")
GOLDEN_NAMES = ("INTRA_SIZES", "legal_tx_types", "inv_txfm_input",
                "inv_txfm_cases", "intra_input")
# the numpy functions of pipeline/tpl.py and ops/satd.py, copied by name
TPL_NAMES = ("BLK", "synthesize", "r0_of", "beta_qmap")
SATD_NAMES = ("_h8",)
# the host geometry and the Wiener solve of pipeline/lr_stage.py, the
# plan and scale helpers of ops/resize.py and the AQ maps of
# api/encoder.py, copied by name
LR_NAMES = ("STRIPE", "OFFSET", "CTX_VERT", "BORDER", "save_boundaries",
            "_stripe_chunks", "_unit_ranges", "_v_ranges", "_wiener_stats",
            "_solve_wiener")
RESIZE_NAMES = ("scaled_width", "upscale_step_x0", "_upscale_plan",
                "_filters")
AQ_NAMES = ("_variance_qmap", "_segment_qmap")

_PKG_NAME = re.compile(r"\bsvt_av1_tpu\b")


def _port_sources():
    out = []
    for root, _, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _jax_package_imports(path):
    """(line, module) of every import of svt_av1_tpu or svt_av1_tpu.*."""
    tree = ast.parse(open(path).read(), filename=path)
    hits = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        hits += [(node.lineno, n) for n in names
                 if n == "svt_av1_tpu" or n.startswith("svt_av1_tpu.")]
    return hits


def test_no_import_of_the_jax_package():
    files = _port_sources() + [
        os.path.join(REPO, "chip_smoke.py"),
        os.path.join(REPO, "tests", "test_torch_cuda.py"),
        os.path.join(REPO, "tests", "clips.py"),
        os.path.join(REPO, "tests", "tie_rule.py"),
        os.path.join(REPO, "tools", "profile_torch_encode.py")]
    scanned = {os.path.relpath(f, PORT) for f in files}
    assert {"pipeline/intra_encoder.py", "ops/intra.py", "api/encoder.py",
            "codec/decoder.py", "convert.py", "codec/palette.py",
            "ops/dlf.py", "ops/cdef.py", "pipeline/dlf_stage.py",
            "pipeline/cdef_stage.py", "utils/kernel_profile.py",
            "ops/me.py", "ops/convolve.py", "ops/mc.py", "ops/warp.py",
            "pipeline/me.py", "pipeline/gop_fast.py",
            "pipeline/inter_encoder.py", "ops/satd.py", "ops/tf.py",
            "pipeline/tf_stage.py", "pipeline/tpl.py", "ops/resize.py",
            "ops/restoration.py", "pipeline/lr_stage.py",
            "pipeline/noise_model.py", "utils/metrics.py"} <= scanned
    bad = [f"{os.path.relpath(f, REPO)}:{line}: {mod}" for f in files
           for line, mod in _jax_package_imports(f)]
    assert len(files) > 30
    assert not bad, "imports of the JAX package:\n" + "\n".join(bad)


def test_port_imports_resolve():
    """Every import of a port module, lazy ones included, names a module
    or an attribute that exists in the port."""
    missing = []
    for path in _port_sources():
        for node in ast.walk(ast.parse(open(path).read())):
            if isinstance(node, ast.ImportFrom) and node.level == 0 and (
                    node.module or "").startswith("svt_av1_tpu_torch"):
                mod = importlib.import_module(node.module)
                for a in node.names:
                    if not (hasattr(mod, a.name) or importlib.util.find_spec(
                            f"{node.module}.{a.name}")):
                        missing.append(f"{path}:{node.lineno} "
                                       f"{node.module}.{a.name}")
            elif isinstance(node, ast.Import):
                for a in node.names:
                    if (a.name.startswith("svt_av1_tpu_torch")
                            and importlib.util.find_spec(a.name) is None):
                        missing.append(f"{path}:{node.lineno} {a.name}")
    assert not missing, "\n".join(missing)


def _first_difference(got, ref):
    for k, (a, b) in enumerate(zip(got, ref)):
        if a != b:
            return f"line {k + 1}: {a!r} != {b!r}"
    return f"lengths differ: {len(got)} vs {len(ref)} lines"


@pytest.mark.parametrize("rel", HOST_COPIES)
def test_host_copy_matches_source(rel):
    src = open(os.path.join(JAX_PKG, rel)).read()
    got = open(os.path.join(PORT, rel)).read().splitlines()
    ref = _PKG_NAME.sub("svt_av1_tpu_torch", src).splitlines()
    assert got == ref, f"{rel} drifted from svt_av1_tpu/{rel}: " \
        + _first_difference(got, ref)


@pytest.mark.parametrize("name", DATA_FILES)
def test_data_file_identical(name):
    rel = os.path.join("codec", "data", f"{name}.npz")
    assert filecmp.cmp(os.path.join(PORT, rel), os.path.join(JAX_PKG, rel),
                       shallow=False), f"{rel} differs from its source"


def _top_level_sources(path, names):
    """{name: source text} of top-level functions and assignments."""
    text = open(path).read()
    out = {}
    for node in ast.parse(text).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            keys = [node.name]
        elif isinstance(node, ast.Assign):
            keys = [t.id for t in node.targets if isinstance(t, ast.Name)]
        elif isinstance(node, ast.AnnAssign):
            keys = [node.target.id]
        else:
            continue
        for k in keys:
            if k in names:
                seg = ast.get_source_segment(text, node, padded=True)
                lines = seg.splitlines()
                if getattr(node, "decorator_list", None):
                    lines = [ast.get_source_segment(text, d)
                             for d in node.decorator_list] + lines
                out[k] = [ln for ln in lines
                          if not ln.strip().startswith(("from ", "import "))]
    return out


@pytest.mark.parametrize("path,ref,names", [
    ("svt_av1_tpu_torch/codec/rate_est.py", "svt_av1_tpu/codec/rate_est.py",
     RATE_EST_NAMES),
    ("svt_av1_tpu_torch/goldens.py", "tests/golden_defs.py", GOLDEN_NAMES),
    ("svt_av1_tpu_torch/pipeline/tpl.py", "svt_av1_tpu/pipeline/tpl.py",
     TPL_NAMES),
    ("svt_av1_tpu_torch/ops/satd.py", "svt_av1_tpu/ops/satd.py",
     SATD_NAMES),
    ("svt_av1_tpu_torch/pipeline/lr_stage.py",
     "svt_av1_tpu/pipeline/lr_stage.py", LR_NAMES),
    ("svt_av1_tpu_torch/ops/resize.py", "svt_av1_tpu/ops/resize.py",
     RESIZE_NAMES),
    ("svt_av1_tpu_torch/api/encoder.py", "svt_av1_tpu/api/encoder.py",
     AQ_NAMES)])
def test_copied_definitions_match_source(path, ref, names):
    """Definitions copied one by one (the numpy half of rate_est.py, the
    golden input generators, TPL's synthesizer and beta map, the SATD
    butterfly matrix, the restoration geometry and Wiener solve, the
    superres plan, the AQ maps) equal their sources, import lines
    aside."""
    got = _top_level_sources(os.path.join(REPO, path), names)
    want = _top_level_sources(os.path.join(REPO, ref), names)
    assert set(got) == set(want) == set(names)
    for k in names:
        assert got[k] == want[k], f"{path}: {k} drifted from {ref}: " \
            + _first_difference(got[k], want[k])
    if path.endswith("goldens.py"):
        assert goldens.GOLDEN_DIR == golden_defs.GOLDEN_DIR


def _frames(n, w, h):
    y = np.full((h, w), 100, np.uint8)
    u = np.full((h // 2, w // 2), 128, np.uint8)
    return [(y, u, u)] * n


ENTRY_POINTS = {
    "Encoder": lambda: Encoder(EncoderConfig(source_width=32,
                                             source_height=32)),
    "Decoder": lambda: Decoder(),
    "encode_intra_frames_launch": lambda: tie.encode_intra_frames_launch(
        _frames(1, 32, 32), 140),
    "reconstruct_from_decisions": lambda: tie.reconstruct_from_decisions(
        {}, 32, 32, 140),
    "send_picture": lambda: Encoder(
        EncoderConfig(source_width=32, source_height=32, enc_mode=6)
    ).send_picture(*_frames(1, 32, 32)[0]),
    "encode_intra_frame": lambda: tie.encode_intra_frame(
        *_frames(1, 32, 32)[0], 140, tx_search=True, angle_deltas=True,
        cfl=True),
    "palette_md_candidates": lambda: tie.palette_md_candidates(
        np.tile(np.arange(32, dtype=np.uint8) // 16 * 50, (32, 1)), 140),
    "palette_cands_from_jax": lambda: importlib.import_module(
        "svt_av1_tpu_torch.convert").palette_cands_from_jax(
            (np.zeros(4, np.float32), np.zeros((4, 16, 16), np.int32),
             np.zeros((4, 256), np.int16), {})),
    "md_rate_args": lambda: rate_est.md_rate_args(140, tie.MODES,
                                                  tie.UV_MODES),
    "convert": lambda: importlib.import_module(
        "svt_av1_tpu_torch.convert").quant_params_from_jax(
            quant.make_quant_params(140)),
    "Encoder post filters": lambda: Encoder(EncoderConfig(
        source_width=64, source_height=64, enable_restoration_filtering=1,
        superres_mode=1, film_grain_denoise_strength=8,
        enable_adaptive_quantization=2)),
    "Encoder 10-bit": lambda: Encoder(EncoderConfig(
        source_width=32, source_height=32, encoder_bit_depth=10,
        enable_restoration_filtering=1)),
    "Encoder AVIF": lambda: Encoder(EncoderConfig(
        source_width=32, source_height=32, avif=True)),
    "Encoder GOP": lambda: Encoder(EncoderConfig(
        source_width=32, source_height=32, intra_period_length=4,
        hierarchical_levels=1, enable_tf=0)),
    "run_inter_frame": lambda: importlib.import_module(
        "svt_av1_tpu_torch.pipeline.gop_fast").run_inter_frame(
            np.zeros((48, 32), np.uint8),
            {1: {p: torch.zeros(s, dtype=torch.uint8) for p, s in (
                ("y", (32, 32)), ("u", (16, 16)), ("v", (16, 16)))}},
            140, 32, 32, (0,)),
    "reconstruct_inter_from_decisions": lambda: importlib.import_module(
        "svt_av1_tpu_torch.pipeline.inter_encoder"
    ).reconstruct_inter_from_decisions({}, {}, 32, 32, 140),
    "mctf_filter_frame": lambda: importlib.import_module(
        "svt_av1_tpu_torch.pipeline.tf_stage").mctf_filter_frame(
            _frames(1, 32, 32)[0], _frames(1, 32, 32)),
    "tpl_group_stats": lambda: importlib.import_module(
        "svt_av1_tpu_torch.pipeline.gop_fast").tpl_group_stats(
            [np.zeros((32, 32), np.uint8)] * 2, [None, [0]]),
    "Encoder rate control": lambda: Encoder(EncoderConfig(
        source_width=32, source_height=32, rate_control_mode=2,
        max_bit_rate=0, stat_report=1, content_light="1000,400")),
    "reconfigure": lambda: Encoder(EncoderConfig(
        source_width=32, source_height=32, rate_control_mode=1)
    ).reconfigure(target_bit_rate=50_000),
    "get_stats": lambda: Encoder(EncoderConfig(
        source_width=32, source_height=32, pass_=1)).get_stats(),
    "get_stream_info": lambda: Encoder(EncoderConfig(
        source_width=32, source_height=32, pass_=1)).get_stream_info(0),
    "send_pictures tiles": lambda: Encoder(EncoderConfig(
        source_width=128, source_height=32, tile_columns=1)
    ).send_pictures(_frames(1, 128, 32)),
    "reconstruct_from_decisions tiled": lambda: (
        tie.reconstruct_from_decisions({}, 128, 32, 140, tile_starts=(0, 4))),
    "Decoder tiled": lambda: Decoder()._decode_frame_tiled(
        None, b"", 128, 2),
    "hierarchical_me": lambda: importlib.import_module(
        "svt_av1_tpu_torch.pipeline.me").hierarchical_me(
            np.zeros((32, 32), np.uint8), np.zeros((32, 32), np.uint8)),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_without_cuda_raises(name, monkeypatch):
    """With no device given the port runs on the card; without CUDA that
    raises and names device="cpu" (no silent fallback)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ENTRY_POINTS[name]()


def test_resolve_defaults_to_the_current_cuda_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert device_mod.resolve(None) == torch.device("cuda", 0)
    assert device_mod.resolve("cpu") == torch.device("cpu")


def test_quant_constants_packed_for_the_kernel():
    qp_np = quant.make_quant_params(140)
    qp = quant.to_device(qp_np, "cpu")
    packed = fused_txq.packed_constants(qp)
    assert packed.data_ptr() == qp.zbin.data_ptr()
    flat = torch.from_numpy(np.stack(qp_np).reshape(-1))
    assert torch.equal(torch.as_strided(packed, (10,), (1,)), flat)
    loose = quant.QuantParams(*(a.clone() for a in qp))
    assert torch.equal(fused_txq.packed_constants(loose).flatten(), flat)
    assert quant.params_on(140, torch.device("cpu")) is quant.params_on(
        140, torch.device("cpu"))


@pytest.mark.parametrize("bad", ["dtype", "shape", "strides", "offset",
                                 "qp"])
def test_wrapper_check_refuses(bad):
    resid = torch.zeros((4, 16, 16), dtype=torch.int32)
    qp = quant.to_device(quant.make_quant_params(140), "cpu")
    if bad == "dtype":
        resid = resid.long()
    elif bad == "shape":
        resid = torch.zeros((4, 8, 8), dtype=torch.int32)
    elif bad == "strides":
        resid = resid.transpose(1, 2)
    elif bad == "offset":
        resid = torch.zeros(4 * 256 + 1, dtype=torch.int32)[1:].view(4, 16,
                                                                      16)
    else:
        qp = qp._replace(quant=qp.quant.long())
    with pytest.raises((TypeError, ValueError)):
        fused_txq._check(resid, qp)


def test_native_loader_raises_with_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "ec_native.c"
    bad.write_text("this is not C\n")
    monkeypatch.setattr(native, "SRC", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "SO", str(tmp_path / "build" / "ec.so"))
    monkeypatch.setattr(native, "_mod", None)
    with pytest.raises(RuntimeError, match="did not build") as e:
        native.get_ec()
    assert "error" in str(e.value)
