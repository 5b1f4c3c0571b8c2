#!/usr/bin/env python3
"""Remake tests/golden/torch_port_refs.npz, the JAX package's outputs that
the port's slowest comparisons are held to (see tests/port_refs.py).

    JAX_PLATFORMS=cpu python tools/make_torch_port_refs.py [TEST_ID ...]

Runs those tests in this process with ``port_refs.recording`` set, so that
each comparison computes the JAX package's outputs live (and still checks
the port against them), then writes every recorded output with the
fingerprint of its inputs.  Given test ids (each one of TESTS, or a file
or test name that selects some of them), runs only those and keeps the
file's other entries.  Exits non-zero, writing nothing, if a test fails.
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
    "tests/test_torch_intra_encoder.py::test_slice_matches_jax_package",
    "tests/test_torch_intra_encoder.py::test_send_pictures_filters_match_jax",
    "tests/test_torch_key_frame.py::test_send_pictures_m6_matches_jax",
    "tests/test_torch_key_frame.py::test_parity_with_the_jax_encoder",
    "tests/test_torch_gop.py::test_p1_matches_jax",
    "tests/test_torch_gop.py::test_p2_matches_jax",
    "tests/test_torch_gop.py::test_gop_parity_with_jax",
    "tests/test_torch_gop.py::test_send_pictures_eos_shows_every_frame",
    "tests/test_torch_gop.py::test_jax_decoder_decodes_port_stream",
    "tests/test_torch_lookahead.py::test_temporal_filter_tie_rule",
    "tests/test_torch_lookahead.py::test_mctf_filter_frame_tie_rule",
    "tests/test_torch_lookahead.py::test_tpl_group_stats_exact",
    "tests/test_torch_lookahead.py::test_qmap_key_frame_matches_jax",
    "tests/test_torch_lookahead.py::test_lookahead_gop_parity_with_jax",
    "tests/test_torch_gop_m6.py::test_p1_tools_match_jax",
    "tests/test_torch_gop_m6.py::test_p2_split8_matches_jax",
    "tests/test_torch_gop_m6.py::test_m6_parity_with_jax",
    "tests/test_torch_quality_tools.py::test_wave_step_32_64_matches_jax",
    "tests/test_torch_quality_tools.py::"
    "test_run_key_filters_per_sb_matches_jax",
    "tests/test_torch_varpart.py::test_varpart_frame_matches_jax",
    "tests/test_torch_varpart.py::test_intra_stream_matches_jax",
    "tests/test_torch_gop_m4.py::test_m2_gop_matches_jax",
    "tests/test_torch_gop_m4.py::test_m4_gop_levels3_golden_dpb",
    "tests/test_torch_gop_m6.py::test_jax_decoder_decodes_port_stream",
    "tests/test_torch_gop_m6.py::test_rect_clip_keyint_m1_matches_jax",
    "tests/test_torch_restoration.py",
    "tests/test_torch_post_filters.py",
    "tests/test_torch_rate_control.py",
    "tests/test_torch_api_surface.py",
    "tests/test_torch_10bit.py",
    "tests/test_torch_avif.py",
    "tests/test_torch_gop_shapes.py",
    "tests/test_torch_cli.py",
    "tests/test_torch_capi.py",
    "tests/test_torch_multistream.py",
    "tests/test_torch_stage_path.py",
    "tests/test_torch_gop.py::test_out_of_scope_gop_settings_raise",
    "tests/test_torch_key_frame.py::test_out_of_slice_still_raises",
    "tests/test_torch_intra_encoder.py::test_out_of_slice_configs_raise",
    "tests/test_torch_feature_overrides.py",
    "tests/test_torch_gop.py::test_m5_m9_inter_tools_raise",
    "tests/test_torch_gop_m6.py::"
    "test_feature_overrides_outside_the_slice_raise",
)


def main(argv):
    os.chdir(REPO)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import port_refs
    unknown = [t for t in argv if not any(t.startswith(k) or k.startswith(t)
                                          for k in TESTS)]
    if unknown:
        print(f"make_torch_port_refs: not among TESTS: {unknown}",
              file=sys.stderr)
        return 2
    port_refs.recording = {}
    rc = pytest.main(["-q", "-p", "no:cacheprovider", "-p", "no:randomly",
                      *(argv or TESTS)])
    if rc != 0:
        print("make_torch_port_refs: a test failed; nothing written",
              file=sys.stderr)
        return 1
    if argv:
        # keep the entries of the tests that did not run
        kept = {k.rsplit("/", 1)[0] for k in port_refs._stored()}
        for key in kept - set(port_refs.recording):
            z = port_refs._stored()
            port_refs.recording[key] = (
                str(z[f"{key}/inputs"]),
                tuple(z[f"{key}/{i}"] for i in range(int(z[f"{key}/n"]))))
    port_refs.save()
    print(f"wrote {len(port_refs.recording)} references to {port_refs.PATH}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
