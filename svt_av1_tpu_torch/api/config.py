"""Encoder configuration, mirroring the reference public config surface
(EbSvtAv1EncConfiguration, Source/API/EbSvtAv1Enc.h:217-945) and the
string parameter parser (enc_settings.c svt_av1_enc_parse_parameter).

Only the fields wired into the current pipeline have effect; the rest are
validated and stored for parity and forward compatibility."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


class ConfigError(ValueError):
    pass


@dataclasses.dataclass
class EncoderConfig:
    # input
    source_width: int = 0
    source_height: int = 0
    encoder_bit_depth: int = 8
    encoder_color_format: int = 1     # EB_YUV420
    frame_rate_numerator: int = 30
    frame_rate_denominator: int = 1
    # coding structure
    enc_mode: int = 10                # preset M0..M13
    intra_period_length: int = -2     # -2: auto, -1: all intra after first
    intra_refresh_type: int = 2       # CRA/IDR
    hierarchical_levels: int = 0      # 0: auto
    pred_structure: int = 2           # random access
    # rate control
    rate_control_mode: int = 0        # 0=CQP/CRF, 1=VBR, 2=CBR
    max_bit_rate: int = 0             # capped CRF: bits/s cap (0=off)
    qp: int = 35                      # quantizer / CRF
    target_bit_rate: int = 2_000_000
    max_qp_allowed: int = 63
    min_qp_allowed: int = 1
    enable_adaptive_quantization: int = 0
    # tools
    enable_dlf_flag: bool = False
    cdef_level: int = 0
    enable_restoration_filtering: int = 0
    enable_tf: int = 1      # MCTF keys + mini-GoP bases (reference
                            # default, enc_settings.c)
    enable_overlays: bool = False
    tune: int = 1
    film_grain_denoise_strength: int = 0
    superres_mode: int = 0
    tile_columns: int = 0
    tile_rows: int = 0
    screen_content_mode: int = 0
    sframe_dist: int = 0              # S_FRAME every N inter frames
    avif: bool = False                # single-picture (AVIF) mode:
                                      # still_picture + reduced header
    # HDR metadata (metadata_handle.c surface); SVT string formats:
    # mastering-display "G(x,y)B(x,y)R(x,y)WP(x,y)L(max,min)",
    # content-light "maxcll,maxfall"
    mastering_display: str = ""
    content_light: str = ""
    enable_tpl_la: int = 0
    fast_decode: int = 0
    stat_report: int = 0              # per-frame PSNR/SSIM on packets
    # threading analog
    level_of_parallelism: int = 0
    # multi-pass
    pass_: int = 0
    rc_stats_buffer: Optional[bytes] = None

    def validate(self):
        if not (0 < self.source_width <= 16384):
            raise ConfigError(f"bad source_width {self.source_width}")
        if not (0 < self.source_height <= 8704):
            raise ConfigError(f"bad source_height {self.source_height}")
        if self.source_width % 2 or self.source_height % 2:
            raise ConfigError("odd dimensions not supported")
        if self.encoder_bit_depth not in (8, 10):
            raise ConfigError(f"bad bit depth {self.encoder_bit_depth}")
        if not (0 <= self.qp <= 63):
            raise ConfigError(f"bad qp {self.qp}")
        if not (0 <= self.enc_mode <= 13):
            raise ConfigError(f"bad preset {self.enc_mode}")
        if self.rate_control_mode not in (0, 1, 2):
            raise ConfigError(f"bad rc mode {self.rate_control_mode}")
        if not (0 <= self.hierarchical_levels <= 5):
            raise ConfigError(
                f"bad hierarchical_levels {self.hierarchical_levels}")
        return self


# string-parameter names, mirroring svt_av1_enc_parse_parameter
_PARAM_MAP = {
    "width": ("source_width", int),
    "w": ("source_width", int),
    "height": ("source_height", int),
    "h": ("source_height", int),
    "input-depth": ("encoder_bit_depth", int),
    "preset": ("enc_mode", int),
    "qp": ("qp", int),
    "crf": ("qp", int),
    "rc": ("rate_control_mode", int),
    "mbr": ("max_bit_rate", int),
    "tbr": ("target_bit_rate", int),
    "keyint": ("intra_period_length", int),
    "irefresh-type": ("intra_refresh_type", int),
    "hierarchical-levels": ("hierarchical_levels", int),
    "pred-struct": ("pred_structure", int),
    "enable-dlf": ("enable_dlf_flag", lambda v: bool(int(v))),
    "enable-cdef": ("cdef_level", int),
    "enable-restoration": ("enable_restoration_filtering", int),
    "enable-tf": ("enable_tf", int),
    "enable-overlays": ("enable_overlays", lambda v: bool(int(v))),
    "tune": ("tune", int),
    "film-grain": ("film_grain_denoise_strength", int),
    "avif": ("avif", lambda v: bool(int(v))),
    "sframe-dist": ("sframe_dist", int),
    "mastering-display": ("mastering_display", str),
    "content-light": ("content_light", str),
    "superres-mode": ("superres_mode", int),
    "tile-columns": ("tile_columns", int),
    "tile-rows": ("tile_rows", int),
    "scm": ("screen_content_mode", int),
    "enable-tpl-la": ("enable_tpl_la", int),
    "fast-decode": ("fast_decode", int),
    "enable-stat-report": ("stat_report", int),
    "lp": ("level_of_parallelism", int),
    "pass": ("pass_", int),
    "fps-num": ("frame_rate_numerator", int),
    "fps-denom": ("frame_rate_denominator", int),
}


def parse_parameter(cfg: EncoderConfig, name: str, value: str):
    """svt_av1_enc_parse_parameter equivalent: set one option by name."""
    key = name.lstrip("-")
    if key not in _PARAM_MAP:
        raise ConfigError(f"unknown parameter {name!r}")
    field, conv = _PARAM_MAP[key]
    try:
        setattr(cfg, field, conv(value))
    except ValueError as e:
        raise ConfigError(f"bad value {value!r} for {name}: {e}") from e
    return cfg
