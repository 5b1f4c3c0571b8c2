"""Film grain synthesis (AV1 spec §7.18.3) + parameter signaling.

Behavioral reference: grainSynthesis.c (svt_av1_add_film_grain_run) and
entropy_coding.c film_grain_params writer.  The grain template generation
(LFSR PRNG + gaussian table + AR filter) is tiny and inherently serial,
so it runs on the host (numpy) once per seed; the per-block application
is vectorizable and will move on-device with the display/recon stage.

Round-1 scope: 4:2:0, overlap off, 8-bit apply (the signaled-params path
supports all presets).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


@dataclasses.dataclass
class FilmGrainParams:
    apply_grain: bool = True
    random_seed: int = 7391
    update_parameters: bool = True
    scaling_points_y: List[Tuple[int, int]] = dataclasses.field(
        default_factory=lambda: [(0, 20), (120, 32), (255, 40)])
    scaling_points_cb: List[Tuple[int, int]] = dataclasses.field(
        default_factory=list)
    scaling_points_cr: List[Tuple[int, int]] = dataclasses.field(
        default_factory=list)
    scaling_shift: int = 8
    ar_coeff_lag: int = 2
    ar_coeffs_y: List[int] = dataclasses.field(
        default_factory=lambda: [0] * 24)
    ar_coeffs_cb: List[int] = dataclasses.field(
        default_factory=lambda: [0] * 25)
    ar_coeffs_cr: List[int] = dataclasses.field(
        default_factory=lambda: [0] * 25)
    ar_coeff_shift: int = 6
    cb_mult: int = 128
    cb_luma_mult: int = 192
    cb_offset: int = 256
    cr_mult: int = 128
    cr_luma_mult: int = 192
    cr_offset: int = 256
    overlap_flag: bool = False
    clip_to_restricted_range: bool = False
    chroma_scaling_from_luma: bool = False
    grain_scale_shift: int = 0
    bit_depth: int = 8


# convenience properties
FilmGrainParams.num_y_points = property(
    lambda self: len(self.scaling_points_y))
FilmGrainParams.num_cb_points = property(
    lambda self: len(self.scaling_points_cb))
FilmGrainParams.num_cr_points = property(
    lambda self: len(self.scaling_points_cr))


def read_film_grain_params(r, frame_type_key: bool = True
                           ) -> Optional[FilmGrainParams]:
    """Mirror of write_film_grain_params (verification decoder)."""
    if not r.f(1):
        return None
    p = FilmGrainParams()
    p.random_seed = r.f(16)
    if not frame_type_key:
        p.update_parameters = bool(r.f(1))
    ny = r.f(4)
    p.scaling_points_y = [(r.f(8), r.f(8)) for _ in range(ny)]
    p.chroma_scaling_from_luma = bool(r.f(1))
    if not p.chroma_scaling_from_luma:
        ncb = r.f(4)
        p.scaling_points_cb = [(r.f(8), r.f(8)) for _ in range(ncb)]
        ncr = r.f(4)
        p.scaling_points_cr = [(r.f(8), r.f(8)) for _ in range(ncr)]
    else:
        p.scaling_points_cb = []
        p.scaling_points_cr = []
    p.scaling_shift = r.f(2) + 8
    p.ar_coeff_lag = r.f(2)
    n_y = 2 * p.ar_coeff_lag * (p.ar_coeff_lag + 1)
    p.ar_coeffs_y = [r.f(8) - 128
                     for _ in range(n_y if p.num_y_points else 0)]
    n_uv = n_y + (1 if p.num_y_points else 0)
    if p.chroma_scaling_from_luma or p.num_cb_points:
        p.ar_coeffs_cb = [r.f(8) - 128 for _ in range(n_uv)]
    if p.chroma_scaling_from_luma or p.num_cr_points:
        p.ar_coeffs_cr = [r.f(8) - 128 for _ in range(n_uv)]
    p.ar_coeff_shift = r.f(2) + 6
    p.grain_scale_shift = r.f(2)
    if p.num_cb_points:
        p.cb_mult = r.f(8)
        p.cb_luma_mult = r.f(8)
        p.cb_offset = r.f(9)
    if p.num_cr_points:
        p.cr_mult = r.f(8)
        p.cr_luma_mult = r.f(8)
        p.cr_offset = r.f(9)
    p.overlap_flag = bool(r.f(1))
    p.clip_to_restricted_range = bool(r.f(1))
    return p


