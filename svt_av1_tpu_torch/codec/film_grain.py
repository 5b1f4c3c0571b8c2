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
import functools
import os
from typing import List, Optional, Tuple

import numpy as np

from svt_av1_tpu_torch.utils.bitio import BitWriter

_DATA = os.path.join(os.path.dirname(__file__), "data",
                     "av1_gaussian_sequence.npz")
GAUSS_BITS = 11
LUMA_SUB = 32


@functools.lru_cache(maxsize=1)
def _gauss() -> np.ndarray:
    return np.load(_DATA)["gaussian_sequence"].astype(np.int32)


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


class _Lfsr:
    """Normative 16-bit LFSR (get_random_number)."""

    def __init__(self):
        self.reg = 0

    def seed_row(self, luma_line: int, seed: int):
        self.reg = seed & 0xFFFF
        luma_num = luma_line >> 5
        self.reg ^= ((luma_num * 37 + 178) & 255) << 8
        self.reg ^= (luma_num * 173 + 105) & 255

    def bits(self, n: int) -> int:
        r = self.reg
        bit = ((r >> 0) ^ (r >> 1) ^ (r >> 3) ^ (r >> 12)) & 1
        r = (r >> 1) | (bit << 15)
        self.reg = r
        return (r >> (16 - n)) & ((1 << n) - 1)


def _pred_positions(lag: int):
    pos = []
    for row in range(-lag, 0):
        for col in range(-lag, lag + 1):
            pos.append((row, col))
    for col in range(-lag, 0):
        pos.append((0, col))
    return pos


def generate_grain_y(p: FilmGrainParams) -> np.ndarray:
    """73x82 luma grain template (normative)."""
    bd = p.bit_depth
    gshift = 12 - bd + p.grain_scale_shift
    rows, cols = 73, 82
    rng = _Lfsr()
    rng.reg = p.random_seed & 0xFFFF  # luma template uses the raw seed
    gauss = _gauss()
    g = np.zeros((rows, cols), np.int32)
    if p.num_y_points == 0:
        return g
    for i in range(rows):
        for j in range(cols):
            g[i, j] = (gauss[rng.bits(GAUSS_BITS)]
                       + ((1 << gshift) >> 1)) >> gshift
    gmin = -(128 << (bd - 8))
    gmax = (256 << (bd - 8)) - 1 - (128 << (bd - 8))
    pos = _pred_positions(p.ar_coeff_lag)
    roff = 1 << (p.ar_coeff_shift - 1)
    for i in range(3, rows):
        for j in range(3, cols - 3):
            wsum = 0
            for k, (dy, dx) in enumerate(pos):
                wsum += p.ar_coeffs_y[k] * g[i + dy, j + dx]
            g[i, j] = np.clip(g[i, j] + ((wsum + roff) >> p.ar_coeff_shift),
                              gmin, gmax)
    return g


def generate_grain_uv(p: FilmGrainParams, grain_y: np.ndarray,
                      plane: str) -> np.ndarray:
    """38x44 chroma grain template (4:2:0)."""
    bd = p.bit_depth
    gshift = 12 - bd + p.grain_scale_shift
    rows, cols = 38, 44
    rng = _Lfsr()
    rng.seed_row((7 << 5) if plane == "cb" else (11 << 5), p.random_seed)
    gauss = _gauss()
    g = np.zeros((rows, cols), np.int32)
    npts = p.num_cb_points if plane == "cb" else p.num_cr_points
    if npts or p.chroma_scaling_from_luma:
        for i in range(rows):
            for j in range(cols):
                g[i, j] = (gauss[rng.bits(GAUSS_BITS)]
                           + ((1 << gshift) >> 1)) >> gshift
    else:
        return g
    coeffs = p.ar_coeffs_cb if plane == "cb" else p.ar_coeffs_cr
    gmin = -(128 << (bd - 8))
    gmax = (256 << (bd - 8)) - 1 - (128 << (bd - 8))
    pos = _pred_positions(p.ar_coeff_lag)
    has_luma = p.num_y_points > 0
    roff = 1 << (p.ar_coeff_shift - 1)
    for i in range(3, rows):
        for j in range(3, cols - 3):
            wsum = 0
            for k, (dy, dx) in enumerate(pos):
                wsum += coeffs[k] * g[i + dy, j + dx]
            if has_luma:
                ly, lx = ((i - 3) << 1) + 3, ((j - 3) << 1) + 3
                av = (int(grain_y[ly, lx]) + int(grain_y[ly, lx + 1])
                      + int(grain_y[ly + 1, lx])
                      + int(grain_y[ly + 1, lx + 1]) + 2) >> 2
                wsum += coeffs[len(pos)] * av
            g[i, j] = np.clip(g[i, j] + ((wsum + roff) >> p.ar_coeff_shift),
                              gmin, gmax)
    return g


def _scaling_lut(points: List[Tuple[int, int]]) -> np.ndarray:
    lut = np.zeros(256, np.int32)
    if not points:
        return lut
    lut[:points[0][0]] = points[0][1]
    for k in range(len(points) - 1):
        (x0, y0), (x1, y1) = points[k], points[k + 1]
        dx = x1 - x0
        delta = (y1 - y0) * ((65536 + (dx >> 1)) // dx)
        for x in range(dx):
            lut[x0 + x] = y0 + ((x * delta + 32768) >> 16)
    lut[points[-1][0]:] = points[-1][1]
    return lut


# convenience properties
FilmGrainParams.num_y_points = property(
    lambda self: len(self.scaling_points_y))
FilmGrainParams.num_cb_points = property(
    lambda self: len(self.scaling_points_cb))
FilmGrainParams.num_cr_points = property(
    lambda self: len(self.scaling_points_cr))


def apply_film_grain(p: FilmGrainParams, y: np.ndarray, u: np.ndarray,
                     v: np.ndarray):
    """Apply grain (4:2:0, 8-bit, overlap off) — bit-exact with
    svt_av1_add_film_grain_run for this configuration."""
    assert p.bit_depth == 8 and not p.overlap_flag
    h, w = y.shape
    out_y = y.astype(np.int32).copy()
    out_u = u.astype(np.int32).copy()
    out_v = v.astype(np.int32).copy()
    gy = generate_grain_y(p)
    gcb = generate_grain_uv(p, gy, "cb")
    gcr = generate_grain_uv(p, gy, "cr")
    lut_y = _scaling_lut(p.scaling_points_y)
    if p.chroma_scaling_from_luma:
        lut_cb = lut_cr = lut_y
    else:
        lut_cb = _scaling_lut(p.scaling_points_cb)
        lut_cr = _scaling_lut(p.scaling_points_cr)

    if p.clip_to_restricted_range:
        min_l, max_l = 16, 235
        min_c, max_c = 16, 240
    else:
        min_l = min_c = 0
        max_l = max_c = 255
    rshift = 1 << (p.scaling_shift - 1)
    apply_y_f = p.num_y_points > 0
    apply_cb = p.num_cb_points > 0 or p.chroma_scaling_from_luma
    apply_cr = p.num_cr_points > 0 or p.chroma_scaling_from_luma
    cb_mult, cb_lmult, cb_off = p.cb_mult - 128, p.cb_luma_mult - 128, \
        p.cb_offset - 256
    cr_mult, cr_lmult, cr_off = p.cr_mult - 128, p.cr_luma_mult - 128, \
        p.cr_offset - 256
    if p.chroma_scaling_from_luma:
        cb_mult, cb_lmult, cb_off = 0, 64, 0
        cr_mult, cr_lmult, cr_off = 0, 64, 0

    rng = _Lfsr()
    for by in range(0, h // 2, LUMA_SUB >> 1):
        rng.seed_row(by * 2, p.random_seed)
        for bx in range(0, w // 2, LUMA_SUB >> 1):
            r = rng.bits(8)
            off_x = (r >> 4) & 15
            off_y = r & 15
            gly = 3 + 6 + (off_y << 1)
            glx = 3 + 6 + (off_x << 1)
            gcy = 3 + 3 + off_y
            gcx = 3 + 3 + off_x
            hh = min(LUMA_SUB >> 1, h // 2 - by)   # half luma height
            hw = min(LUMA_SUB >> 1, w // 2 - bx)
            # luma
            if apply_y_f:
                ys, xs = by * 2, bx * 2
                blk = out_y[ys:ys + 2 * hh, xs:xs + 2 * hw]
                gr = gy[gly:gly + 2 * hh, glx:glx + 2 * hw]
                noise = (lut_y[np.clip(blk, 0, 255)] * gr + rshift) \
                    >> p.scaling_shift
                out_y[ys:ys + 2 * hh, xs:xs + 2 * hw] = np.clip(
                    blk + noise, min_l, max_l)
            # chroma (uses pre-grain luma for the scaling index per the
            # reference call order: chroma first in add_noise_to_block,
            # but it reads the *already updated* luma? No: luma is
            # updated after chroma in the same call — use original luma)
            ys, xs = by * 2, bx * 2
            luma_blk = y.astype(np.int32)[ys:ys + 2 * hh, xs:xs + 2 * hw]
            avg = (luma_blk[::2, ::2] + luma_blk[::2, 1::2] + 1) >> 1
            for apply_f, outp, lut, mult, lmult, off, gr_t in (
                    (apply_cb, out_u, lut_cb, cb_mult, cb_lmult, cb_off,
                     gcb),
                    (apply_cr, out_v, lut_cr, cr_mult, cr_lmult, cr_off,
                     gcr)):
                if not apply_f:
                    continue
                cblk = outp[by:by + hh, bx:bx + hw]
                gr = gr_t[gcy:gcy + hh, gcx:gcx + hw]
                idx = np.clip(((avg * lmult + mult * cblk) >> 6) + off,
                              0, 255)
                noise = (lut[idx] * gr + rshift) >> p.scaling_shift
                outp[by:by + hh, bx:bx + hw] = np.clip(cblk + noise,
                                                       min_c, max_c)
    return (out_y.astype(np.uint8), out_u.astype(np.uint8),
            out_v.astype(np.uint8))


def write_film_grain_params(w: BitWriter, p: Optional[FilmGrainParams],
                            frame_type_key: bool = True):
    """film_grain_params() frame-header syntax (spec 5.9.30)."""
    if p is None or not p.apply_grain:
        w.f(0, 1)  # apply_grain
        return
    w.f(1, 1)
    w.f(p.random_seed, 16)
    # KEY frames always update parameters (no flag)
    if not frame_type_key:
        w.f(int(p.update_parameters), 1)
    w.f(p.num_y_points, 4)
    for (x, v) in p.scaling_points_y:
        w.f(x, 8)
        w.f(v, 8)
    # mono = 0
    w.f(int(p.chroma_scaling_from_luma), 1)
    if not p.chroma_scaling_from_luma:
        w.f(p.num_cb_points, 4)
        for (x, v) in p.scaling_points_cb:
            w.f(x, 8)
            w.f(v, 8)
        w.f(p.num_cr_points, 4)
        for (x, v) in p.scaling_points_cr:
            w.f(x, 8)
            w.f(v, 8)
    w.f(p.scaling_shift - 8, 2)
    w.f(p.ar_coeff_lag, 2)
    n_y = 2 * p.ar_coeff_lag * (p.ar_coeff_lag + 1)
    for k in range(n_y if p.num_y_points else 0):
        w.f(p.ar_coeffs_y[k] + 128, 8)
    n_uv = n_y + (1 if p.num_y_points else 0)
    if p.chroma_scaling_from_luma or p.num_cb_points:
        for k in range(n_uv):
            w.f(p.ar_coeffs_cb[k] + 128, 8)
    if p.chroma_scaling_from_luma or p.num_cr_points:
        for k in range(n_uv):
            w.f(p.ar_coeffs_cr[k] + 128, 8)
    w.f(p.ar_coeff_shift - 6, 2)
    w.f(p.grain_scale_shift, 2)
    if p.num_cb_points:
        w.f(p.cb_mult, 8)
        w.f(p.cb_luma_mult, 8)
        w.f(p.cb_offset, 9)
    if p.num_cr_points:
        w.f(p.cr_mult, 8)
        w.f(p.cr_luma_mult, 8)
        w.f(p.cr_offset, 9)
    w.f(int(p.overlap_flag), 1)
    w.f(int(p.clip_to_restricted_range), 1)


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


def default_grain_params(strength: int, seed: int = 7391
                         ) -> FilmGrainParams:
    """Synthetic grain preset scaled by --film-grain strength 1..50
    (parity with the reference's film_grain_denoise_strength surface;
    the AR-model *estimation* from denoised source lands with the
    noise-model stage)."""
    s = int(np.clip(strength, 1, 50))
    amp = 8 + s
    return FilmGrainParams(
        random_seed=seed,
        scaling_points_y=[(0, amp), (128, amp + s // 2), (255, amp)],
        scaling_points_cb=[(0, amp // 2), (255, amp // 2)],
        scaling_points_cr=[(0, amp // 2), (255, amp // 2)],
        ar_coeff_lag=2,
        ar_coeffs_y=[0] * 20 + [12, 8, 24, -2],
        ar_coeffs_cb=[0] * 20 + [10, 6, 20, -2, 6],
        ar_coeffs_cr=[0] * 20 + [10, 6, 20, -2, 6],
        overlap_flag=False)
