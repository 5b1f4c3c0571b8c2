"""AV1 OBU syntax: sequence header, frame header, OBU packaging.

Normative bitstream writers (AV1 spec §5; behavioral reference:
entropy_coding.c write_sequence_header / write_frame_header_obu and
packetization_process.c).  Scope (round 1): 8-bit 4:2:0, single tile,
key/intra frames, CDEF/LR/superres off — widened as those stages land.
Readers for the verification decoder mirror each writer.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from svt_av1_tpu_torch.utils.bitio import BitReader, BitWriter, leb128, read_leb128

# OBU types
OBU_SEQUENCE_HEADER = 1
OBU_TEMPORAL_DELIMITER = 2
OBU_FRAME_HEADER = 3
OBU_TILE_GROUP = 4
OBU_METADATA = 5
OBU_FRAME = 6
OBU_REDUNDANT_FRAME_HEADER = 7
OBU_PADDING = 15

KEY_FRAME = 0
INTER_FRAME = 1
INTRA_ONLY_FRAME = 2
S_FRAME = 3

PRIMARY_REF_NONE = 7


@dataclasses.dataclass
class SequenceParams:
    width: int
    height: int
    bit_depth: int = 8
    monochrome: bool = False
    seq_profile: int = 0
    still_picture: bool = False
    reduced_still_picture_header: bool = False
    use_128x128_superblock: bool = False
    enable_filter_intra: bool = False
    enable_intra_edge_filter: bool = False
    enable_order_hint: bool = False
    order_hint_bits: int = 7
    enable_ref_frame_mvs: bool = False   # temporal MVP available
    enable_screen_content: bool = False  # seq_force_sct == SELECT (2);
                                         # frames then code allow_sct
    enable_masked_compound: bool = True   # wedge compound available
    enable_interintra_compound: bool = False
    enable_superres: bool = False
    enable_cdef: bool = False
    enable_restoration: bool = False
    film_grain_params_present: bool = False
    seq_level_idx: int = 0
    seq_tier: int = 0
    subsampling_x: int = 1
    subsampling_y: int = 1

    def __post_init__(self):
        if self.seq_level_idx == 0:
            self.seq_level_idx = choose_level(self.width, self.height)


# (level_idx, max_pic_size, max_h_size, max_v_size) — spec A.3
_LEVELS = [
    (0, 147456, 2048, 1152),    # 2.0
    (1, 278784, 2816, 1584),    # 2.1
    (4, 665856, 4352, 2448),    # 3.0
    (5, 1065024, 5504, 3096),   # 3.1
    (8, 2359296, 6144, 3456),   # 4.0
    (9, 2359296, 6144, 3456),   # 4.1
    (12, 8912896, 8192, 4352),  # 5.0
    (13, 8912896, 8192, 4352),  # 5.1
    (16, 35651584, 16384, 8704),  # 6.0
    (17, 35651584, 16384, 8704),  # 6.1
]


def choose_level(w: int, h: int) -> int:
    for idx, pic, mw, mh in _LEVELS:
        if w * h <= pic and w <= mw and h <= mh:
            return idx
    return 31  # LEVEL_MAX (undefined level)


@dataclasses.dataclass
class FrameParams:
    frame_type: int = KEY_FRAME
    show_frame: bool = True
    showable_frame: bool = False
    error_resilient_mode: bool = False
    disable_cdf_update: bool = False
    base_q_idx: int = 50
    # display (render) size when different from the coded size
    render_width: int = 0
    render_height: int = 0
    film_grain = None  # Optional[film_grain.FilmGrainParams]
    segmentation = None  # Optional[segmentation.SegmentationParams]
    tx_mode_select: bool = False   # False => TX_MODE_LARGEST
    reduced_tx_set: bool = False
    allow_screen_content_tools: bool = False
    # loop filter (0 = off for round 1)
    filter_level: Tuple[int, int] = (0, 0)
    filter_level_uv: Tuple[int, int] = (0, 0)
    sharpness: int = 0
    # CDEF: cdef_bits = 0 -> one frame-uniform strength set in
    # cdef_strengths; cdef_bits > 0 -> 2^bits sets in
    # cdef_strength_list, indexed per SB by tile-coded cdef_idx
    cdef_damping: int = 3
    cdef_bits: int = 0
    cdef_strengths: Tuple[int, int, int, int] = (0, 0, 0, 0)
    cdef_strength_list: Optional[Tuple] = None
    # loop restoration: per-plane frame type + unit sizes
    lr_types: Tuple[int, int, int] = (0, 0, 0)   # RESTORE_* enum
    lr_unit_size: int = 256                      # luma RU size
    lr_uv_half: bool = True                      # chroma RU = luma >> 1
    # super-resolution: 8 = off; 9..16 = SuperresDenom (coded width =
    # (UpscaledWidth * 8 + denom/2) / denom)
    superres_denom: int = 8
    # per-SB adaptive quantization
    delta_q_present: bool = False
    delta_q_res: int = 0   # log2 of the delta step
    # tiles (uniform spacing): log2 of tile columns/rows
    log2_tile_cols: int = 0
    log2_tile_rows: int = 0
    # global motion per reference (LAST..ALTREF): None = IDENTITY, else
    # TRANSLATION with (row, col) in 1/8-pel units (even values only
    # when allow_high_precision_mv is 0)
    gm_trans: Tuple = (None,) * 7

    def coded_width(self, upscaled_w: int) -> int:
        if self.superres_denom == 8:
            return upscaled_w
        return (upscaled_w * 8 + self.superres_denom // 2) \
            // self.superres_denom
    # derived
    order_hint: int = 0
    refresh_frame_flags: int = 0xFF
    disable_frame_end_update_cdf: bool = False
    # inter frames (single LAST reference; all idx slots point at slot 0)
    ref_frame_idx: Tuple[int, ...] = (0, 0, 0, 0, 0, 0, 0)
    primary_ref_frame: int = PRIMARY_REF_NONE
    allow_high_precision_mv: bool = False
    interpolation_filter: int = 0   # EIGHTTAP
    is_motion_mode_switchable: bool = False
    use_ref_frame_mvs: bool = False      # temporal MVP this frame
    reference_select: bool = False  # compound refs allowed per block
    # order hints of the 7 references (enum-1 indexed), used to derive
    # skip_mode_params (spec 5.9.22); only meaningful when the sequence
    # codes enable_order_hint
    ref_hints: Tuple[int, ...] = (0, 0, 0, 0, 0, 0, 0)
    # per-SLOT order hints written for error-resilient inter frames
    # (spec 5.9.2 ref_order_hint[i]); None = all zero
    ref_order_hints: Optional[Tuple[int, ...]] = None
    skip_mode_present: bool = False


def order_hint_rel_dist(a: int, b: int, bits: int) -> int:
    """Signed relative distance of two order hints (spec
    get_relative_dist; pd_process.c:89 behavioral reference)."""
    d = (a - b) & ((1 << bits) - 1)
    m = 1 << (bits - 1)
    return (d & (m - 1)) - (d & m)


def skip_mode_refs(cur_hint: int, ref_hints, bits: int):
    """Skip-mode reference pair derivation (spec 5.9.22
    skip_mode_params; svt_av1_setup_skip_mode_allowed,
    pd_process.c:99-172): the nearest forward + nearest backward
    references, or the two nearest forward ones.  ref_hints is indexed
    by ref enum - 1.  Returns (f0_enum, f1_enum) with f0 < f1, or None
    when skip mode is not allowed."""
    fwd = bwd = -1
    fwd_hint = bwd_hint = 0
    for i, h in enumerate(ref_hints):
        r = order_hint_rel_dist(h, cur_hint, bits)
        if r < 0:
            if fwd < 0 or order_hint_rel_dist(h, fwd_hint, bits) > 0:
                fwd, fwd_hint = i, h
        elif r > 0:
            if bwd < 0 or order_hint_rel_dist(h, bwd_hint, bits) < 0:
                bwd, bwd_hint = i, h
    if fwd >= 0 and bwd >= 0:
        return (1 + min(fwd, bwd), 1 + max(fwd, bwd))
    if fwd >= 0:
        snd, snd_hint = -1, 0
        for i, h in enumerate(ref_hints):
            if (order_hint_rel_dist(h, fwd_hint, bits) < 0
                    and (snd < 0
                         or order_hint_rel_dist(h, snd_hint, bits) > 0)):
                snd, snd_hint = i, h
        if snd >= 0:
            return (1 + min(fwd, snd), 1 + max(fwd, snd))
    return None


def _wb_write_primitive_subexpfin(w: BitWriter, n: int, k: int, v: int):
    """Finite subexponential code on raw header bits (spec 4.10.6 analog
    of the range-coder version in codec/subexp.py)."""
    i = mk = 0
    while True:
        b2 = k + i - 1 if i else k
        a = 1 << b2
        if n <= mk + 3 * a:
            w.ns(v - mk, n - mk)
            return
        more = int(v >= mk + a)
        w.f(more, 1)
        if more:
            i += 1
            mk += a
        else:
            w.f(v - mk, b2)
            return


def _wb_read_primitive_subexpfin(r: BitReader, n: int, k: int) -> int:
    i = mk = 0
    while True:
        b2 = k + i - 1 if i else k
        a = 1 << b2
        if n <= mk + 3 * a:
            return r.ns(n - mk) + mk
        if r.f(1):
            i += 1
            mk += a
        else:
            return r.f(b2) + mk


def _wb_write_signed_subexpfin(w: BitWriter, n: int, k: int, ref: int,
                               v: int):
    from svt_av1_tpu_torch.codec.subexp import _recenter_finite_nonneg
    ref += n - 1
    v += n - 1
    sn = (n << 1) - 1
    _wb_write_primitive_subexpfin(w, sn, k,
                                  _recenter_finite_nonneg(sn, ref, v))


def _wb_read_signed_subexpfin(r: BitReader, n: int, k: int,
                              ref: int) -> int:
    from svt_av1_tpu_torch.codec.subexp import _unrecenter_finite_nonneg
    ref += n - 1
    sn = (n << 1) - 1
    v = _unrecenter_finite_nonneg(sn, ref,
                                  _wb_read_primitive_subexpfin(r, sn, k))
    return v - (n - 1)


def write_obu(obu_type: int, payload: bytes, temporal_id: int = 0,
              has_size: bool = True) -> bytes:
    """OBU header + size + payload."""
    w = BitWriter()
    w.f(0, 1)             # obu_forbidden_bit
    w.f(obu_type, 4)
    w.f(0, 1)             # obu_extension_flag
    w.f(1 if has_size else 0, 1)  # obu_has_size_field
    w.f(0, 1)             # obu_reserved_1bit
    hdr = w.data()
    if has_size:
        return hdr + leb128(len(payload)) + payload
    return hdr + payload


METADATA_TYPE_HDR_CLL = 1
METADATA_TYPE_HDR_MDCV = 2
METADATA_TYPE_ITUT_T35 = 4


def _leb128(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def write_metadata_hdr_cll(max_cll: int, max_fall: int) -> bytes:
    """Content light level metadata OBU (metadata_handle.c role)."""
    w = BitWriter()
    w.f(max_cll, 16)
    w.f(max_fall, 16)
    w.trailing_bits()
    return write_obu(OBU_METADATA,
                     _leb128(METADATA_TYPE_HDR_CLL) + w.data())


def write_metadata_hdr_mdcv(primaries, white_point, max_luma: float,
                            min_luma: float) -> bytes:
    """Mastering display color volume OBU.  primaries: ((rx,ry),(gx,gy),
    (bx,by)) CIE 1931 floats; luminance in cd/m^2.  Spec 6.7.4 fixed-
    point encodings: chromaticity 0.16, max luminance 24.8, min 18.14."""
    w = BitWriter()
    # spec order: display_primaries[i] for i in 0..2 = R, G, B
    for (x, y) in primaries:
        w.f(int(round(x * 65536)) & 0xFFFF, 16)
        w.f(int(round(y * 65536)) & 0xFFFF, 16)
    w.f(int(round(white_point[0] * 65536)) & 0xFFFF, 16)
    w.f(int(round(white_point[1] * 65536)) & 0xFFFF, 16)
    w.f(int(round(max_luma * 256)) & 0xFFFFFFFF, 32)
    w.f(int(round(min_luma * 16384)) & 0xFFFFFFFF, 32)
    w.trailing_bits()
    return write_obu(OBU_METADATA,
                     _leb128(METADATA_TYPE_HDR_MDCV) + w.data())


def parse_metadata(payload: bytes):
    """Returns (metadata_type, fields dict)."""
    pos = 0
    mtype = 0
    shift = 0
    while True:
        b = payload[pos]
        mtype |= (b & 0x7F) << shift
        pos += 1
        shift += 7
        if not (b & 0x80):
            break
    r = BitReader(payload[pos:])
    if mtype == METADATA_TYPE_HDR_CLL:
        return mtype, dict(max_cll=r.f(16), max_fall=r.f(16))
    if mtype == METADATA_TYPE_HDR_MDCV:
        prim = tuple((r.f(16) / 65536.0, r.f(16) / 65536.0)
                     for _ in range(3))
        wp = (r.f(16) / 65536.0, r.f(16) / 65536.0)
        return mtype, dict(primaries=prim, white_point=wp,
                           max_luma=r.f(32) / 256.0,
                           min_luma=r.f(32) / 16384.0)
    return mtype, dict(raw=payload[pos:])


def temporal_delimiter() -> bytes:
    return write_obu(OBU_TEMPORAL_DELIMITER, b"")


def write_sequence_header(sp: SequenceParams) -> bytes:
    w = BitWriter()
    reduced = sp.reduced_still_picture_header
    w.f(sp.seq_profile, 3)
    w.f(int(sp.still_picture), 1)
    w.f(int(reduced), 1)
    if reduced:
        # spec 5.5.1: only seq_level_idx[0]; timing/operating points,
        # frame ids, inter tools and order hints are all implied off,
        # and seq_force_screen_content_tools = SELECT (2)
        assert sp.still_picture and not sp.enable_order_hint
        w.f(sp.seq_level_idx, 5)
    else:
        w.f(0, 1)   # timing_info_present_flag
        w.f(0, 1)   # initial_display_delay_present_flag
        w.f(0, 5)   # operating_points_cnt_minus_1
        w.f(0, 12)  # operating_point_idc[0]
        w.f(sp.seq_level_idx, 5)
        if sp.seq_level_idx > 7:
            w.f(sp.seq_tier, 1)
    wbits = max(1, (sp.width - 1).bit_length())
    hbits = max(1, (sp.height - 1).bit_length())
    w.f(wbits - 1, 4)
    w.f(hbits - 1, 4)
    w.f(sp.width - 1, wbits)
    w.f(sp.height - 1, hbits)
    if not reduced:
        w.f(0, 1)   # frame_id_numbers_present_flag
    w.f(int(sp.use_128x128_superblock), 1)
    w.f(int(sp.enable_filter_intra), 1)
    w.f(int(sp.enable_intra_edge_filter), 1)
    if not reduced:
        w.f(int(sp.enable_interintra_compound), 1)
        w.f(int(sp.enable_masked_compound), 1)
        w.f(0, 1)   # enable_warped_motion
        w.f(0, 1)   # enable_dual_filter
        w.f(int(sp.enable_order_hint), 1)
        if sp.enable_order_hint:
            w.f(0, 1)   # enable_jnt_comp
            w.f(int(sp.enable_ref_frame_mvs), 1)
        if sp.enable_screen_content:
            # SELECT: every frame codes allow_screen_content_tools;
            # integer-MV forcing stays off (seq_force_integer_mv = 0)
            w.f(1, 1)   # seq_choose_screen_content_tools
            w.f(0, 1)   # seq_choose_integer_mv
            w.f(0, 1)   # seq_force_integer_mv = 0
        else:
            w.f(0, 1)   # seq_choose_screen_content_tools
            w.f(0, 1)   # seq_force_screen_content_tools = 0
        if sp.enable_order_hint:
            w.f(sp.order_hint_bits - 1, 3)
    w.f(int(sp.enable_superres), 1)
    w.f(int(sp.enable_cdef), 1)
    w.f(int(sp.enable_restoration), 1)
    # color_config
    w.f(0 if sp.bit_depth == 8 else 1, 1)  # high_bitdepth
    if sp.seq_profile == 2 and sp.bit_depth == 12:
        raise NotImplementedError
    w.f(int(sp.monochrome), 1)
    w.f(0, 1)   # color_description_present_flag
    if sp.monochrome:
        w.f(0, 1)  # color_range
    else:
        w.f(0, 1)  # color_range
        # profile 0 => 4:2:0: subsampling implied
        w.f(0, 2)  # chroma_sample_position
        w.f(0, 1)  # separate_uv_delta_q
    w.f(int(sp.film_grain_params_present), 1)
    w.trailing_bits()
    return write_obu(OBU_SEQUENCE_HEADER, w.data())


def write_frame_header_bits(w: BitWriter, sp: SequenceParams,
                            fp: FrameParams):
    """Uncompressed frame header (no OBU wrapper, no trailing bits)."""
    is_intra = fp.frame_type in (KEY_FRAME, INTRA_ONLY_FRAME)
    reduced = sp.reduced_still_picture_header
    if reduced:
        # spec 5.9.2: frame_type = KEY, show_frame = 1, no bits
        assert fp.frame_type == KEY_FRAME and fp.show_frame
        error_resilient = False
    else:
        w.f(0, 1)   # show_existing_frame
        w.f(fp.frame_type, 2)
        w.f(int(fp.show_frame), 1)
        if not fp.show_frame:
            w.f(int(fp.showable_frame), 1)
        error_resilient = True if (
            fp.frame_type == S_FRAME or
            (fp.frame_type == KEY_FRAME and fp.show_frame)) else \
            fp.error_resilient_mode
        if not (fp.frame_type == S_FRAME or
                (fp.frame_type == KEY_FRAME and fp.show_frame)):
            w.f(int(fp.error_resilient_mode), 1)
    w.f(int(fp.disable_cdf_update), 1)
    if reduced:
        # seq_force_screen_content_tools == SELECT in reduced mode
        w.f(int(fp.allow_screen_content_tools), 1)
        assert not fp.allow_screen_content_tools
    elif sp.enable_screen_content:
        # seq_force_sct == SELECT: per-frame allow bit (imv forced off
        # at sequence level, so no force_integer_mv bit follows)
        w.f(int(fp.allow_screen_content_tools), 1)
    else:
        # seq_force_screen_content_tools == 0 => allow_sct = 0, no bit
        assert not fp.allow_screen_content_tools, \
            "screen content tools require SELECT at sequence level"
    # frame_size_override_flag (reduced: implied 0)
    if not reduced and fp.frame_type != S_FRAME:
        w.f(0, 1)
    if sp.enable_order_hint:
        w.f(fp.order_hint, sp.order_hint_bits)
    if not (is_intra or error_resilient):
        w.f(fp.primary_ref_frame, 3)
    if fp.frame_type == KEY_FRAME:
        if not fp.show_frame:
            w.f(fp.refresh_frame_flags, 8)
    else:
        w.f(fp.refresh_frame_flags, 8)
    if ((not is_intra or fp.refresh_frame_flags != 0xFF)
            and error_resilient and sp.enable_order_hint):
        hints = fp.ref_order_hints or (0,) * 8
        for i in range(8):
            w.f(hints[i], sp.order_hint_bits)
    if not is_intra:
        if sp.enable_order_hint:
            w.f(0, 1)   # frame_refs_short_signaling
        for i in range(7):
            w.f(fp.ref_frame_idx[i], 3)
    # frame_size(): S_FRAME implies frame_size_override_flag=1 and
    # codes the size explicitly; other frames inherit the sequence size
    if fp.frame_type == S_FRAME:
        wbits = max(1, (sp.width - 1).bit_length())
        hbits = max(1, (sp.height - 1).bit_length())
        w.f(sp.width - 1, wbits)
        w.f(sp.height - 1, hbits)
    if sp.enable_superres:
        use = fp.superres_denom != 8
        w.f(int(use), 1)
        if use:
            w.f(fp.superres_denom - 9, 3)  # coded_denom (DENOM_MIN 9)
    render_diff = (fp.render_width and fp.render_height and
                   (fp.render_width != sp.width or
                    fp.render_height != sp.height))
    w.f(int(bool(render_diff)), 1)  # render_and_frame_size_different
    if render_diff:
        w.f(fp.render_width - 1, 16)
        w.f(fp.render_height - 1, 16)
    if is_intra:
        # spec 5.9.11: allow_intrabc is only coded when
        # UpscaledWidth == FrameWidth (i.e. no superres scaling)
        if fp.allow_screen_content_tools and fp.superres_denom == 8:
            w.f(0, 1)  # allow_intrabc
    else:
        # force_integer_mv == 0 (screen content off at sequence level)
        w.f(int(fp.allow_high_precision_mv), 1)
        w.f(0, 1)  # is_filter_switchable = 0
        w.f(fp.interpolation_filter, 2)
        w.f(int(fp.is_motion_mode_switchable), 1)
        # use_ref_frame_mvs (spec 5.9.2: coded when
        # enable_ref_frame_mvs && enable_order_hint && !error_resilient)
        if (sp.enable_ref_frame_mvs and sp.enable_order_hint
                and not fp.error_resilient_mode):
            w.f(int(fp.use_ref_frame_mvs), 1)
    if not fp.disable_cdf_update:
        w.f(int(fp.disable_frame_end_update_cdf), 1)
    # tile_info()
    _write_tile_info(w, sp, fp.log2_tile_cols, fp.log2_tile_rows,
                     fp.coded_width(sp.width))
    # quantization_params
    w.f(fp.base_q_idx, 8)
    w.f(0, 1)   # delta_q_y_dc present
    if not sp.monochrome:
        w.f(0, 1)  # delta_q_u_dc
        w.f(0, 1)  # delta_q_u_ac
    w.f(0, 1)   # using_qmatrix
    # segmentation_params (spec 5.9.14)
    from svt_av1_tpu_torch.codec import segmentation as seg_mod
    seg_mod.write_params(
        w, fp.segmentation,
        primary_ref_none=fp.primary_ref_frame == PRIMARY_REF_NONE
        or is_intra)
    # delta_q_params
    if fp.base_q_idx > 0:
        w.f(int(fp.delta_q_present), 1)
        if fp.delta_q_present:
            w.f(fp.delta_q_res, 2)
    # delta_lf_params: only when delta_q_present (and !allow_intrabc)
    if fp.delta_q_present:
        w.f(0, 1)  # delta_lf_present
    # loop_filter_params (CodedLossless=False, allow_intrabc=False)
    w.f(fp.filter_level[0], 6)
    w.f(fp.filter_level[1], 6)
    if not sp.monochrome:
        if fp.filter_level[0] or fp.filter_level[1]:
            w.f(fp.filter_level_uv[0], 6)
            w.f(fp.filter_level_uv[1], 6)
    w.f(fp.sharpness, 3)
    w.f(0, 1)   # loop_filter_delta_enabled
    # cdef_params (CodedLossless=0, allow_intrabc=0)
    if sp.enable_cdef:
        w.f(fp.cdef_damping - 3, 2)
        w.f(fp.cdef_bits, 2)
        sets = (fp.cdef_strength_list if fp.cdef_bits
                else (fp.cdef_strengths,))
        assert len(sets) == (1 << fp.cdef_bits)
        for pri_y, sec_y, pri_uv, sec_uv in sets:
            w.f(pri_y, 4)
            w.f(sec_y, 2)
            if not sp.monochrome:
                w.f(pri_uv, 4)
                w.f(sec_uv, 2)
    # lr_params (entropy_coding.c encode_restoration_mode)
    if sp.enable_restoration:
        _LR_BITS = {0: (0, 0), 1: (1, 0), 2: (1, 1), 3: (0, 1)}
        all_none = all(t == 0 for t in fp.lr_types)
        chroma_none = fp.lr_types[1] == 0 and fp.lr_types[2] == 0
        for t in fp.lr_types:
            b0, b1 = _LR_BITS[t]
            w.f(b0, 1)
            w.f(b1, 1)
        if not all_none:
            w.f(int(fp.lr_unit_size > 64), 1)
            if fp.lr_unit_size > 64:
                w.f(int(fp.lr_unit_size > 128), 1)
        if not chroma_none:
            w.f(int(fp.lr_uv_half), 1)
    # read_tx_mode
    w.f(int(fp.tx_mode_select), 1)
    # frame_reference_mode
    if not is_intra:
        w.f(int(fp.reference_select), 1)
    # skip_mode_params (spec 5.9.22): allowed iff inter frame with
    # reference_select, order hints on, and a valid fwd/bwd (or
    # fwd/fwd2) reference pair
    if (not is_intra and fp.reference_select and sp.enable_order_hint
            and skip_mode_refs(fp.order_hint, fp.ref_hints,
                               sp.order_hint_bits) is not None):
        w.f(int(fp.skip_mode_present), 1)
    else:
        assert not fp.skip_mode_present, \
            "skip_mode_present set but skip mode not allowed"
    # allow_warped_motion: seq enable_warped_motion == 0 => no bit
    w.f(int(fp.reduced_tx_set), 1)
    # global_motion_params (entropy_coding.c:2953
    # write_global_motion_params; TRANSLATION type only)
    if not is_intra:
        for i in range(7):
            gm = fp.gm_trans[i]
            if gm is None:
                w.f(0, 1)  # is_global
                continue
            w.f(1, 1)      # is_global
            if len(gm) == 6:
                # ROTZOOM model (spec 5.9.24/5.9.25 read_global_param):
                # alpha params mat[2], mat[3] then the translation pair
                w.f(1, 1)  # is_rot_zoom
                mat = gm
                # alpha: absBits=GM_ABS_ALPHA_BITS(12),
                # precBits=GM_ALPHA_PREC_BITS(15) -> precDiff=1
                mx_a = 1 << 12   # GM_ALPHA_MAX
                sub2 = 1 << 15   # idx%3==2 diagonal bias
                assert mat[2] % 2 == 0 and mat[3] % 2 == 0
                _wb_write_signed_subexpfin(
                    w, mx_a + 1, 3, 0, (mat[2] >> 1) - sub2)
                _wb_write_signed_subexpfin(
                    w, mx_a + 1, 3, 0, mat[3] >> 1)
                # translation: absBits=GM_ABS_TRANS_BITS(12),
                # precBits=GM_TRANS_PREC_BITS(6) -> precDiff=10
                mx_t = 1 << 12   # GM_TRANS_MAX
                assert mat[0] % (1 << 10) == 0 \
                    and mat[1] % (1 << 10) == 0
                _wb_write_signed_subexpfin(
                    w, mx_t + 1, 3, 0, mat[0] >> 10)
                _wb_write_signed_subexpfin(
                    w, mx_t + 1, 3, 0, mat[1] >> 10)
                continue
            w.f(0, 1)      # is_rot_zoom
            w.f(1, 1)      # is_translation
            # !allow_hp: trans_bits = GM_ABS_TRANS_ONLY_BITS - 1 = 8,
            # prec_diff = GM_TRANS_ONLY_PREC_DIFF + 1 = 14; wmmat is the
            # 1/8-pel mv << 13, so the coded value is mv >> 1
            row, col = gm
            assert row % 2 == 0 and col % 2 == 0, "quarter-pel gm only"
            for v in (col, row):   # wmmat[0] = x/col, wmmat[1] = y/row
                _wb_write_signed_subexpfin(w, (1 << 8) + 1, 3, 0, v >> 1)
    if sp.film_grain_params_present and fp.show_frame:
        from svt_av1_tpu_torch.codec.film_grain import write_film_grain_params
        write_film_grain_params(w, fp.film_grain,
                                frame_type_key=fp.frame_type == KEY_FRAME)


def write_show_existing(idx: int) -> bytes:
    """show_existing_frame header (spec 5.9.2): displays DPB slot ``idx``.
    Behavioral reference: packetization of show_existing pictures
    (pd_process.c show_existing paths + packetization_process.c)."""
    w = BitWriter()
    w.f(1, 1)       # show_existing_frame
    w.f(idx, 3)     # frame_to_show_map_idx
    # frame ids / decoder model absent; shown frame is non-key: no more
    w.trailing_bits()
    return write_obu(OBU_FRAME_HEADER, w.data())


def parse_show_existing(payload: bytes) -> Optional[int]:
    """If the frame-header OBU is a show_existing_frame, return the DPB
    slot index; else None."""
    r = BitReader(payload)
    if r.f(1) == 0:
        return None
    return r.f(3)


def write_frame_obu(sp: SequenceParams, fp: FrameParams,
                    tile_data) -> bytes:
    """OBU_FRAME = frame_header + byte-align + tile group.

    tile_data: bytes (single tile) or a list of per-tile byte strings in
    raster tile order — each tile but the last is prefixed by its
    little-endian tile_size_minus_1 (TileSizeBytes = 4, spec 5.11.1)."""
    w = BitWriter()
    write_frame_header_bits(w, sp, fp)
    w.byte_align()
    if isinstance(tile_data, (bytes, bytearray)):
        tiles = [bytes(tile_data)]
    else:
        tiles = [bytes(t) for t in tile_data]
    payload = w.data()
    if len(tiles) == 1:
        # NumTiles == 1 => no start/end flags, no size fields
        payload += tiles[0]
    else:
        # OBU_FRAME: tile_start_and_end_present_flag must be 0; the
        # byte-aligned header above already ends on a byte, and the
        # flag bit occupies the first tile-group bit — but with the
        # flag 0 the group starts directly with the size fields, so we
        # emit the single 0 bit and pad (spec tile_group_obu: the flag
        # is only coded when NumTiles > 1).
        tw = BitWriter()
        tw.f(0, 1)
        tw.byte_align()
        payload += tw.data()
        for t in tiles[:-1]:
            payload += (len(t) - 1).to_bytes(4, "little") + t
        payload += tiles[-1]
    return write_obu(OBU_FRAME, payload)


def tile_cols_layout(width: int, log2_cols: int):
    """Uniform-spacing tile column boundaries in superblock units
    (spec 5.9.15): [(sb_start, sb_end), ...]."""
    sb_cols = (width + 63) >> 6
    size_sb = (sb_cols + (1 << log2_cols) - 1) >> log2_cols
    out = []
    start = 0
    while start < sb_cols:
        out.append((start, min(start + size_sb, sb_cols)))
        start += size_sb
    return out


def _write_tile_info(w: BitWriter, sp: SequenceParams,
                     log2_cols: int = 0, log2_rows: int = 0,
                     coded_width: int = 0):
    """Uniform-spacing tile_info().  Mirrors spec 5.9.15 computations."""
    sb_size = 128 if sp.use_128x128_superblock else 64
    sb_shift = 7 if sp.use_128x128_superblock else 6
    width = coded_width or sp.width
    sb_cols = (width + sb_size - 1) >> sb_shift
    sb_rows = (sp.height + sb_size - 1) >> sb_shift
    sb_size_log2 = sb_shift
    max_tile_width_sb = 4096 >> sb_size_log2
    max_tile_area_sb = (4096 * 2304) >> (2 * sb_size_log2)
    min_log2_tile_cols = _tile_log2(max_tile_width_sb, sb_cols)
    max_log2_tile_cols = _tile_log2(1, min(sb_cols, 64))
    max_log2_tile_rows = _tile_log2(1, min(sb_rows, 64))
    min_log2_tiles = max(min_log2_tile_cols,
                         _tile_log2(max_tile_area_sb, sb_rows * sb_cols))
    log2_cols = max(log2_cols, min_log2_tile_cols)
    assert log2_cols <= max_log2_tile_cols, "too many tile columns"
    assert log2_rows <= max_log2_tile_rows, "too many tile rows"
    min_log2_tile_rows = max(min_log2_tiles - log2_cols, 0)
    log2_rows = max(log2_rows, min_log2_tile_rows)
    w.f(1, 1)  # uniform_tile_spacing_flag
    cur = min_log2_tile_cols
    while cur < max_log2_tile_cols:
        if cur < log2_cols:
            w.f(1, 1)
            cur += 1
        else:
            w.f(0, 1)
            break
    cur = min_log2_tile_rows
    while cur < max_log2_tile_rows:
        if cur < log2_rows:
            w.f(1, 1)
            cur += 1
        else:
            w.f(0, 1)
            break
    if log2_cols > 0 or log2_rows > 0:
        w.f(0, log2_rows + log2_cols)  # context_update_tile_id = 0
        w.f(3, 2)  # tile_size_bytes_minus_1 = 3 (4-byte sizes)


def _tile_log2(blk_size: int, target: int) -> int:
    k = 0
    while (blk_size << k) < target:
        k += 1
    return k


# ---------------------------------------------------------------------------
# readers (verification decoder)
# ---------------------------------------------------------------------------

def parse_obus(data: bytes) -> List[Tuple[int, bytes]]:
    """Split a temporal unit into (obu_type, payload) list."""
    out = []
    pos = 0
    while pos < len(data):
        b0 = data[pos]
        obu_type = (b0 >> 3) & 0xF
        ext = (b0 >> 2) & 1
        has_size = (b0 >> 1) & 1
        pos += 1
        if ext:
            pos += 1
        if not has_size:
            raise ValueError("OBU without size field")
        size, pos = read_leb128(data, pos)
        out.append((obu_type, data[pos:pos + size]))
        pos += size
    return out


def read_sequence_header(payload: bytes) -> SequenceParams:
    r = BitReader(payload)
    profile = r.f(3)
    still = r.f(1)
    reduced = r.f(1)
    if reduced:
        level = r.f(5)
        tier = 0
    else:
        assert r.f(1) == 0  # timing
        assert r.f(1) == 0  # initial display delay
        op_cnt = r.f(5)
        assert op_cnt == 0
        r.f(12)
        level = r.f(5)
        tier = r.f(1) if level > 7 else 0
    wbits = r.f(4) + 1
    hbits = r.f(4) + 1
    width = r.f(wbits) + 1
    height = r.f(hbits) + 1
    if not reduced:
        assert r.f(1) == 0  # frame ids
    use128 = r.f(1)
    filter_intra = r.f(1)
    intra_edge = r.f(1)
    order_hint = 0
    order_hint_bits = 0
    masked_compound = 0
    interintra = 0
    ref_frame_mvs = 0
    force_sct = 0
    if not reduced:
        interintra = r.f(1)
        masked_compound = r.f(1)
        r.f(1)  # warped
        r.f(1)  # dual filter
        order_hint = r.f(1)
        ref_frame_mvs = 0
        if order_hint:
            r.f(1)  # enable_jnt_comp
            ref_frame_mvs = r.f(1)
        choose_sct = r.f(1)
        force_sct = 2 if choose_sct else r.f(1)
        force_imv = 0
        if force_sct > 0:
            choose_imv = r.f(1)
            force_imv = 2 if choose_imv else r.f(1)
        assert force_sct in (0, 2) and force_imv == 0, \
            "verifier supports SELECT screen content with imv off"
        if order_hint:
            order_hint_bits = r.f(3) + 1
    superres = r.f(1)
    cdef = r.f(1)
    restoration = r.f(1)
    high_bd = r.f(1)
    bit_depth = 10 if high_bd else 8
    mono = r.f(1)
    desc = r.f(1)
    assert not desc
    r.f(1)  # color_range
    if not mono:
        r.f(2)  # chroma sample position
        r.f(1)  # separate_uv_delta_q
    fg = r.f(1)
    return SequenceParams(
        width=width, height=height, bit_depth=bit_depth,
        monochrome=bool(mono), seq_profile=profile,
        still_picture=bool(still),
        reduced_still_picture_header=bool(reduced),
        use_128x128_superblock=bool(use128),
        enable_filter_intra=bool(filter_intra),
        enable_intra_edge_filter=bool(intra_edge),
        enable_order_hint=bool(order_hint), order_hint_bits=order_hint_bits,
        enable_ref_frame_mvs=bool(ref_frame_mvs),
        enable_screen_content=(force_sct == 2),
        enable_superres=bool(superres), enable_cdef=bool(cdef),
        enable_restoration=bool(restoration),
        film_grain_params_present=bool(fg), seq_level_idx=level,
        seq_tier=tier, enable_masked_compound=bool(masked_compound),
        enable_interintra_compound=bool(interintra))


def read_frame_header(r: BitReader, sp: SequenceParams,
                      ref_hints_by_slot=None) -> FrameParams:
    """ref_hints_by_slot: the decoder's per-DPB-slot order hints (len
    8), needed to mirror the skip_mode_params derivation when the
    sequence codes order hints."""
    fp = FrameParams()
    reduced = sp.reduced_still_picture_header
    if reduced:
        fp.frame_type = KEY_FRAME
        fp.show_frame = True
        error_resilient = False
    else:
        assert r.f(1) == 0, "show_existing_frame unsupported in verifier"
        fp.frame_type = r.f(2)
        fp.show_frame = bool(r.f(1))
        if not fp.show_frame:
            fp.showable_frame = bool(r.f(1))
        if fp.frame_type == S_FRAME or (fp.frame_type == KEY_FRAME
                                        and fp.show_frame):
            error_resilient = True
        else:
            error_resilient = bool(r.f(1))
    is_intra = fp.frame_type in (KEY_FRAME, INTRA_ONLY_FRAME)
    fp.error_resilient_mode = error_resilient
    fp.disable_cdf_update = bool(r.f(1))
    if reduced:
        fp.allow_screen_content_tools = bool(r.f(1))  # force == SELECT
        assert not fp.allow_screen_content_tools
    elif sp.enable_screen_content:
        fp.allow_screen_content_tools = bool(r.f(1))
    else:
        fp.allow_screen_content_tools = False  # seq_force_sct == 0
    if not reduced and fp.frame_type != S_FRAME:
        assert r.f(1) == 0  # frame_size_override
    if sp.enable_order_hint:
        fp.order_hint = r.f(sp.order_hint_bits)
    if not (is_intra or error_resilient):
        fp.primary_ref_frame = r.f(3)
    if fp.frame_type == KEY_FRAME:
        if not fp.show_frame:
            fp.refresh_frame_flags = r.f(8)
    else:
        fp.refresh_frame_flags = r.f(8)
    if ((not is_intra or fp.refresh_frame_flags != 0xFF)
            and error_resilient and sp.enable_order_hint):
        fp.ref_order_hints = tuple(
            r.f(sp.order_hint_bits) for _ in range(8))
    if not is_intra:
        if sp.enable_order_hint:
            assert r.f(1) == 0, "frame_refs_short_signaling unsupported"
        fp.ref_frame_idx = tuple(r.f(3) for _ in range(7))
        if sp.enable_order_hint:
            slots = (fp.ref_order_hints if fp.ref_order_hints is not None
                     else ref_hints_by_slot)
            assert slots is not None, \
                "order hints on: decoder must pass ref_hints_by_slot"
            fp.ref_hints = tuple(
                slots[fp.ref_frame_idx[i]] for i in range(7))
    if fp.frame_type == S_FRAME:
        wbits = max(1, (sp.width - 1).bit_length())
        hbits = max(1, (sp.height - 1).bit_length())
        assert r.f(wbits) + 1 == sp.width
        assert r.f(hbits) + 1 == sp.height
    if sp.enable_superres:
        if r.f(1):
            fp.superres_denom = r.f(3) + 9
    if r.f(1):  # render_and_frame_size_different
        fp.render_width = r.f(16) + 1
        fp.render_height = r.f(16) + 1
    if is_intra:
        if fp.allow_screen_content_tools and fp.superres_denom == 8:
            assert r.f(1) == 0  # allow_intrabc (spec 5.9.11)
    else:
        fp.allow_high_precision_mv = bool(r.f(1))
        assert r.f(1) == 0  # is_filter_switchable
        fp.interpolation_filter = r.f(2)
        fp.is_motion_mode_switchable = bool(r.f(1))
        if (sp.enable_ref_frame_mvs and sp.enable_order_hint
                and not fp.error_resilient_mode):
            fp.use_ref_frame_mvs = bool(r.f(1))
    if not fp.disable_cdf_update:
        fp.disable_frame_end_update_cdf = bool(r.f(1))
    # tile info (uniform spacing)
    assert r.f(1) == 1  # uniform spacing
    coded_w_ti = fp.coded_width(sp.width)
    sb_cols = (coded_w_ti + 63) >> 6
    sb_rows = (sp.height + 63) >> 6
    max_log2_tile_cols = _tile_log2(1, min(sb_cols, 64))
    max_log2_tile_rows = _tile_log2(1, min(sb_rows, 64))
    min_log2_tile_cols = _tile_log2(4096 >> 6, sb_cols)
    min_log2_tiles = max(min_log2_tile_cols,
                         _tile_log2((4096 * 2304) >> 12,
                                    sb_rows * sb_cols))
    log2_cols = min_log2_tile_cols
    while log2_cols < max_log2_tile_cols and r.f(1):
        log2_cols += 1
    log2_rows = max(min_log2_tiles - log2_cols, 0)
    while log2_rows < max_log2_tile_rows and r.f(1):
        log2_rows += 1
    fp.log2_tile_cols = log2_cols
    fp.log2_tile_rows = log2_rows
    if log2_cols > 0 or log2_rows > 0:
        assert r.f(log2_rows + log2_cols) == 0  # context_update_tile_id
        assert r.f(2) == 3  # tile_size_bytes_minus_1
    fp.base_q_idx = r.f(8)
    assert r.f(1) == 0  # y dc delta
    if not sp.monochrome:
        assert r.f(1) == 0
        assert r.f(1) == 0
    assert r.f(1) == 0  # qm
    from svt_av1_tpu_torch.codec import segmentation as seg_mod
    fp.segmentation = seg_mod.read_params(
        r, primary_ref_none=fp.primary_ref_frame == PRIMARY_REF_NONE
        or is_intra)
    if fp.base_q_idx > 0:
        fp.delta_q_present = bool(r.f(1))
        if fp.delta_q_present:
            fp.delta_q_res = r.f(2)
    if fp.delta_q_present:
        assert r.f(1) == 0  # delta_lf_present
    l0 = r.f(6)
    l1 = r.f(6)
    fp.filter_level = (l0, l1)
    if not sp.monochrome and (l0 or l1):
        fp.filter_level_uv = (r.f(6), r.f(6))
    fp.sharpness = r.f(3)
    assert r.f(1) == 0  # lf delta enabled
    if sp.enable_cdef:
        fp.cdef_damping = r.f(2) + 3
        fp.cdef_bits = r.f(2)
        sets = []
        for _ in range(1 << fp.cdef_bits):
            pri_y = r.f(4)
            sec_y = r.f(2)
            pri_uv = sec_uv = 0
            if not sp.monochrome:
                pri_uv = r.f(4)
                sec_uv = r.f(2)
            sets.append((pri_y, sec_y, pri_uv, sec_uv))
        fp.cdef_strengths = sets[0]
        fp.cdef_strength_list = tuple(sets) if fp.cdef_bits else None
    if sp.enable_restoration:
        _LR_TYPE = {(0, 0): 0, (1, 0): 1, (1, 1): 2, (0, 1): 3}
        fp.lr_types = tuple(_LR_TYPE[(r.f(1), r.f(1))] for _ in range(3))
        if any(t != 0 for t in fp.lr_types):
            size = 64
            if r.f(1):
                size = 256 if r.f(1) else 128
            fp.lr_unit_size = size
        if fp.lr_types[1] != 0 or fp.lr_types[2] != 0:
            fp.lr_uv_half = bool(r.f(1))
    fp.tx_mode_select = bool(r.f(1))
    if not is_intra:
        fp.reference_select = bool(r.f(1))
    if (not is_intra and fp.reference_select and sp.enable_order_hint
            and skip_mode_refs(fp.order_hint, fp.ref_hints,
                               sp.order_hint_bits) is not None):
        fp.skip_mode_present = bool(r.f(1))
    fp.reduced_tx_set = bool(r.f(1))
    if not is_intra:
        gms = []
        for _ in range(7):
            if r.f(1) == 0:   # is_global
                gms.append(None)
                continue
            if r.f(1):   # is_rot_zoom
                mx_a = 1 << 12
                c2 = _wb_read_signed_subexpfin(r, mx_a + 1, 3, 0)
                c3 = _wb_read_signed_subexpfin(r, mx_a + 1, 3, 0)
                mat2 = ((c2 + (1 << 15)) << 1)
                mat3 = c3 << 1
                mx_t = 1 << 12
                mat0 = _wb_read_signed_subexpfin(r, mx_t + 1, 3, 0) << 10
                mat1 = _wb_read_signed_subexpfin(r, mx_t + 1, 3, 0) << 10
                gms.append((mat0, mat1, mat2, mat3, -mat3, mat2))
                continue
            assert r.f(1) == 1, "AFFINE gm unsupported"
            col = _wb_read_signed_subexpfin(r, (1 << 8) + 1, 3, 0) * 2
            row = _wb_read_signed_subexpfin(r, (1 << 8) + 1, 3, 0) * 2
            gms.append((row, col))
        fp.gm_trans = tuple(gms)
    if sp.film_grain_params_present and fp.show_frame:
        from svt_av1_tpu_torch.codec.film_grain import read_film_grain_params
        fp.film_grain = read_film_grain_params(
            r, frame_type_key=fp.frame_type == KEY_FRAME)
    return fp
