"""Encoder handle for the port: svt_av1_tpu/api/encoder.py for the
port's slice.

  Encoder(config, device)   ~ svt_av1_enc_init_handle + init
  enc.send_picture(y, u, v) ~ svt_av1_enc_send_picture
  enc.flush()               ~ send_picture(NULL, eos)
  enc.send_pictures(frames) ~ batched svt_av1_enc_send_picture
  enc.get_packet()          ~ svt_av1_enc_get_packet
  enc.stream_header()       ~ svt_av1_enc_stream_header
  enc.reconfigure(...)      ~ svt_av1_enc_set_parameter between pictures
  enc.get_stream_info(0)    ~ svt_av1_enc_get_stream_info (pass-1 stats)

Slice: 4:2:0 at every preset (M0-M13), DLF, CDEF and loop restoration
on or off, at 8 or 10 bits (uint16 planes; at 10 bits no palette, and
send_pictures takes the per-block route, as in the reference): all-intra
(intra_period_length -2 or 0); hierarchical (random-access) GOPs with
hierarchical_levels 1-5 (mini-GoPs of 2-32 frames) and
intra_period_length > 0 or -1 (one key frame, then key frames at scene
cuts only), with or without the lookahead (MCTF, enable_tf; TPL,
enable_tpl_la); and IPPP / low-delay GOPs (hierarchical_levels 0 or
pred_structure != 2), with S-frames (sframe_dist).  An 8-bit single-tile
grain-free hierarchical GOP without S-frames takes the reference's fast
path (gop_fast.run_inter_frame: at M0-M8 its inter frames search the
inter tx type and the OBMC and inter-intra motion modes, at M0-M6 the
8x8 split and TMVP too, at M0-M4 a third, GOLDEN-role reference); every
other inter frame takes its stage path (inter_encoder.encode_inter_frame:
pass A over the references, the compound probe, pass B with K1 on every
luma wave), each frame then filtered and packetized as a key frame is.
All-intra streams also take superres (superres_mode > 0: half width
where the coded width is a multiple of 32), film grain (parameters
estimated from the first frame's source, pipeline/noise_model.py; in a
GOP on every frame) and adaptive quantization
(enable_adaptive_quantization 1: a per-64x64 variance qindex map coded
as delta-q; 2: the same deltas as SEG_LVL_ALT_Q segments) on
``send_picture`` key frames at presets without varpart (M5-M13).  AVIF
(avif) codes one still key frame with the reduced still-picture
header; a second picture raises ValueError.  encoder_color_format is
not read: every stream is 4:2:0, as in the reference.

Rate control on every route: CQP/CRF, capped CRF (max_bit_rate), one-pass
VBR / CBR (rate_control_mode 1 / 2: OnePassRC picks each frame's qindex,
each GOP frame's at dispatch; the coded bits go back after entropy
coding), and two passes (pass_ 1 collects the stats blob that get_stats
returns; pass_ 2 codes each frame at the qindex its plan gives).  Under
one-pass VBR / CBR an all-intra ``send_picture`` frame over 8x its
budget is coded once more at a higher qindex (the recode loop).
``send_pictures`` picks one qindex per 32-frame chunk.  HDR metadata
(content_light, mastering_display) rides the first temporal unit;
stat_report puts per-frame PSNR / SSIM on ``Packet.stats``
(utils/metrics.py).  Tile columns (tile_columns, log2) are coded on the
array route of ``send_pictures`` only: tile-clamped availability in the
wave loop and one native coder call per tile; every other route codes one
tile, and tile_rows is not used, as in the reference.

As in the reference, a GOP codes without superres; a hierarchical GOP's
key frames take loop restoration on the fast path (the DPB slot holds the
restored planes; its inter frames signal RESTORE_NONE), and on the stage
path every frame takes the filters and loop restoration of a key frame.
Tile columns (tile_columns) in a GOP code one tile, as the reference's
per-block packetization does.  The feature overrides (SVT_TPU_FEAT, and
SVT_TPU_EXACT_RATES for the rate model) turn on the tools no preset uses
where the reference reads them: rdoq on the key frames of the preset's
frame program and on ``send_pictures``; hp_mv (1/8-pel MVs) and
adapted_rates (MD rate tables from the CDFs of the newest stored frame,
as the dispatch finds them) on the fast path's inter frames.

An IPPP / low-delay GOP codes each frame as it arrives (_drain,
_encode_frame): with MCTF a key frame waits for its next two frames and
is filtered against them and the previous source frame; every inter
frame predicts from slot 0 (the last frame) and chains its CDFs from it;
every sframe_dist-th inter frame is an S-frame (error resilient, default
CDFs, refresh-all); under one-pass VBR / CBR an inter frame over 3x its
budget is coded once more at a higher qindex.

In a hierarchical GOP, ``send_picture`` holds frames until a mini-GoP is
complete (or ``flush``), then codes it in decode order: the base frame,
the mid layers, and show-existing packets for hidden frames.  Key frames
take the intra path below (their filters as the reference's GOP key
frames take them: per-SB CDEF strengths at M0-M4); on the fast path each
inter frame runs the two device programs of pipeline/gop_fast.py, every
frame of the mini-GoP dispatched before the first is entropy-coded; on
the stage path each is coded in turn, its CDFs chained from its LAST
slot.  The DPB's recon stays on
the device; a slot is freed after its last use in the mini-GoP.  At M0-M4
(mref) the mid frames also search the mini-GoP's anchor, the base frame
the previous mini-GoP's anchor, which the DPB keeps one mini-GoP longer.

The lookahead, as in the reference: MCTF (pipeline/tf_stage.py) filters
each key frame's source against its next two frames and each mini-GoP
base's against up to three neighbours before they are coded.  With TPL
a key frame waits until a mini-GoP of frames follows it; TPL
(gop_fast.tpl_group_stats, pipeline/tpl.py) over the key's IPP chain
sets its qindex (rate_control.crf_qindex_calc) and a per-64x64 qindex
map, coded as delta-q where it is not uniform; TPL over each mini-GoP in
decode order, with an IPP tail into the next one, sets every frame's
qindex from its r0.

``send_picture`` codes one key frame at a time with the preset's whole
tool set (at M0-M4 the 64/32/16 variable-partition program,
pipeline/varpart.py, with the filter-intra pseudo-modes; at M5-M8 the
tx-type search, angle deltas, CfL, palette on screen content; GOP key
frames at M0-M4 take the M5-M8 tools plus filter-intra and no palette),
runs the in-loop filters as the reference's stage path does (DLF level
search at M0-M8, mask-aware where 32/64 leaves mix with 16x16 ones, the
qindex heuristic level at M9-M13; CDEF strength search over the
preset's candidates, per 64x64 superblock at M0-M4; with superres the
normative upscale; loop restoration, pipeline/lr_stage.py, searched
against the full-width source) and packetizes the
per-block decisions with the object tile coder.  ``send_pictures`` runs
the batched program with the preset's plain luma modes (as the
reference's does) and the array-native C tile coder, or, with CDEF or
filter-intra on, the object coder and no source for the filters: the
heuristic DLF level, CDEF signaled with zero strengths and loop
restoration with RESTORE_NONE, as the reference does.  Mode decision and
the filters run on ``device``
(pipeline/intra_encoder.py, pipeline/varpart.py, pipeline/dlf_stage.py,
pipeline/cdef_stage.py; default: the current CUDA device); recon stays
there until the filtered planes are copied out.  Entropy coding is the
port's copy of the host coder (codec/syntax.py, native/ec_native.c).
"""
from __future__ import annotations

import dataclasses
import re
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Deque, Dict, Optional

import numpy as np
import torch

from svt_av1_tpu_torch import device as device_mod
from svt_av1_tpu_torch.api.config import ConfigError, EncoderConfig
from svt_av1_tpu_torch.codec import fast_ec, obu
from svt_av1_tpu_torch.codec import constants as cc
from svt_av1_tpu_torch.codec import mv as mv_mod
from svt_av1_tpu_torch.codec import mv_pred
from svt_av1_tpu_torch.codec.syntax import TileEncoder
from svt_av1_tpu_torch.codec import lr as lr_mod
from svt_av1_tpu_torch.codec.film_grain import default_grain_params
from svt_av1_tpu_torch.ops import resize
from svt_av1_tpu_torch.pipeline import (cdef_stage, dlf_stage, gop, gop_fast,
                                        inter_encoder, intra_encoder,
                                        lr_stage, noise_model, tf_stage, tpl)
from svt_av1_tpu_torch.pipeline import varpart as varpart_mod
from svt_av1_tpu_torch.pipeline.dlf_stage import default_filter_level
from svt_av1_tpu_torch.pipeline.presets import features_for
from svt_av1_tpu_torch.pipeline import rate_control as rc_mod
from svt_av1_tpu_torch.pipeline.rate_control import (RateControlState,
                                                     crf_qindex_calc,
                                                     qp_to_qindex)
from svt_av1_tpu_torch.utils import metrics, profiling
from svt_av1_tpu_torch.utils.profiling import stage

__all__ = ["Encoder", "EncoderConfig", "Packet", "qp_to_qindex"]

CHUNK = 32   # frames per device batch (the reference's send_pictures)


@dataclasses.dataclass
class Packet:
    data: bytes
    pts: int               # display order of the content (poc)
    frame_type: int
    recon: Optional[Dict[str, np.ndarray]] = None
    stats: Optional[dict] = None   # stat_report: per-frame PSNR / SSIM
    displayed: bool = True  # False for hidden (show_frame=0) frames


def _align16(x: int) -> int:
    return (x + 15) & ~15


def _variance_qmap(y: np.ndarray, base_q: int) -> np.ndarray:
    """Per-64x64 qindex from luma variance (the variance-boost AQ
    analog, Docs/Appendix-Variance-Boost.md): smooth superblocks get a
    lower qindex (banding protection), busy ones a higher one.  Deltas
    are multiples of 1 << delta_q_res (= 4)."""
    h, w = y.shape
    sh, sw = (h + 63) // 64, (w + 63) // 64
    qmap = np.zeros((sh, sw), np.int32)
    yp = np.pad(y.astype(np.float64), ((0, sh * 64 - h), (0, sw * 64 - w)),
                mode="edge")
    blocks = yp.reshape(sh, 64, sw, 64).transpose(0, 2, 1, 3)
    var = blocks.var(axis=(2, 3)) + 1.0
    med = max(float(np.median(var)), 1.0)
    delta = np.clip(np.round(np.log2(var / med) * 2.0), -3, 3) * 4
    # positive deltas must keep base_q+delta congruent mod
    # (1 << delta_q_res) below 255, or the decoder's clamped
    # CurrentQIndex diverges from the qindex we quantized with
    res_mask = (1 << 2) - 1  # delta_q_res = 2
    delta_hi = (255 - base_q) & ~res_mask
    delta = np.clip(delta.astype(np.int32), None, delta_hi)
    return np.clip(base_q + delta, 1, 255)


def _segment_qmap(y: np.ndarray, base_q: int):
    """Segment-based AQ: variance deltas -> SEG_LVL_ALT_Q segments.

    Returns ((SegmentationParams, per-SB segment-id map), per-SB qindex
    map for the MD quantizer)."""
    from svt_av1_tpu_torch.codec import segmentation as seg_mod
    h, w = y.shape
    sh, sw = (h + 63) // 64, (w + 63) // 64
    yp = np.pad(y.astype(np.float64),
                ((0, sh * 64 - h), (0, sw * 64 - w)), mode="edge")
    blocks = yp.reshape(sh, 64, sw, 64).transpose(0, 2, 1, 3)
    var = blocks.var(axis=(2, 3)) + 1.0
    med = max(float(np.median(var)), 1.0)
    delta = (np.clip(np.round(np.log2(var / med) * 2.0), -3, 3) * 4
             ).astype(np.int32)
    deltas = sorted(set(delta.reshape(-1).tolist()))[:8]
    seg_of = {d: i for i, d in enumerate(deltas)}
    seg_map = np.vectorize(
        lambda d: seg_of.get(d, len(deltas) - 1))(delta).astype(np.int32)
    params = seg_mod.alt_q_params(deltas)
    qmap = np.clip(base_q + np.array(deltas, np.int32)[seg_map], 1, 255)
    return (params, seg_map), qmap


def _tile_layout(width: int, tile_columns: int):
    """The uniform tile-column layout (superblock units) for the
    configured log2 tile_columns, clamped to 0-4 as in the reference."""
    return obu.tile_cols_layout(width, max(0, min(int(tile_columns), 4)))


def _skip_map(decisions, gh: int, gw: int) -> np.ndarray:
    """(gh, gw) bool: skip flag per 16x16 cell, filled from each leaf
    decision's true block size."""
    m = np.zeros((gh, gw), bool)
    for d in decisions.values():
        by, bx = d.r4 // 4, d.c4 // 4
        nw = max(1, int(cc.block_size_wide[d.bsize]) >> 4)
        nh = max(1, int(cc.block_size_high[d.bsize]) >> 4)
        m[by:by + nh, bx:bx + nw] = d.skip
    return m


def _skip_map8(decisions, gh8: int, gw8: int) -> np.ndarray:
    """(gh8, gw8) bool: skip flag per 8x8 CDEF unit from each leaf's
    true extent — the spec granularity (an 8x8 unit is skipped iff all
    its mi are skip)."""
    m = np.zeros((gh8, gw8), bool)
    for d in decisions.values():
        nw = max(1, int(cc.block_size_wide[d.bsize]) >> 3)
        nh = max(1, int(cc.block_size_high[d.bsize]) >> 3)
        by, bx = d.r4 // 2, d.c4 // 2
        m[by:by + nh, bx:bx + nw] = d.skip
    return m


def _sframe_setup(fp):
    """The header of a switch frame: S_FRAME, error resilient, refresh
    every slot, default CDFs."""
    fp.frame_type = obu.S_FRAME
    fp.error_resilient_mode = True
    fp.refresh_frame_flags = 0xFF
    fp.primary_ref_frame = obu.PRIMARY_REF_NONE


class Encoder:
    def __init__(self, config: EncoderConfig, device=None):
        self.cfg = config.validate()
        self.device = device_mod.resolve(device)
        fast_ec.available()        # builds the native coder or raises
        self.render_w = config.source_width
        self.render_h = config.source_height
        self.coded_w = _align16(config.source_width)
        self.coded_h = _align16(config.source_height)
        # superres: half width, all-intra only, and only where the
        # downscaled width keeps the 16-px grid (as in the reference)
        self.sr_denom = 8
        if (config.superres_mode > 0
                and config.intra_period_length in (-2, 0)
                and self.coded_w % 32 == 0):
            self.sr_denom = 16
        self.sr_w = (self.coded_w * 8 + self.sr_denom // 2) // self.sr_denom
        self.bd = config.encoder_bit_depth
        self.sp = obu.SequenceParams(
            width=self.coded_w, height=self.coded_h, bit_depth=self.bd,
            still_picture=config.avif,
            reduced_still_picture_header=config.avif,
            enable_cdef=config.cdef_level > 0,
            enable_superres=self.sr_denom != 8,
            enable_restoration=config.enable_restoration_filtering > 0,
            film_grain_params_present=config.film_grain_denoise_strength > 0)
        # film grain parameters: estimated from the first key frame's
        # source, kept for the sequence
        self._grain_params = None
        self._grain_estimated = False
        self._feat = features_for(config.enc_mode)
        # palette presets signal SELECT_SCREEN_CONTENT_TOOLS in the
        # sequence header at 8 bits; a frame turns the tools on when it
        # has palette candidates
        self.sp.enable_screen_content = bool(self._feat.palette
                                             and self.bd == 8)
        # filter-intra: the sequence flag and the MD pseudo-modes
        self.sp.enable_filter_intra = self._feat.filter_intra
        self.sp.enable_interintra_compound = self._feat.interintra
        self._md_modes = self._feat.intra_modes
        if self._feat.filter_intra:
            self._md_modes = self._feat.intra_modes + intra_encoder.FI_MODES
        self._packets: Deque[Packet] = deque()
        self._la: Deque = deque()      # submitted, not yet coded
        self._pts = 0
        # two-pass: pass 1 collects (bits, qindex, is_key) per frame, pass
        # 2 codes each frame at the qindex its plan gives
        self._fp_stats = [] if config.pass_ == 1 else None
        self._q_plan = None
        self._eos_sent = False
        self._seq_hdr_sent = False
        # last (filtered) recon on the device and end-of-frame CDF state
        # (what an inter frame would predict from; kept as the reference
        # keeps them)
        self._ref: Optional[Dict[str, torch.Tensor]] = None
        self._ref_cdfs = None
        self._ref_nmv = None
        fps = (config.frame_rate_numerator
               / max(config.frame_rate_denominator, 1))
        self._rc = RateControlState.create(config, fps)
        if config.pass_ == 2 and config.rc_stats_buffer:
            self._q_plan = rc_mod.plan_second_pass(
                rc_mod.unpack_first_pass_stats(config.rc_stats_buffer),
                config.target_bit_rate, fps,
                min_q=max(4, config.min_qp_allowed * 4),
                max_q=min(255, config.max_qp_allowed * 4))
            self._rc.two_pass_q = self._q_plan
        # tile columns (log2): the array route of send_pictures codes
        # them (block-column starts from the spec's uniform spacing); every
        # other route codes one tile, and tile_rows is not used, as in the
        # reference
        layout = _tile_layout(self.sr_w, config.tile_columns)
        self._tile_starts = tuple(s * 4 for s, _ in layout)
        self._log2_tile_cols = (max(0, min(int(config.tile_columns), 4))
                                if len(layout) > 1 else 0)
        self._arf_q = None   # base-layer ratio qindex (crf_qindex_calc)
        # callers that do not read Packet.recon (a benchmark) turn this
        # off: shown GOP frames then skip the host copy of their recon
        self.recon_enabled = True
        # scene-cut detector state (all GOP modes)
        self._prev_hist = None
        self._ahd_running = None
        self._scene_cut = False
        self._last_ahd = 0.0
        # hierarchical (random access) GOP: hierarchical_levels > 0 with
        # inter frames and the random-access structure; any other GOP is
        # IPPP / low delay (_drain, _encode_frame)
        self._hier = 0
        # the newest stored frame's adapted CDFs (adapted_rates' tables)
        self._chain_cdfs = None
        if (config.hierarchical_levels > 0
                and config.intra_period_length not in (-2, 0)
                and config.pred_structure == 2):
            self._hier = min(5, config.hierarchical_levels)
            self._h_frames: Dict[int, tuple] = {}  # poc -> (y, u, v)
            self._h_next_in = 0       # next arriving poc
            self._h_sched = 0         # first unscheduled poc
            self._h_anchor = None     # display poc of the last coded anchor
            self._h_prev_anchor = None  # the anchor before it (mref)
            self._h_cuts = set()      # scene-cut pocs
            self._h_activity = {}     # poc -> mean AHD (dynamic mini-GoP)
            self._dpb: Dict[int, int] = {}         # stored poc -> slot
            self._slot_free = set(range(8))
            self._slot_recon: Dict[int, Dict] = {}  # slot -> device planes
            self._slot_state: Dict[int, tuple] = {}  # slot -> (cdfs, nmv)
            # slot -> saved motion field (spec 7.19; read by TMVP, 7.9)
            self._slot_mvfield: Dict[int, mv_pred.FrameMotionField] = {}
            self._slot_hint = [0] * 8
            self._h_anchor_src = None  # the anchor's padded source luma (TPL)
            # order hints let skip mode pick the (fwd, bwd) pair
            self.sp.enable_order_hint = True
            self.sp.enable_ref_frame_mvs = bool(self._feat.tmvp)
        # the fused fast GOP path (pipeline/gop_fast.py) codes 8-bit
        # single-tile grain-free hierarchical GOPs without S-frames; every
        # other inter frame takes the stage path
        # (pipeline/inter_encoder.encode_inter_frame), as in the reference
        self._fast = (self._hier > 0 and self.bd == 8
                      and self.sr_denom == 8
                      and config.film_grain_denoise_strength == 0
                      and self._log2_tile_cols == 0
                      and not config.avif and config.sframe_dist <= 0)
        # the last source frame (the backward neighbour of an IPPP key
        # frame's MCTF)
        self._tf_hist = []

    # -- API surface ---------------------------------------------------------
    def stream_header(self) -> bytes:
        return obu.write_sequence_header(self.sp)

    def send_picture(self, y, u, v, eos: bool = False):
        """Feed one frame (planar numpy: uint8, or uint16 at 10 bits).
        All-intra has no lookahead, so the frame is coded before this
        returns; an IPPP / low-delay GOP with MCTF holds a key frame until
        its next two frames are in; a hierarchical GOP holds frames until
        their mini-GoP is complete.  AVIF codes one picture: a second
        raises ValueError."""
        self._one_still(1)
        y, u, v = self._checked(y, u, v)
        if self._hier:
            self._detect_scene_cut(y)
            if self._scene_cut:
                self._h_cuts.add(self._h_next_in)
            self._h_activity[self._h_next_in] = self._last_ahd
            self._h_frames[self._h_next_in] = (y, u, v)
            self._h_next_in += 1
            self._drain_hier(flush=eos)
        else:
            self._la.append((y, u, v))
            self._drain(flush=eos)
        if eos:
            self._eos_sent = True

    def flush(self):
        """Signal EOS without a new picture."""
        if self._hier:
            self._drain_hier(flush=True)
        else:
            self._drain(flush=True)
        self._eos_sent = True

    def _drain(self, flush: bool = False):
        """Code the frames waiting in the lookahead, in order: all-intra
        frames at once; in an IPPP / low-delay GOP with MCTF, a key frame
        once its next two frames are in (or at ``flush``), filtered against
        the previous source frame and those two; the scene-cut detector
        sees every GOP frame as it is coded."""
        gop_mode = self.cfg.intra_period_length not in (-2, 0)
        while self._la:
            if (self._tf_active() and self._frame_is_key(self._pts)
                    and len(self._la) < 3 and not flush):
                return
            y, u, v = self._la.popleft()
            if gop_mode:
                self._detect_scene_cut(y)
            if self._tf_active() and self._frame_is_key(self._pts):
                neighbors = list(self._tf_hist) + list(self._la)[:2]
                if neighbors:
                    with stage("key_tf"):
                        y, u, v = tf_stage.mctf_filter_frame(
                            (y, u, v), neighbors, device=self.device)
            self._tf_hist = [(y, u, v)]
            self._packets.append(self._encode_frame(y, u, v, self._pts))
            self._pts += 1

    def _frame_is_key(self, pts: int) -> bool:
        """Key frames of an all-intra stream or an IPPP / low-delay GOP:
        every frame (intra_period_length -2 or 0), a scene cut, the first
        frame only (-1), or every N+1-th frame (N > 0)."""
        period = self.cfg.intra_period_length
        if period in (-2, 0):
            return True
        if self._scene_cut:
            return True
        if period == -1:
            return pts == 0
        return pts % (period + 1) == 0

    def _encode_frame(self, y, u, v, pts, qindex_override=None,
                      recode: bool = False) -> Packet:
        """One frame of an all-intra stream or an IPPP / low-delay GOP: its
        qindex (the pass-2 plan, one-pass VBR/CBR's pick, else the
        configured one; a GOP's key frames boosted), the superres
        downscale, AQ's qindex map on key frames, mode decision (the
        preset's intra tools, or the stage path's inter frame from the
        slot-0 reference), then the filters and object packetization; every
        sframe_dist-th inter frame is an S-frame (error resilient, default
        CDFs, refresh-all).  Under one-pass VBR/CBR a frame over 8x (key)
        or 3x (inter) its budget is coded once more at a higher qindex,
        from the same reference state (the recode loop); rate control, the
        first-pass stats and the stat report see the frame once, at the
        qindex it keeps."""
        is_key = self._frame_is_key(pts) or self._ref is None
        if qindex_override is not None:
            qindex = int(qindex_override)
        elif self._q_plan is not None and pts < len(self._q_plan):
            qindex = int(self._q_plan[pts])
        elif self._rc.onepass is not None:
            qindex = self._rc.pick_q(is_key, 0, pts)
        else:
            qindex = self._rc.frame_qindex()
        if (is_key and self.cfg.intra_period_length not in (-2, 0)
                and self._q_plan is None and qindex_override is None
                and self._rc.onepass is None):
            # key-frame boost: the whole GOP references its key frames;
            # a recode keeps its raised qindex
            qindex = max(1, qindex - qindex // self._feat.kf_boost_div)
        # what a recode rewinds: the reference state, and whether the
        # sequence header went out (the first attempt's packet is dropped)
        snap = (self._ref, self._ref_cdfs, self._ref_nmv,
                self._seq_hdr_sent)
        planes = (y, u, v)
        y, u, v = self._pad(y, u, v)
        src_full = dict(y=y, u=u, v=v)
        if self.sr_denom != 8:
            # encoder-side horizontal downscale (not normative); the loop
            # upscales back with the normative kernel
            y, u, v = (((p[:, 0::2].astype(np.int32)
                         + p[:, 1::2].astype(np.int32) + 1) >> 1
                        ).astype(p.dtype) for p in (y, u, v))
        qmap = seg_info = None
        if (self.cfg.enable_adaptive_quantization and is_key
                and not self._feat.varpart):
            if self.cfg.enable_adaptive_quantization == 2:
                # segment-based AQ: the variance deltas become
                # SEG_LVL_ALT_Q segments (segmentation.c role)
                seg_info, qmap = _segment_qmap(y, qindex)
            else:
                qmap = _variance_qmap(y, qindex)
        gm, interp, allow_sct = None, 0, False
        if is_key:
            decisions, recon, allow_sct = self._mode_decision(
                y, u, v, qindex, qmap=qmap, varpart=self._feat.varpart)
        else:
            with stage("device_md_inter"):
                decisions, recon, gm, interp = self._stage_inter(
                    y, u, v, self._ref, qindex)
        # switch frames (S_FRAME, Docs/Appendix-Switch-Frame.md role): every
        # sframe_dist-th inter frame codes as an error-resilient switch
        # point (default CDFs, refresh-all)
        sframe = (not is_key and self.cfg.sframe_dist > 0
                  and pts % self.cfg.sframe_dist == 0)
        pkt = self._packetize(decisions, recon, qindex, pts, is_key=is_key,
                              allow_sct=allow_sct, src=dict(y=y, u=u, v=v),
                              src_full=src_full,
                              delta_q=qmap is not None and seg_info is None,
                              seg=seg_info, gm=gm, interp=interp,
                              fp_setup=_sframe_setup if sframe else None)
        bits = len(pkt.data) * 8
        limit = (8.0 if is_key else 3.0) * self._rc.target_bits_per_frame
        if (not recode and self._rc.mode in (1, 2) and self._q_plan is None
                and bits > limit and qindex < self._rc.max_qindex):
            (self._ref, self._ref_cdfs, self._ref_nmv,
             self._seq_hdr_sent) = snap
            return self._encode_frame(
                *planes, pts, recode=True,
                qindex_override=min(self._rc.max_qindex,
                                    max(qindex + 16, int(qindex * 1.25))))
        if self.cfg.stat_report:
            with stage("stat_report"):
                pkt.stats = metrics.frame_stats(src_full, pkt.recon, self.bd)
        self._rc.feedback(bits, qindex, is_key)
        if self._fp_stats is not None:
            self._fp_stats.append((bits, qindex, float(is_key)))
        return pkt

    def _stage_inter(self, y, u, v, refs, qindex):
        """The stage path's mode decision of one inter frame (padded
        source planes; refs: a plane dict or {ref_enum: plane dict}):
        (decisions, recon on the device, gm models, interp filter)."""
        return inter_encoder.encode_inter_frame(
            y, u, v, refs, qindex, modes=self._feat.intra_modes, bd=self.bd,
            hme_rad2=self._feat.hme_rad2, hme_rad0=self._feat.hme_rad0,
            subpel_ring=self._feat.subpel_ring,
            exact_rates=self._feat.exact_rates, device=self.device)

    def _mode_decision(self, y, u, v, qindex, qmap=None, varpart=False):
        """Palette candidates and the frame program with the preset's
        tools for one padded frame: (decisions, recon on the device,
        whether the frame turns the screen-content tools on).  qmap: the
        per-64x64 qindex map of a delta-q key frame (no palette then, as
        in the reference).  varpart: the 64/32/16 partition program
        (all-intra key frames at M0-M4); the presets that have it take
        no palette on any key frame, as in the reference."""
        if varpart and qmap is None:
            with stage("device_md_intra"):
                decisions, recon = varpart_mod.encode_intra_frame_varpart(
                    y, u, v, qindex, modes=self._md_modes, bd=self.bd,
                    device=self.device)
            return decisions, recon, False
        pal_cands = None
        if (self.sp.enable_screen_content and qmap is None
                and not self._feat.varpart):
            with stage("palette_md"):
                pal_cands = intra_encoder.palette_md_candidates(
                    y, qindex, device=self.device)
        with stage("device_md_intra"):
            decisions, recon = intra_encoder.encode_intra_frame(
                y, u, v, qindex, modes=self._md_modes, bd=self.bd,
                rdoq=self._feat.rdoq, tx_search=self._feat.tx_search,
                angle_deltas=self._feat.angle_deltas, cfl=self._feat.cfl,
                exact_rates=(self._feat.exact_rates
                             and self._feat.exact_rates_intra),
                palette_cands=pal_cands, qmap=qmap, device=self.device)
        return decisions, recon, pal_cands is not None

    def _packetize(self, decisions, recon, qindex, pts, is_key: bool = True,
                   allow_sct: bool = False, src=None, src_full=None,
                   prefilt=None, return_state: bool = False,
                   delta_q: bool = False, seg=None, fp_setup=None,
                   chain="auto", gm=None, interp: int = 0) -> Packet:
        """In-loop filters + entropy coding + OBU assembly for one frame
        from per-block decisions (the reference's stage-path
        ``_packetize``).  is_key: a key frame, else an inter frame of the
        stage path.  allow_sct: the frame has palette candidates, so it
        turns the screen-content tools on.  src: the padded source planes
        (numpy, at the superres width) the filter searches measure against;
        without it DLF takes the heuristic level, CDEF is signaled with zero
        strengths and loop restoration with RESTORE_NONE, as in the
        reference.  src_full: the full-width source loop restoration
        measures against under superres.  prefilt: the (recon, deblocked,
        header fields, cdef map) of gop_fast.run_key_filters, which has
        filtered the frame already.  return_state: also return the filtered
        recon and the tile encoder (its end-of-frame CDFs).  delta_q: the
        decisions carry per-block qindex values (a TPL or AQ qmap), coded
        as delta-q at delta_q_res 2.  seg: (SegmentationParams, per-SB
        segment ids) of segment AQ.  fp_setup: a callable that edits the
        frame header (a hierarchical GOP's show / refresh / references, an
        S-frame's).  chain: "auto" chains through slot 0 (an inter frame
        refreshes slot 0 and takes its CDFs from the last frame's, which
        becomes ``_ref``), None starts from the default CDFs, a (cdfs, nmv)
        pair starts from that state.  gm: {ref_enum: model} of the frame's
        global motion; interp: its interpolation filter."""
        frame_type = obu.KEY_FRAME if is_key else obu.INTER_FRAME
        fp = obu.FrameParams(frame_type=frame_type, show_frame=True,
                             base_q_idx=qindex,
                             render_width=self.render_w,
                             render_height=self.render_h)
        if is_key:
            fp.allow_screen_content_tools = allow_sct
        auto_chain = isinstance(chain, str) and chain == "auto"
        if not is_key and auto_chain:
            fp.refresh_frame_flags = 0x01
            if self._ref_cdfs is not None:
                fp.primary_ref_frame = 0      # chain CDFs from slot 0
        if gm:
            fp.gm_trans = tuple(gm.get(i + 1) for i in range(7))
        if not is_key:
            fp.interpolation_filter = interp
        if fp_setup is not None:
            fp_setup(fp)
        if seg is not None:
            fp.segmentation = seg[0]
        if self.cfg.film_grain_denoise_strength > 0:
            fp.film_grain = self._grain(**(src or {}))
        if prefilt is not None:
            recon, deblocked, fpu, cdef_idx = prefilt
            for k, val in fpu.items():
                setattr(fp, k, val)
        else:
            recon, deblocked, cdef_idx = self._filter(decisions, recon, fp,
                                                      qindex, src)
        if self.sr_denom != 8 and src is not None:
            # the normative upscale (spec 7.16): after CDEF, before loop
            # restoration, which works at the full width with its
            # deblocked boundary rows upscaled the same way
            fp.superres_denom = self.sr_denom
            recon = resize.upscale_frame(recon, self.coded_w, self.bd)
            deblocked = resize.upscale_frame(deblocked, self.coded_w,
                                             self.bd)
        lr_info = None
        if self.sp.enable_restoration and src is not None:
            with stage("restoration"):
                lr_info = lr_mod.make_lr_info(self.coded_w, self.coded_h)
                lr_stage.search_lr(src_full or src, recon, deblocked,
                                   lr_info, bd=self.bd,
                                   eps_set=self._feat.lr_eps)
                fp.lr_types = tuple(i.frame_type for i in lr_info)
                recon = lr_stage.apply_lr(recon, deblocked, lr_info,
                                          bd=self.bd)
        init_cdfs = init_nmv = None
        if auto_chain:
            self._ref = recon
            if fp.primary_ref_frame != obu.PRIMARY_REF_NONE:
                init_cdfs, init_nmv = self._ref_cdfs, self._ref_nmv
        elif chain is not None:
            init_cdfs, init_nmv = chain
        tenc = TileEncoder(self.sr_w, self.sp.height, qindex,
                           reduced_tx_set=fp.reduced_tx_set,
                           update_cdfs=not fp.disable_cdf_update,
                           frame_is_intra=is_key, init_cdfs=init_cdfs,
                           init_nmv=init_nmv)
        if lr_info is not None:
            tenc.set_lr(lr_info)
        tenc.enable_filter_intra = self.sp.enable_filter_intra
        tenc.allow_palette = bool(fp.allow_screen_content_tools)
        tenc.bit_depth = self.bd
        tenc.enable_masked_compound = self.sp.enable_masked_compound
        tenc.enable_interintra = self.sp.enable_interintra_compound
        tenc.is_motion_mode_switchable = fp.is_motion_mode_switchable
        if not is_key:
            fp.reference_select = any(d.ref2 for d in decisions.values()
                                      if d.is_inter)
            tenc.reference_select = fp.reference_select
        if self.sp.enable_order_hint:
            bits = self.sp.order_hint_bits
            fp.order_hint = pts & ((1 << bits) - 1)
            if not is_key:
                fp.ref_hints = tuple(self._slot_hint[i]
                                     for i in fp.ref_frame_idx)
                if fp.error_resilient_mode or fp.frame_type == obu.S_FRAME:
                    fp.ref_order_hints = tuple(self._slot_hint)
                sm_pair = (obu.skip_mode_refs(fp.order_hint, fp.ref_hints,
                                              bits)
                           if fp.reference_select else None)
                fp.skip_mode_present = sm_pair is not None
                if fp.skip_mode_present:
                    tenc.skip_mode_present = True
                    tenc.skip_mode_frames = sm_pair
                    tenc.interp_filter = fp.interpolation_filter
        if delta_q:
            fp.delta_q_present = True
            fp.delta_q_res = 2
            tenc.set_delta_q(fp.delta_q_res)
        if seg is not None:
            # per-SB segment ids -> mi granularity for the tile coder
            mi_map = np.repeat(np.repeat(seg[1], 16, 0), 16, 1)
            tenc.set_segmentation(fp.segmentation,
                                  mi_map[:tenc.mi_rows, :tenc.mi_cols])
        if fp.cdef_bits:
            # per-SB strengths: each SB's index is coded at its first
            # non-skip block
            tenc.set_cdef(fp.cdef_bits, cdef_idx)
        if not is_key:
            tenc.set_gm(fp.gm_trans)
        with stage("host_ec"):
            # the C array walk codes no segment ids, yet TileEncoder.encode
            # takes it for plain 16x16 DCT frames whatever their
            # segmentation (the reference's stream then does not decode,
            # ROADMAP.md queue C item 4 (d)): segment AQ frames take the
            # per-block coder, which codes them as the spec reads them
            tile_data = tenc.encode(decisions, use_native=seg is None)
        if auto_chain and not fp.disable_frame_end_update_cdf:
            self._ref_cdfs = tenc.cdfs
            self._ref_nmv = tenc.nmv
        pkt = self._assemble(fp, tile_data, recon, pts,
                             frame_type=frame_type)
        if return_state:
            return pkt, recon, tenc
        return pkt

    def _filter(self, decisions, recon, fp, qindex, src):
        """The reference's stage path for a key frame: DLF (level search
        at M0-M8 when the source is at hand, else the heuristic level;
        mask-aware where the frame mixes 16/32/64 leaves), then CDEF when
        the source is at hand (strength search over the preset's
        candidates, per SB at M0-M4 (cdef_bits > 0), then apply), both at
        the superres width.  Sets the header fields; recon stays on the
        device.  Returns (recon, the deblocked planes before CDEF, the
        per-SB cdef index map or None)."""
        searches = ((self.cfg.enable_dlf_flag and self._feat.dlf_search)
                    or self.sp.enable_cdef)
        if src is not None and searches:
            src = dict(zip(src, intra_encoder.source_planes(
                src.values(), self.bd, self.device)))
        if self.cfg.enable_dlf_flag:
            # uniform filtering is conformant on the fixed 16x16 grid;
            # frames with varpart 32/64 leaves take the mask-aware filter
            mixed = any(d.bsize != cc.BLOCK_16X16
                        for d in decisions.values())
            with stage("dlf"):
                if mixed:
                    flens = dlf_stage.flens_from_maps(
                        dlf_stage.maps_from_decisions(
                            decisions, self.coded_h // 4, self.sr_w // 4),
                        device=self.device)
                    if self._feat.dlf_search and src is not None:
                        recon = dlf_stage.search_and_apply_masked(
                            src, recon, fp, flens, bd=self.bd)
                    else:
                        self._heuristic_dlf_levels(fp, qindex)
                        recon = dlf_stage.apply_masked(recon, fp, flens,
                                                       bd=self.bd)
                elif self._feat.dlf_search and src is not None:
                    # per-plane level search (dlf_process.c:106-131)
                    recon = dlf_stage.search_and_apply(src, recon, fp,
                                                       bd=self.bd)
                else:
                    self._heuristic_dlf_levels(fp, qindex)
                    recon = intra_encoder.apply_loop_filter(recon, fp)
        deblocked = recon
        cdef_idx = None
        if self.sp.enable_cdef and src is not None:
            skip16 = _skip_map(decisions, self.coded_h // 16,
                               self.sr_w // 16)
            fp.cdef_damping = cdef_stage.cdef_damping(qindex)
            with stage("cdef"):
                if self._feat.cdef_sb:
                    bits, sets, cdef_idx = cdef_stage.cdef_search_sb(
                        src, recon, skip16, qindex, bd=self.bd,
                        max_candidates=self._feat.cdef_candidates)
                    fp.cdef_bits = bits
                    fp.cdef_strengths = sets[0]
                    fp.cdef_strength_list = sets if bits else None
                    recon = cdef_stage.cdef_apply(recon, skip16, sets,
                                                  fp.cdef_damping, self.bd,
                                                  sb_idx=cdef_idx)
                else:
                    fp.cdef_strengths = cdef_stage.cdef_search(
                        src, recon, skip16, qindex, bd=self.bd,
                        max_candidates=self._feat.cdef_candidates)
                    recon = cdef_stage.cdef_apply(recon, skip16,
                                                  fp.cdef_strengths,
                                                  fp.cdef_damping, self.bd)
        return recon, deblocked, cdef_idx

    @staticmethod
    def _heuristic_dlf_levels(fp, qindex: int):
        lvl_y = default_filter_level(qindex)
        fp.filter_level = (lvl_y, lvl_y)
        lvl_uv = max(0, lvl_y - 2)
        fp.filter_level_uv = (lvl_uv, lvl_uv)

    def send_pictures(self, frames, eos: bool = False):
        """Batched submit: frames = [(y, u, v), ...] uint8 planes (uint16
        at 10 bits).  Each chunk of up to 32 frames runs as one device
        batch with the preset's plain luma modes; the host entropy-codes
        chunk k while the device works on chunk k+1.  As in the reference, frames take
        the array tile coder unless CDEF or loop restoration is on (or
        qindex is 0): then the per-block route, whose packetization has no
        source, so DLF takes the heuristic level, CDEF is signaled with
        zero strengths and loop restoration with RESTORE_NONE; 10-bit
        frames take the per-block route too.  With superres, frames go
        through send_picture one at a time, as in the reference."""
        self._one_still(len(frames))
        if self.sr_denom != 8:
            for (y, u, v) in frames:
                self.send_picture(y, u, v)
            if eos:
                self._eos_sent = True
            return
        if self.cfg.intra_period_length not in (-2, 0):
            # a GOP with inter frames: the sequential path; eos drains the
            # last (partial) mini-GoP, or an IPPP key frame still waiting
            # for its MCTF neighbours, as send_picture(..., eos=True) does
            for (y, u, v) in frames:
                self.send_picture(y, u, v)
            if eos:
                self.flush()
            return
        qindex = self._chunk_qindex()
        # filter-intra blocks take the object coder (the per-block route),
        # with the preset's pseudo-modes in the batch, as in the reference
        arrays_ok = (qindex > 0 and self.bd == 8
                     and not self.sp.enable_restoration
                     and not self.sp.enable_cdef
                     and not self.sp.enable_filter_intra)
        padded = [self._pad(*self._checked(y, u, v))
                  for (y, u, v) in frames]
        pending = None
        for i in range(0, len(padded), CHUNK):
            # one qindex a chunk, picked before the previous chunk's bits
            # come back (as the reference does)
            q = self._chunk_qindex() if i else qindex
            chunk = padded[i:i + CHUNK]
            with stage("device_dispatch"):
                launched = intra_encoder.encode_intra_frames_launch(
                    chunk, q,
                    modes=(self._feat.intra_modes if arrays_ok
                           else self._md_modes),
                    exact_rates=(self._feat.exact_rates
                                 and self._feat.exact_rates_intra),
                    tile_starts=self._tile_starts if arrays_ok else (0,),
                    rdoq=self._feat.rdoq, bd=self.bd, device=self.device)
            if pending is not None:
                self._emit(*pending, arrays_ok)
            pending = (launched, q, chunk)
        if pending is not None:
            self._emit(*pending, arrays_ok)
        if eos:
            self._eos_sent = True

    def _chunk_qindex(self) -> int:
        """A send_pictures chunk's qindex: one-pass VBR/CBR's key-frame
        pick at the next pts, else the configured one (capped CRF's
        offset included)."""
        if self._rc.onepass is not None:
            return self._rc.pick_q(True, 0, self._pts)
        return self._rc.frame_qindex()

    def _emit(self, pending, qindex: int, srcs, arrays_ok: bool):
        with stage("device_wait_transfer"):
            results = intra_encoder.encode_intra_frames_finish(
                pending, as_arrays=arrays_ok)
        for (decisions, recon), src in zip(results, srcs):
            if arrays_ok:
                pkt = self._packetize_arrays(decisions, recon, qindex,
                                             self._pts)
            else:
                pkt = self._packetize(decisions, recon, qindex, self._pts)
            if self.cfg.stat_report:
                with stage("stat_report"):
                    pkt.stats = metrics.frame_stats(
                        dict(y=src[0], u=src[1], v=src[2]), pkt.recon,
                        self.bd)
            self._packets.append(pkt)
            bits = len(pkt.data) * 8
            self._rc.feedback(bits, qindex, True)
            if self._fp_stats is not None:
                self._fp_stats.append((bits, qindex, 1.0))
            self._pts += 1

    def _packetize_arrays(self, bundle, recon, qindex, pts) -> Packet:
        """Array-native key-frame packetization through the C coder: one
        tile, or with tile columns one coder call per tile on a thread
        pool (each with its own coder state; the frame-end CDFs are tile
        0's, context_update_tile_id = 0)."""
        ym, um, qy, qu, qv, gh, gw = bundle
        fp = obu.FrameParams(frame_type=obu.KEY_FRAME, show_frame=True,
                             base_q_idx=qindex,
                             render_width=self.render_w,
                             render_height=self.render_h)
        if self.cfg.film_grain_denoise_strength > 0:
            fp.film_grain = self._grain()
        if self.cfg.enable_dlf_flag:
            self._heuristic_dlf_levels(fp, qindex)
            with stage("dlf"):
                recon = intra_encoder.apply_loop_filter(recon, fp)
        self._ref = recon
        starts = self._tile_starts
        if len(starts) > 1:
            fp.log2_tile_cols = self._log2_tile_cols
            bounds = list(zip(starts, starts[1:] + (gw,)))

            def cut(a, c0, c1):
                return np.ascontiguousarray(
                    a.reshape(gh, gw, -1)[:, c0:c1]).reshape(
                        gh * (c1 - c0), -1)

            def enc_tile(b):
                c0, c1 = b
                te = TileEncoder((c1 - c0) * 16, self.sp.height, qindex,
                                 update_cdfs=True, frame_is_intra=True)
                data = fast_ec.encode_intra_tile_arrays(
                    te, cut(ym, c0, c1).reshape(-1),
                    cut(um, c0, c1).reshape(-1), cut(qy, c0, c1),
                    cut(qu, c0, c1), cut(qv, c0, c1))
                return data, te

            with stage("host_ec"):
                with ThreadPoolExecutor(len(bounds)) as pool:
                    results = list(pool.map(enc_tile, bounds))
            tile_data = [d for d, _ in results]
            tenc = results[0][1]
        else:
            tenc = TileEncoder(self.sp.width, self.sp.height, qindex,
                               update_cdfs=True, frame_is_intra=True)
            with stage("host_ec"):
                tile_data = fast_ec.encode_intra_tile_arrays(tenc, ym, um,
                                                             qy, qu, qv)
        self._ref_cdfs = tenc.cdfs
        self._ref_nmv = tenc.nmv
        return self._assemble(fp, tile_data, recon, pts)

    def _grain(self, y=None, u=None, v=None):
        """Film-grain parameters for the frame header: the AR-model
        estimate from the source (noise_model.c:2279 role) on the first
        key frame, kept for the sequence; the strength preset when the
        source is clean, the fit fails or no source is at hand (as in the
        reference, a host-side model fit)."""
        if not self._grain_estimated and y is not None:
            self._grain_estimated = True
            try:
                p, _ = noise_model.estimate_grain_params(y, u, v,
                                                         bd=self.bd)
            except Exception:
                p = None
            self._grain_params = p
        if self._grain_params is not None:
            return self._grain_params
        return default_grain_params(self.cfg.film_grain_denoise_strength)

    def _assemble(self, fp, tile_data, recon, pts,
                  frame_type=None) -> Packet:
        """The temporal unit (with the sequence header on the first) and
        the recon (device tensors) cropped to the render size and copied
        to the host.  frame_type: the packet's (the header's by default;
        an S-frame's packet says INTER_FRAME, as in the reference)."""
        tu = obu.temporal_delimiter() + self._stream_start()
        tu += obu.write_frame_obu(self.sp, fp, tile_data)
        return Packet(data=tu, pts=pts,
                      frame_type=(fp.frame_type if frame_type is None
                                  else frame_type),
                      recon=self._host_recon(recon))

    def _stream_start(self) -> bytes:
        """The sequence header and the HDR metadata OBUs on the stream's
        first temporal unit; nothing after it."""
        if self._seq_hdr_sent:
            return b""
        out = obu.write_sequence_header(self.sp) + self._metadata_obus()
        self._seq_hdr_sent = True
        return out

    def _metadata_obus(self) -> bytes:
        """The content-light-level and mastering-display metadata OBUs of
        the configuration's strings ("max_cll,max_fall";
        "G(x,y)B(x,y)R(x,y)WP(x,y)L(max,min)"); a malformed string raises
        ConfigError."""
        out = b""
        if self.cfg.content_light:
            try:
                cll, fall = (int(x) for x in
                             self.cfg.content_light.split(","))
                out += obu.write_metadata_hdr_cll(cll, fall)
            except ValueError:
                raise ConfigError("bad content-light string") from None
        if self.cfg.mastering_display:
            m = {k: (float(a), float(b)) for k, a, b in re.findall(
                r"(G|B|R|WP|L)\(([\d.]+),([\d.]+)\)",
                self.cfg.mastering_display)}
            if set(m) != {"G", "B", "R", "WP", "L"}:
                raise ConfigError("bad mastering-display string")
            out += obu.write_metadata_hdr_mdcv(
                (m["R"], m["G"], m["B"]), m["WP"], m["L"][0], m["L"][1])
        return out

    def _host_recon(self, recon):
        """Device planes cropped to the render size, copied to the host
        (key frames always; shown GOP inter and show-existing frames only
        with ``recon_enabled``, as in the reference)."""
        ch, cw = (self.render_h + 1) // 2, (self.render_w + 1) // 2
        host = intra_encoder.host_plane
        return dict(y=host(recon["y"][:self.render_h, :self.render_w]),
                    u=host(recon["u"][:ch, :cw]),
                    v=host(recon["v"][:ch, :cw]))

    # -- hierarchical (random access) GOP ------------------------------------
    def _is_key_poc(self, poc: int) -> bool:
        period = self.cfg.intra_period_length
        if poc == 0 or poc in self._h_cuts:
            return True
        if period == -1:
            return False           # one key frame, then scene cuts only
        return poc % (period + 1) == 0

    def _tf_active(self) -> bool:
        return (self.cfg.enable_tf > 0
                and self.cfg.intra_period_length not in (-2, 0))

    def _drain_hier(self, flush: bool):
        """Schedule complete mini-GoPs from the lookahead (pd_process.c
        mini-GoP assembly)."""
        N = 1 << self._hier
        while True:
            p0 = self._h_sched
            if p0 not in self._h_frames:
                return
            if self._h_anchor is None or self._is_key_poc(p0):
                if self.cfg.enable_tpl_la and not flush:
                    # hold the key until its TPL lookahead is in
                    la = 0
                    while (p0 + 1 + la in self._h_frames
                           and not self._is_key_poc(p0 + 1 + la)):
                        la += 1
                    if la < N:
                        return
                self._encode_key_job(p0)
                self._h_sched = p0 + 1
                continue
            avail = 0
            while p0 + avail in self._h_frames:
                avail += 1
            # dynamic mini-GoP sizing: high-activity windows halve the
            # pyramid
            N_eff = N
            if N >= 4:
                win = [self._h_activity.get(p0 + i, 0.0)
                       for i in range(min(N, max(avail, 1)))]
                if win and max(win) > 0.5 * self._SCENE_TH:
                    N_eff = N // 2
            n = 0
            while n < min(N_eff, avail):
                if self._is_key_poc(p0 + n):
                    break
                n += 1
            if (n < N_eff and n == avail and not flush
                    and not self._is_key_poc(p0 + n)):
                return  # the mini-GoP may still grow
            self._encode_minigop(p0, n)
            self._h_sched = p0 + n

    def _finish_packet(self, pkt: Packet, qindex: int, layer: int = 0):
        """Queue a coded GOP frame; its bits go to rate control (every
        coded frame takes the per-frame bandwidth credit; show-existing
        packets are not routed through it) and the first-pass stats."""
        self._packets.append(pkt)
        key = pkt.frame_type == obu.KEY_FRAME
        self._rc.feedback(len(pkt.data) * 8, qindex, key, layer)
        if self._fp_stats is not None:
            self._fp_stats.append((len(pkt.data) * 8, qindex, float(key)))

    def _encode_key_job(self, poc: int):
        """A GOP key frame: MCTF against its next two frames, TPL over its
        IPP chain (its qindex and delta-q map), the preset's intra MD, the
        filters (on the fast path the fused key-filter program where the
        preset searches them, else the stage path's filters in
        _packetize), packetization; the frame becomes the only DPB
        entry."""
        y, u, v = self._h_frames.pop(poc)
        if self._tf_active():
            neighbors = [self._h_frames[p] for p in (poc + 1, poc + 2)
                         if p in self._h_frames]
            if neighbors:
                with stage("key_tf"):
                    y, u, v = tf_stage.mctf_filter_frame(
                        (y, u, v), neighbors, device=self.device)
        y, u, v = self._pad(y, u, v)
        qindex = self._base_q_for(poc)
        qmap = None
        if self.cfg.enable_tpl_la:
            # TPL over the key + lookahead IPP chain: how much does the
            # future lean on this key frame (and on which of its SBs)?
            chain = [y]
            for p in range(poc + 1, poc + 1 + (1 << self._hier)):
                if p not in self._h_frames or self._is_key_poc(p):
                    break
                chain.append(self._pad(*self._h_frames[p])[0])
            deps = [None] + [[i - 1] for i in range(1, len(chain))]
            with stage("key_tpl"):
                stats = self._tpl_stats(chain, deps)
            dep0 = tpl.synthesize(stats, deps)[0]
            qindex, self._arf_q = crf_qindex_calc(
                qindex, tpl.r0_of(stats[0], dep0), 0, self._hier, True,
                bd=self.bd)
            qmap = tpl.beta_qmap(stats[0], dep0, qindex, bd=self.bd)
            if np.all(qmap == qindex):
                qmap = None
        else:
            qindex = max(1, qindex - qindex // self._feat.kf_boost_div)
        decisions, recon, allow_sct = self._mode_decision(y, u, v, qindex,
                                                          qmap)
        prefilt = None
        dlf_wants = bool(self.cfg.enable_dlf_flag)
        if (self._fast and (dlf_wants or self.sp.enable_cdef)
                and (not dlf_wants or self._feat.dlf_search)):
            skip16 = _skip_map(decisions, self.coded_h // 16,
                               self.coded_w // 16)
            with stage("key_filters"):
                prefilt = gop_fast.run_key_filters(
                    dict(y=y, u=u, v=v), recon, skip16, qindex,
                    cdef_cands=cdef_stage.SEARCH_SET[
                        :self._feat.cdef_candidates],
                    dlf_on=dlf_wants, cdef_on=self.sp.enable_cdef,
                    max_bits=3 if self._feat.cdef_sb else 0)
        with stage("key_packetize"):
            pkt, full, tenc = self._packetize(
                decisions, recon, qindex, poc, allow_sct=allow_sct,
                src=dict(y=y, u=u, v=v), prefilt=prefilt, return_state=True,
                delta_q=qmap is not None, chain=None)
        self._h_anchor_src = y
        # key refresh: the map keeps the key in slot 0 only
        self._dpb = {poc: 0}
        self._slot_free = set(range(1, 8))
        self._slot_recon = {0: full}
        self._slot_state = {0: (tenc.cdfs, tenc.nmv)}
        self._chain_cdfs = tenc.cdfs
        self._slot_mvfield = {}
        self._slot_hint = [poc & ((1 << self.sp.order_hint_bits) - 1)] * 8
        self._h_anchor = poc
        self._h_prev_anchor = None
        self._finish_packet(pkt, qindex)

    def _base_q_for(self, poc: int) -> int:
        """A GOP frame's base qindex: the pass-2 plan, else one-pass
        VBR/CBR's pick (at layer 0), else the configured one (capped
        CRF's offset included)."""
        if self._q_plan is not None and poc < len(self._q_plan):
            return int(self._q_plan[poc])
        if self._rc.onepass is not None:
            return self._rc.pick_q(self._is_key_poc(poc), 0, poc)
        return self._rc.frame_qindex()

    def _tpl_stats(self, srcs, deps):
        """TPL's dispenser stats of a lookahead group (srcs: padded luma
        planes; deps[i]: reference indices or None): one batched program
        on the fast path (gop_fast.tpl_group_stats), else one
        tpl.tpl_frame_stats per frame, as in the reference."""
        if self._fast:
            return gop_fast.tpl_group_stats(srcs, deps, device=self.device)
        return [tpl.tpl_frame_stats(
            srcs[i], None if not d else [srcs[j] for j in d],
            device=self.device) for i, d in enumerate(deps)]

    def _encode_minigop(self, p0: int, n: int):
        """Code the mini-GoP after the anchor: MCTF of its base, TPL over
        it (the frames' qindex), then on the fast path every inter frame's
        device programs are dispatched (the recon chain stays on the
        device), then each is collected and entropy-coded in decode order;
        on the stage path each frame is coded in turn
        (_encode_inter_job).  A DPB slot is freed after its last use."""
        anchor = self._h_anchor
        assert anchor == p0 - 1
        events = gop.minigop_schedule(anchor, n)
        end_poc = anchor + n
        if self._tf_active() and n >= 2:
            # MCTF of the mini-GoP base (the alt-ref role, pd_process.c,
            # temporal_filtering.c): every other frame of the pyramid
            # predicts from it.  Neighbours: the adjacent sources on both
            # sides still in the lookahead window.
            neigh = [self._h_frames[p]
                     for p in (end_poc - 1, end_poc + 1, end_poc - 2,
                               end_poc + 2)
                     if p in self._h_frames and not self._is_key_poc(p)]
            if neigh:
                with stage("gop_tf"):
                    self._h_frames[end_poc] = tf_stage.mctf_filter_frame(
                        self._h_frames[end_poc], neigh[:3],
                        device=self.device)
        base_q = self._base_q_for(p0)
        tpl_r0 = None
        if self.cfg.enable_tpl_la:
            tpl_r0 = self._minigop_tpl(anchor, p0, n, events)
        mref = self._feat.mref and self._fast
        if mref:
            # the base frame's GOLDEN-role reference: the previous
            # mini-GoP's anchor, kept alive one extra mini-GoP (keep_poc)
            prev = self._h_prev_anchor
            if (prev is not None and prev in self._dpb
                    and isinstance(events[0], gop.CodeEvent)):
                events[0].gld_poc = prev
        last_use: Dict[int, int] = {}
        for i, ev in enumerate(events):
            if isinstance(ev, gop.CodeEvent):
                last_use[ev.last_poc] = i
                if ev.bwd_poc is not None:
                    last_use[ev.bwd_poc] = i
                if mref and ev.gld_poc is not None:
                    last_use[ev.gld_poc] = max(i,
                                               last_use.get(ev.gld_poc, 0))
            else:
                last_use[ev.poc] = i
        # the anchor stays stored past this mini-GoP, so that the next
        # base can search it as GOLDEN (freed there after its last use)
        keep_poc = anchor if mref else None

        def q_for(ev):
            if self._rc.onepass is not None and self._q_plan is None:
                # one-pass VBR/CBR: each frame's pick from the buffer
                # model at dispatch, before any frame of the mini-GoP is
                # entropy-coded
                return self._rc.pick_q(False, ev.layer, ev.poc)
            if tpl_r0 is not None:
                # the reference's CRF model (rc_process.c): the base
                # scales its qstep by sqrt(r0), mid layers interpolate
                # from the base's q toward cq, leaves code at cq
                q, arf = crf_qindex_calc(
                    base_q, tpl_r0[ev.poc], ev.layer, self._hier, False,
                    arf_q=self._arf_q, ref_layer=max(0, ev.layer - 1),
                    is_leaf=ev.layer >= self._hier, bd=self.bd)
                if ev.layer == 0:
                    self._arf_q = arf
                return q
            return gop.layer_qindex(base_q, ev.layer, self._hier + 1)

        if not self._fast:
            # the stage path, one frame at a time in decode order (its
            # qindex: TPL's, else the layer offset from the base qindex,
            # as in the reference); a slot is freed after its last use
            for i, ev in enumerate(events):
                if isinstance(ev, gop.CodeEvent):
                    q = (q_for(ev) if tpl_r0 is not None
                         else gop.layer_qindex(base_q, ev.layer,
                                               self._hier + 1))
                    self._encode_inter_job(ev, q)
                else:
                    slot = self._dpb[ev.poc]
                    self._emit_show_existing(ev.poc, slot,
                                             self._slot_recon[slot])
                for poc, li in list(last_use.items()):
                    if li == i and poc != end_poc and poc in self._dpb:
                        slot = self._dpb.pop(poc)
                        self._slot_free.add(slot)
                        self._slot_recon.pop(slot, None)
                        self._slot_state.pop(slot, None)
            self._h_anchor = end_poc
            self._h_prev_anchor = anchor
            return
        records = []
        for i, ev in enumerate(events):
            if isinstance(ev, gop.CodeEvent):
                q = q_for(ev)
                with stage("dispatch_inter"):
                    records.append(self._dispatch_inter_fast(ev, q))
            else:
                slot = self._dpb[ev.poc]
                records.append(("show", ev.poc, slot,
                                self._slot_recon[slot]))
            for poc, li in list(last_use.items()):
                if (li == i and poc != end_poc and poc != keep_poc
                        and poc in self._dpb):
                    slot = self._dpb.pop(poc)
                    self._slot_free.add(slot)
                    self._slot_recon.pop(slot, None)
        for rec in records:
            if rec[0] == "show":
                self._emit_show_existing(rec[1], rec[2], rec[3])
            else:
                self._collect_inter_fast(rec)
        self._h_anchor = end_poc
        self._h_prev_anchor = anchor

    def _minigop_tpl(self, anchor: int, p0: int, n: int, events):
        """TPL over the anchor and the mini-GoP along both pyramid edges
        (LAST + ALTREF), in decode order so that the reverse pass sees
        every child before its reference, extended by an IPP tail into
        the next mini-GoP so that the next anchor earns its credit (the
        reference's lad_mg window).  Returns {poc: r0}."""
        src_of = {anchor: self._h_anchor_src}
        for p in range(p0, p0 + n):
            src_of[p] = self._pad(*self._h_frames[p])[0]
        end_poc = anchor + n
        tail = []
        for p in range(end_poc + 1, end_poc + 1 + n):
            if p not in self._h_frames or self._is_key_poc(p):
                break
            src_of[p] = self._pad(*self._h_frames[p])[0]
            tail.append(p)
        order, deps = tpl.minigop_group(anchor, events, tail)
        with stage("gop_tpl"):
            stats = self._tpl_stats([src_of[p] for p in order], deps)
        with stage("gop_tpl_synth"):
            mc_dep = tpl.synthesize(stats, deps)
        self._h_anchor_src = src_of[end_poc]
        return {p: tpl.r0_of(stats[i], mc_dep[i])
                for i, p in enumerate(order)}

    def _dispatch_inter_fast(self, ev, qindex: int):
        """Run P1 + P2 of one inter frame and register its device recon as
        its DPB slot; no host copy is waited for here."""
        y, u, v = self._pad(*self._h_frames.pop(ev.poc))
        last_slot = self._dpb[ev.last_poc]
        refs = {mv_pred.LAST_FRAME: self._slot_recon[last_slot]}
        bwd_slot = None
        if ev.bwd_poc is not None:
            bwd_slot = self._dpb[ev.bwd_poc]
            refs[mv_pred.ALTREF_FRAME] = self._slot_recon[bwd_slot]
        gld_slot = None
        if (self._feat.mref and ev.gld_poc is not None
                and ev.gld_poc in self._dpb):
            # the third reference (M0-M4): pass A searches it too
            gld_slot = self._dpb[ev.gld_poc]
            refs[mv_pred.GOLDEN_FRAME] = self._slot_recon[gld_slot]
        src_pack = np.concatenate(
            [y, np.concatenate([u, v], axis=1)], axis=0)
        # adapted_rates: the newest adapted CDFs at dispatch (the mini-GoP
        # is dispatched before it is collected, so they lag by one stage,
        # as in the reference)
        cdf_state = self._chain_cdfs if self._feat.adapted_rates else None
        pend = gop_fast.run_inter_frame(
            src_pack, refs, qindex, self.coded_h, self.coded_w,
            modes=self._feat.intra_modes, ring=self._feat.subpel_ring,
            rad2=self._feat.hme_rad2, rad0=self._feat.hme_rad0,
            cdef_cands=cdef_stage.SEARCH_SET[:self._feat.cdef_candidates],
            dlf_on=bool(self.cfg.enable_dlf_flag),
            cdef_on=self.sp.enable_cdef, cdf_state=cdf_state,
            hp=self._feat.hp_mv, obmc=self._feat.obmc,
            interintra=self._feat.interintra,
            exact_rates=self._feat.exact_rates,
            skip_mode=self.sp.enable_order_hint,
            tx_search=self._feat.tx_search, split8=self._feat.part8,
            device=self.device)
        slot = min(self._slot_free) if ev.store else None
        # the reference order hints in decode order (later dispatches may
        # overwrite slot hints before this frame is collected)
        idx = [last_slot] * 7
        if bwd_slot is not None:
            # the backward ref maps only to ALTREF, so that the skip-mode
            # derivation picks (LAST, ALTREF), the pair compound signals
            idx[mv_pred.ALTREF_FRAME - 1] = bwd_slot
        if gld_slot is not None:
            idx[mv_pred.GOLDEN_FRAME - 1] = gld_slot
        ref_hints = tuple(self._slot_hint[i] for i in idx)
        if ev.store:
            self._slot_free.remove(slot)
            self._dpb[ev.poc] = slot
            self._slot_recon[slot] = pend.recon
            self._slot_hint[slot] = \
                ev.poc & ((1 << self.sp.order_hint_bits) - 1)
        return ("code", ev, pend, qindex, last_slot, slot, tuple(idx),
                ref_hints, (y, u, v))

    def _collect_inter_fast(self, rec):
        """The bundled host copy, entropy coding and the packet (with the
        stat report against the frame's padded source)."""
        _, ev, pend, qindex, last_slot, slot, idx, ref_hints, src = rec
        with stage("device_md_inter"):
            decisions, recon_dev, header = gop_fast.collect_inter_frame(pend)
        pkt, tenc = self._packetize_fast(decisions, header, qindex, ev,
                                         last_slot, slot, idx, ref_hints)
        if ev.store:
            self._slot_state[slot] = (tenc.cdfs, tenc.nmv)
            self._chain_cdfs = tenc.cdfs
        pkt.displayed = ev.shown
        if ev.shown and (self.recon_enabled or self.cfg.stat_report):
            pkt.recon = self._host_recon(recon_dev)
            if self.cfg.stat_report:
                with stage("stat_report"):
                    pkt.stats = metrics.frame_stats(
                        dict(y=src[0], u=src[1], v=src[2]), pkt.recon)
        self._finish_packet(pkt, qindex, ev.layer)

    def _encode_inter_job(self, ev, qindex: int):
        """One inter frame of a hierarchical GOP on the stage path: mode
        decision against its LAST (and ALTREF) slots
        (inter_encoder.encode_inter_frame), then _packetize with the
        filters and the frame header of its place in the pyramid (show,
        refresh of its slot, references; CDFs from its LAST slot); a
        stored frame's filtered recon and end-of-frame state fill its
        slot."""
        y, u, v = self._pad(*self._h_frames.pop(ev.poc))
        last_slot = self._dpb[ev.last_poc]
        refs = {mv_pred.LAST_FRAME: self._slot_recon[last_slot]}
        bwd_slot = None
        if ev.bwd_poc is not None:
            bwd_slot = self._dpb[ev.bwd_poc]
            refs[mv_pred.ALTREF_FRAME] = self._slot_recon[bwd_slot]
        with stage("device_md_inter"):
            decisions, recon, gm, interp = self._stage_inter(y, u, v, refs,
                                                             qindex)
        slot = min(self._slot_free) if ev.store else None
        if ev.store:
            self._slot_free.remove(slot)

        def fp_setup(fp):
            fp.show_frame = ev.shown
            fp.showable_frame = not ev.shown
            fp.refresh_frame_flags = (1 << slot) if ev.store else 0
            idx = [last_slot] * 7
            if bwd_slot is not None:
                # the backward ref maps only to ALTREF, so that the
                # skip-mode derivation picks (LAST, ALTREF), the pair
                # compound signals
                idx[mv_pred.ALTREF_FRAME - 1] = bwd_slot
            fp.ref_frame_idx = tuple(idx)
            fp.primary_ref_frame = 0        # CDFs from LAST's slot

        pkt, full, tenc = self._packetize(
            decisions, recon, qindex, ev.poc, is_key=False,
            src=dict(y=y, u=u, v=v), chain=self._slot_state[last_slot],
            fp_setup=fp_setup, return_state=True, gm=gm, interp=interp)
        if ev.store:
            self._dpb[ev.poc] = slot
            self._slot_recon[slot] = full
            self._slot_state[slot] = (tenc.cdfs, tenc.nmv)
            self._chain_cdfs = tenc.cdfs
            self._slot_hint[slot] = \
                ev.poc & ((1 << self.sp.order_hint_bits) - 1)
        pkt.displayed = ev.shown
        if not ev.shown:
            pkt.recon = None
        self._finish_packet(pkt, qindex, ev.layer)

    def _emit_show_existing(self, poc: int, slot: int, recon_dev):
        """The show_existing_frame packet of the hidden frame ``poc`` stored
        in ``slot`` (its device planes ``recon_dev``, copied to the host
        with recon_enabled or stat_report)."""
        data = obu.temporal_delimiter() + obu.write_show_existing(slot)
        self._packets.append(Packet(
            data=data, pts=poc, frame_type=obu.INTER_FRAME,
            recon=(self._host_recon(recon_dev)
                   if self.recon_enabled or self.cfg.stat_report
                   else None)))

    def _packetize_fast(self, decisions, header, qindex, ev, last_slot,
                        slot, idx, ref_hints):
        """OBU assembly of an inter frame: the filter decisions arrive in
        ``header`` (P2 ran them on the device)."""
        fp = obu.FrameParams(frame_type=obu.INTER_FRAME,
                             show_frame=ev.shown, base_q_idx=qindex,
                             render_width=self.render_w,
                             render_height=self.render_h)
        fp.showable_frame = not ev.shown
        fp.refresh_frame_flags = (1 << slot) if ev.store else 0
        fp.ref_frame_idx = idx
        fp.primary_ref_frame = 0
        gm = header["gm"]
        fp.gm_trans = tuple(gm.get(i + 1) for i in range(7))
        fp.interpolation_filter = header["interp"]
        if self.cfg.enable_dlf_flag:
            ly, lu, lv = header["dlf_levels"]
            fp.filter_level = (ly, ly)
            fp.filter_level_uv = (lu, lv)
        if header["cdef"] is not None:
            fp.cdef_damping = cdef_stage.cdef_damping(qindex)
            fp.cdef_bits = header["cdef"]["bits"]
            fp.cdef_strengths = header["cdef"]["sets"][0]
        fp.reference_select = any(
            d.ref2 for d in decisions.values() if d.is_inter)
        fp.allow_high_precision_mv = self._feat.hp_mv
        fp.is_motion_mode_switchable = self._feat.obmc
        bits = self.sp.order_hint_bits
        fp.order_hint = ev.poc & ((1 << bits) - 1)
        fp.ref_hints = ref_hints
        sm_pair = (obu.skip_mode_refs(fp.order_hint, fp.ref_hints, bits)
                   if fp.reference_select and self.sp.enable_order_hint
                   else None)
        fp.skip_mode_present = sm_pair is not None
        fp.use_ref_frame_mvs = bool(self.sp.enable_ref_frame_mvs
                                    and self.sp.enable_order_hint
                                    and not fp.error_resilient_mode)
        init = self._slot_state[last_slot]
        tenc = TileEncoder(self.coded_w, self.sp.height, qindex,
                           reduced_tx_set=fp.reduced_tx_set,
                           update_cdfs=not fp.disable_cdf_update,
                           frame_is_intra=False, init_cdfs=init[0],
                           init_nmv=init[1])
        if fp.skip_mode_present:
            tenc.skip_mode_present = True
            tenc.skip_mode_frames = sm_pair
            tenc.interp_filter = fp.interpolation_filter
        tenc.enable_filter_intra = self.sp.enable_filter_intra
        tenc.enable_masked_compound = self.sp.enable_masked_compound
        tenc.enable_interintra = self.sp.enable_interintra_compound
        tenc.is_motion_mode_switchable = fp.is_motion_mode_switchable
        tenc.reference_select = fp.reference_select
        if fp.allow_high_precision_mv:
            tenc.mv_precision = mv_mod.MV_SUBPEL_HIGH
        tenc.set_gm(fp.gm_trans)
        tenc.cur_hint = fp.order_hint
        tenc.ref_hints = {e: fp.ref_hints[e - 1] for e in range(1, 8)}
        tenc.order_hint_bits = bits
        if fp.use_ref_frame_mvs:
            with stage("tmvp_setup"):
                tenc.tmvp = mv_pred.setup_motion_field(
                    {e: self._slot_mvfield.get(idx[e - 1])
                     for e in range(1, 8)}, tenc.ref_hints, fp.order_hint,
                    bits, tenc.mi_rows, tenc.mi_cols,
                    fp.allow_high_precision_mv)
        with stage("host_ec"):
            tile_data = tenc.encode(decisions)
        if ev.store and self.sp.enable_ref_frame_mvs:
            side = mv_pred.ref_frame_side(tenc.ref_hints, fp.order_hint, bits)
            with stage("save_mvfield"):
                self._slot_mvfield[slot] = mv_pred.save_motion_field(
                    decisions, tenc.mi_rows, tenc.mi_cols, side,
                    fp.ref_hints, fp.order_hint, is_intra=False)
        tu = obu.temporal_delimiter() + self._stream_start()
        tu += obu.write_frame_obu(self.sp, fp, tile_data)
        return Packet(data=tu, pts=ev.poc, frame_type=obu.INTER_FRAME), tenc

    # region-vote scene-change detector (pd_process.c:274-365): per-region
    # 256-bin histogram AHD against a running average, with fade
    # suppression; a cut when >= 50% of the regions vote
    _SCENE_TH = 3000.0 / 4096.0
    _FADE_TH = 3

    def _detect_scene_cut(self, y: np.ndarray) -> None:
        # histograms of the 8-bit scale at any bit depth
        yy = np.asarray(y).astype(np.int64) >> (self.bd - 8)
        h, w = yy.shape
        R = 4 if h >= 64 else 1
        C = 4 if w >= 64 else 1
        rid = (np.minimum(np.arange(h) * R // h, R - 1)[:, None] * C
               + np.minimum(np.arange(w) * C // w, C - 1)[None, :])
        flat_id = rid.reshape(-1)
        hist = np.bincount(flat_id * 256 + yy.reshape(-1),
                           minlength=R * C * 256) \
            .reshape(R * C, 256).astype(np.float64)
        npix = hist.sum(axis=1)
        hist /= npix[:, None]
        means = (np.bincount(flat_id, weights=yy.reshape(-1),
                             minlength=R * C) / npix)
        self._last_ahd = 0.0
        if self._prev_hist is None:
            self._scene_cut = False
            self._ahd_running = None
        else:
            prev_hist, prev_means = self._prev_hist
            ahd = np.abs(hist - prev_hist).sum(axis=1)
            if self._ahd_running is None:
                self._ahd_running = ahd.copy()
            ahd_err = np.abs(self._ahd_running - ahd)
            abrupt = (ahd_err > self._SCENE_TH) & (ahd >= ahd_err)
            aid = np.abs(means - prev_means)
            scene = abrupt & (aid >= self._FADE_TH)
            self._ahd_running = np.where(
                abrupt, self._ahd_running,
                (3.0 * self._ahd_running + ahd) / 4.0)
            vote_th = (R * C + 1) // 2
            self._scene_cut = int(scene.sum()) >= vote_th
            self._last_ahd = float(ahd.mean())
            if int(abrupt.sum()) >= vote_th:
                self._ahd_running = ahd.copy()
        self._prev_hist = (hist, means)

    def reconfigure(self, target_bit_rate=None, qp=None):
        """Change the rate target or the base quantizer between pictures
        without resetting the encoder: one-pass VBR/CBR retargets its
        buffer model and keeps the correction factors it has learned."""
        if target_bit_rate is not None:
            self.cfg.target_bit_rate = int(target_bit_rate)
            fps = (self.cfg.frame_rate_numerator
                   / max(self.cfg.frame_rate_denominator, 1))
            self._rc.target_bits_per_frame = \
                max(target_bit_rate, 1) / max(fps, 1e-6)
            if self._rc.onepass is not None:
                op = self._rc.onepass
                bw = max(float(target_bit_rate), 1.0)
                op.avg_frame_bandwidth = bw / max(fps, 1e-6)
                op.optimal_buffer_level = 0.600 * bw
                op.maximum_buffer_size = 1.000 * bw
                op.buffer_level = min(op.buffer_level,
                                      op.maximum_buffer_size)
        if qp is not None:
            if not (0 <= qp <= 63):
                raise ConfigError(f"bad qp {qp}")
            self.cfg.qp = int(qp)
            self._rc.qindex = qp_to_qindex(qp)

    def get_stats(self) -> bytes:
        """Pass 1's stats blob, (bits, qindex, is_key) per coded frame;
        pass 2 takes it as EncoderConfig.rc_stats_buffer."""
        assert self._fp_stats is not None, "not a pass-1 encoder"
        return rc_mod.pack_first_pass_stats(self._fp_stats)

    def get_stream_info(self, info_id: int = 0):
        """Stream info by id: 0 is the first-pass stats blob."""
        if info_id == 0:
            return self.get_stats()
        raise ValueError(f"unknown stream info id {info_id}")

    def send_eos(self):
        self._eos_sent = True

    def get_packet(self) -> Optional[Packet]:
        if self._packets:
            return self._packets.popleft()
        return None

    @property
    def done(self) -> bool:
        return self._eos_sent and not self._packets

    def stage_stats(self):
        """Per-stage host timing accumulated since process start."""
        return profiling.stage_stats()

    # -- internals -----------------------------------------------------------
    def _checked(self, y, u, v):
        """The planes as numpy arrays, after the geometry and dtype
        checks."""
        y, u, v = np.asarray(y), np.asarray(u), np.asarray(v)
        eh, ew = self.render_h, self.render_w
        ch, cw = (eh + 1) // 2, (ew + 1) // 2
        if y.shape != (eh, ew) or u.shape != (ch, cw) or v.shape != (ch, cw):
            raise ValueError(
                f"picture plane shapes {y.shape}/{u.shape}/{v.shape} do not "
                f"match the configured {ew}x{eh} 4:2:0 geometry")
        want = np.uint8 if self.bd == 8 else np.uint16
        if y.dtype != want or u.dtype != want or v.dtype != want:
            raise ValueError(f"picture dtype {y.dtype}/{u.dtype}/{v.dtype} "
                             f"does not match encoder_bit_depth={self.bd} "
                             f"(expected {np.dtype(want).name})")
        return y, u, v

    def _one_still(self, n: int):
        """AVIF (single-picture) mode codes exactly one picture: raise
        ValueError before a second one is taken (as the reference's
        enc_handle.c:5367-5373 rejects it)."""
        if self.cfg.avif and self._pts + len(self._la) + n > 1:
            raise ValueError("AVIF mode supports exactly one input picture")

    def _pad(self, y, u, v):
        """Edge-replicate to the coded (16-aligned) size."""
        eh, ew = self.render_h, self.render_w
        if self.coded_w == ew and self.coded_h == eh:
            return y, u, v
        py = self.coded_h - eh
        px = self.coded_w - ew
        y = np.pad(y, ((0, py), (0, px)), mode="edge")
        u = np.pad(u, ((0, py // 2), (0, px // 2)), mode="edge")
        v = np.pad(v, ((0, py // 2), (0, px // 2)), mode="edge")
        return y, u, v
