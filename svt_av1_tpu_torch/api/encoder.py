"""Encoder handle for the port: the all-intra half of
svt_av1_tpu/api/encoder.py.

  Encoder(config, device)   ~ svt_av1_enc_init_handle + init
  enc.send_picture(y, u, v) ~ svt_av1_enc_send_picture
  enc.flush()               ~ send_picture(NULL, eos)
  enc.send_pictures(frames) ~ batched svt_av1_enc_send_picture
  enc.get_packet()          ~ svt_av1_enc_get_packet
  enc.stream_header()       ~ svt_av1_enc_stream_header

Slice: 8-bit 4:2:0, CQP/CRF, one tile, no AQ, DLF and frame-uniform CDEF
on or off, and LR, superres and film grain off; either all-intra
(intra_period_length -2 or 0) at presets M5-M13, or the hierarchical
(random-access) GOP of the reference's fast path at presets M5-M13 with
hierarchical_levels 1-3 and intra_period_length > 0, with or without the
lookahead (MCTF, enable_tf; TPL, enable_tpl_la); at M5-M8 its inter
frames search the inter tx type and the OBMC and inter-intra motion
modes, at M5-M6 the 8x8 split and TMVP too (gop_fast.run_inter_frame).
Any other configuration raises NotImplementedError naming the
ROADMAP.md item that brings it; nothing falls back to the JAX package.

In a GOP, ``send_picture`` holds frames until a mini-GoP is complete (or
``flush``), then codes it in decode order: the base frame, the mid
layers, and show-existing packets for hidden frames.  Key frames take the
intra path above (their filters as the reference's GOP key frames take
them); each inter frame runs the two device programs of
pipeline/gop_fast.py, every frame of the mini-GoP dispatched before the
first is entropy-coded.  The DPB's recon stays on the device; a slot is
freed after its last use in the mini-GoP.

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
tool set (at M5-M8: tx-type search, angle deltas, CfL, palette on screen
content), runs the in-loop filters as the reference's stage path does
(DLF level search at M5-M8, the qindex heuristic level at M9-M13; CDEF
strength search over the preset's candidates) and packetizes the
per-block decisions with the object tile coder.  ``send_pictures`` runs
the batched frame program with the preset's plain luma modes (as the
reference's does) and the array-native C tile coder, or with CDEF on the
object coder and no source for the filters: the heuristic DLF level and
CDEF signaled with zero strengths, as the reference does.  Mode decision
and the filters run on ``device`` (pipeline/intra_encoder.py,
pipeline/dlf_stage.py, pipeline/cdef_stage.py; default: the current CUDA
device); recon stays there until the filtered planes are copied out.
Entropy coding is the port's copy of the host coder (codec/syntax.py,
native/ec_native.c).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, Optional

import numpy as np
import torch

from svt_av1_tpu_torch import device as device_mod
from svt_av1_tpu_torch.api.config import EncoderConfig
from svt_av1_tpu_torch.codec import fast_ec, obu
from svt_av1_tpu_torch.codec import constants as cc
from svt_av1_tpu_torch.codec import mv_pred
from svt_av1_tpu_torch.codec.syntax import TileEncoder
from svt_av1_tpu_torch.pipeline import (cdef_stage, dlf_stage, gop, gop_fast,
                                        intra_encoder, tf_stage, tpl)
from svt_av1_tpu_torch.pipeline.dlf_stage import default_filter_level
from svt_av1_tpu_torch.pipeline.presets import features_for
from svt_av1_tpu_torch.pipeline.rate_control import (RateControlState,
                                                     crf_qindex_calc,
                                                     qp_to_qindex)
from svt_av1_tpu_torch.utils import profiling
from svt_av1_tpu_torch.utils.profiling import stage

__all__ = ["Encoder", "EncoderConfig", "Packet", "qp_to_qindex"]

CHUNK = 32   # frames per device batch (the reference's send_pictures)


@dataclasses.dataclass
class Packet:
    data: bytes
    pts: int               # display order of the content (poc)
    frame_type: int
    recon: Optional[Dict[str, np.ndarray]] = None
    displayed: bool = True  # False for hidden (show_frame=0) frames


def _align16(x: int) -> int:
    return (x + 15) & ~15


def _unsupported(cfg: EncoderConfig):
    """(reason, ROADMAP.md item) of the first setting outside the slice,
    or None."""
    gop = cfg.intra_period_length not in (-2, 0)
    checks = (
        (cfg.encoder_bit_depth != 8, "10-bit input", "queue A item 7"),
        (cfg.encoder_color_format != 1, "chroma formats other than 4:2:0",
         "queue A item 7"),
        (gop and (cfg.pred_structure != 2 or cfg.hierarchical_levels == 0),
         "low-delay and IPPP GOPs (pred_structure != 2 or "
         "hierarchical_levels 0)", "queue A item 7"),
        (gop and (cfg.hierarchical_levels > 3
                  or cfg.intra_period_length < 0),
         "GOPs with hierarchical_levels 4-5 or intra_period_length -1",
         "queue A item 7"),
        (cfg.rate_control_mode != 0 or cfg.max_bit_rate > 0
         or cfg.pass_ != 0, "VBR/CBR, capped CRF and multi-pass",
         "queue A item 7"),
        (not 5 <= cfg.enc_mode <= 13,
         f"preset M{cfg.enc_mode} (varpart, filter-intra, the D45/D67/D203 "
         "modes, per-SB CDEF)", "queue A item 7"),
        (cfg.tile_columns > 0 or cfg.tile_rows > 0, "tiles",
         "queue A item 7"),
        (cfg.enable_adaptive_quantization != 0, "adaptive quantization",
         "queue A item 7"),
        (cfg.enable_restoration_filtering > 0 or cfg.superres_mode > 0
         or cfg.film_grain_denoise_strength > 0,
         "loop restoration, superres and film grain", "queue A item 7"),
        (bool(cfg.avif) or cfg.sframe_dist > 0, "AVIF and S-frames",
         "queue A item 7"),
        (bool(cfg.mastering_display or cfg.content_light
              or cfg.stat_report), "HDR metadata and stat reports",
         "queue A item 7"),
    )
    for bad, what, item in checks:
        if bad:
            return what, item
    return None


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


class Encoder:
    def __init__(self, config: EncoderConfig, device=None):
        self.cfg = config.validate()
        bad = _unsupported(config)
        if bad is not None:
            raise NotImplementedError(
                f"{bad[0]}: not ported yet (ROADMAP.md {bad[1]})")
        self.device = device_mod.resolve(device)
        fast_ec.available()        # builds the native coder or raises
        self.render_w = config.source_width
        self.render_h = config.source_height
        self.coded_w = _align16(config.source_width)
        self.coded_h = _align16(config.source_height)
        self.sp = obu.SequenceParams(width=self.coded_w, height=self.coded_h,
                                     bit_depth=8,
                                     enable_cdef=config.cdef_level > 0)
        self._feat = features_for(config.enc_mode)
        if config.intra_period_length not in (-2, 0):
            for on, what in ((self._feat.hp_mv, "1/8-pel MVs (hp_mv)"),
                             (self._feat.mref, "the third reference (mref)")):
                if on:
                    raise NotImplementedError(
                        f"{what}: not ported yet (ROADMAP.md queue A item 7)")
        # palette presets signal SELECT_SCREEN_CONTENT_TOOLS in the
        # sequence header; a frame turns the tools on when it has
        # palette candidates
        self.sp.enable_screen_content = bool(self._feat.palette)
        # the other sequence flags the preset sets in the reference (no
        # key frame of the slice uses the tools they announce)
        self.sp.enable_filter_intra = self._feat.filter_intra
        self.sp.enable_interintra_compound = self._feat.interintra
        self._packets: Deque[Packet] = deque()
        self._la: Deque = deque()      # submitted, not yet coded
        self._pts = 0
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
        self._arf_q = None   # base-layer ratio qindex (crf_qindex_calc)
        # callers that do not read Packet.recon (a benchmark) turn this
        # off: shown GOP frames then skip the host copy of their recon
        self.recon_enabled = True
        # scene-cut detector state (all GOP modes)
        self._prev_hist = None
        self._ahd_running = None
        self._scene_cut = False
        self._last_ahd = 0.0
        # hierarchical (random access) GOP: the fast path's state
        self._hier = 0
        if config.intra_period_length not in (-2, 0):
            self._hier = config.hierarchical_levels
            self._h_frames: Dict[int, tuple] = {}  # poc -> (y, u, v)
            self._h_next_in = 0       # next arriving poc
            self._h_sched = 0         # first unscheduled poc
            self._h_anchor = None     # display poc of the last coded anchor
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

    # -- API surface ---------------------------------------------------------
    def stream_header(self) -> bytes:
        return obu.write_sequence_header(self.sp)

    def send_picture(self, y, u, v, eos: bool = False):
        """Feed one frame (planar uint8 numpy).  All-intra has no
        lookahead, so the frame is coded before this returns; in a GOP the
        frame waits until its mini-GoP is complete."""
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
            self._drain()
        if eos:
            self._eos_sent = True

    def flush(self):
        """Signal EOS without a new picture."""
        if self._hier:
            self._drain_hier(flush=True)
        else:
            self._drain()
        self._eos_sent = True

    def _drain(self):
        while self._la:
            y, u, v = self._la.popleft()
            self._packets.append(self._encode_frame(y, u, v, self._pts))
            self._pts += 1

    def _encode_frame(self, y, u, v, pts) -> Packet:
        """One key frame: mode decision, then the filters and object
        packetization."""
        qindex = self._rc.frame_qindex()
        y, u, v = self._pad(y, u, v)
        decisions, recon, allow_sct = self._mode_decision(y, u, v, qindex)
        pkt = self._packetize(decisions, recon, qindex, pts,
                              allow_sct=allow_sct, src=dict(y=y, u=u, v=v))
        self._rc.feedback(len(pkt.data) * 8, qindex, True)
        return pkt

    def _mode_decision(self, y, u, v, qindex, qmap=None):
        """Palette candidates and the frame program with the preset's
        tools for one padded frame: (decisions, recon on the device,
        whether the frame turns the screen-content tools on).  qmap: the
        per-64x64 qindex map of a delta-q key frame (no palette then, as
        in the reference)."""
        pal_cands = None
        if self.sp.enable_screen_content and qmap is None:
            with stage("palette_md"):
                pal_cands = intra_encoder.palette_md_candidates(
                    y, qindex, device=self.device)
        with stage("device_md_intra"):
            decisions, recon = intra_encoder.encode_intra_frame(
                y, u, v, qindex, modes=self._feat.intra_modes,
                rdoq=self._feat.rdoq, tx_search=self._feat.tx_search,
                angle_deltas=self._feat.angle_deltas, cfl=self._feat.cfl,
                exact_rates=(self._feat.exact_rates
                             and self._feat.exact_rates_intra),
                palette_cands=pal_cands, qmap=qmap, device=self.device)
        return decisions, recon, pal_cands is not None

    def _packetize(self, decisions, recon, qindex, pts,
                   allow_sct: bool = False, src=None, prefilt=None,
                   return_state: bool = False,
                   delta_q: bool = False) -> Packet:
        """In-loop filters + entropy coding + OBU assembly for one key
        frame from per-block decisions.  allow_sct: the frame has palette
        candidates, so it turns the screen-content tools on.  src: the
        padded source planes (numpy) the filter searches measure against;
        without it DLF takes the heuristic level and CDEF is signaled with
        zero strengths, as in the reference.  prefilt: the (recon,
        deblocked, header fields, cdef map) of gop_fast.run_key_filters,
        which has filtered the frame already.  return_state: also return
        the filtered recon and the tile encoder (its end-of-frame CDFs).
        delta_q: the decisions carry per-block qindex values (a TPL qmap),
        coded as delta-q at delta_q_res 2."""
        fp = obu.FrameParams(frame_type=obu.KEY_FRAME, show_frame=True,
                             base_q_idx=qindex,
                             render_width=self.render_w,
                             render_height=self.render_h)
        fp.allow_screen_content_tools = allow_sct
        if self.sp.enable_order_hint:
            fp.order_hint = pts & ((1 << self.sp.order_hint_bits) - 1)
        if prefilt is not None:
            recon, _, fpu, _ = prefilt
            for k, val in fpu.items():
                setattr(fp, k, val)
        else:
            recon = self._filter(decisions, recon, fp, qindex, src)
        self._ref = recon
        tenc = TileEncoder(self.sp.width, self.sp.height, qindex,
                           reduced_tx_set=fp.reduced_tx_set,
                           update_cdfs=not fp.disable_cdf_update,
                           frame_is_intra=True)
        tenc.enable_filter_intra = self.sp.enable_filter_intra
        tenc.allow_palette = bool(fp.allow_screen_content_tools)
        tenc.bit_depth = 8
        if delta_q:
            fp.delta_q_present = True
            fp.delta_q_res = 2
            tenc.set_delta_q(fp.delta_q_res)
        with stage("host_ec"):
            tile_data = tenc.encode(decisions)
        if not fp.disable_frame_end_update_cdf:
            self._ref_cdfs = tenc.cdfs
            self._ref_nmv = tenc.nmv
        pkt = self._assemble(fp, tile_data, recon, pts)
        if return_state:
            return pkt, recon, tenc
        return pkt

    def _filter(self, decisions, recon, fp, qindex, src):
        """The reference's stage path for a key frame on the uniform 16x16
        grid: DLF (level search at M5-M8 when the source is at hand, else
        the heuristic level), then frame-uniform CDEF (strength search
        over the preset's candidates, then apply) when the source is at
        hand.  Sets the header fields; recon stays on the device."""
        searches = ((self.cfg.enable_dlf_flag and self._feat.dlf_search)
                    or self.sp.enable_cdef)
        if src is not None and searches:
            src = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                self.device) for k, v in src.items()}
        if self.cfg.enable_dlf_flag:
            with stage("dlf"):
                if self._feat.dlf_search and src is not None:
                    # per-plane level search (dlf_process.c:106-131)
                    recon = dlf_stage.search_and_apply(src, recon, fp)
                else:
                    self._heuristic_dlf_levels(fp, qindex)
                    recon = intra_encoder.apply_loop_filter(recon, fp)
        if self.sp.enable_cdef and src is not None:
            skip16 = _skip_map(decisions, self.coded_h // 16,
                               self.coded_w // 16)
            fp.cdef_damping = cdef_stage.cdef_damping(qindex)
            with stage("cdef"):
                fp.cdef_strengths = cdef_stage.cdef_search(
                    src, recon, skip16, qindex,
                    max_candidates=self._feat.cdef_candidates)
                recon = cdef_stage.cdef_apply(recon, skip16,
                                              fp.cdef_strengths,
                                              fp.cdef_damping)
        return recon

    @staticmethod
    def _heuristic_dlf_levels(fp, qindex: int):
        lvl_y = default_filter_level(qindex)
        fp.filter_level = (lvl_y, lvl_y)
        lvl_uv = max(0, lvl_y - 2)
        fp.filter_level_uv = (lvl_uv, lvl_uv)

    def send_pictures(self, frames, eos: bool = False):
        """Batched submit: frames = [(y, u, v), ...] uint8 planes.  Each
        chunk of up to 32 frames runs as one device batch with the
        preset's plain luma modes; the host entropy-codes chunk k while
        the device works on chunk k+1.  As in the reference, frames take
        the array tile coder unless CDEF is on (or qindex is 0): then the
        per-block route, whose packetization has no source, so DLF takes
        the heuristic level and CDEF is signaled with zero strengths."""
        if self._hier:
            # a GOP with inter frames: the sequential path; eos drains the
            # last (partial) mini-GoP as send_picture(..., eos=True) does
            for (y, u, v) in frames:
                self.send_picture(y, u, v)
            if eos:
                self.flush()
            return
        qindex = self._rc.frame_qindex()
        arrays_ok = qindex > 0 and not self.sp.enable_cdef
        padded = [self._pad(*self._checked(y, u, v))
                  for (y, u, v) in frames]
        pending = None
        for i in range(0, len(padded), CHUNK):
            chunk = padded[i:i + CHUNK]
            with stage("device_dispatch"):
                launched = intra_encoder.encode_intra_frames_launch(
                    chunk, qindex, modes=self._feat.intra_modes,
                    exact_rates=(self._feat.exact_rates
                                 and self._feat.exact_rates_intra),
                    device=self.device)
            if pending is not None:
                self._emit(pending, qindex, arrays_ok)
            pending = launched
        if pending is not None:
            self._emit(pending, qindex, arrays_ok)
        if eos:
            self._eos_sent = True

    def _emit(self, pending, qindex: int, arrays_ok: bool):
        with stage("device_wait_transfer"):
            results = intra_encoder.encode_intra_frames_finish(
                pending, as_arrays=arrays_ok)
        for decisions, recon in results:
            if arrays_ok:
                pkt = self._packetize_arrays(decisions, recon, qindex,
                                             self._pts)
            else:
                pkt = self._packetize(decisions, recon, qindex, self._pts)
            self._packets.append(pkt)
            self._rc.feedback(len(pkt.data) * 8, qindex, True)
            self._pts += 1

    def _packetize_arrays(self, bundle, recon, qindex, pts) -> Packet:
        """Array-native key-frame packetization (one tile, C coder)."""
        ym, um, qy, qu, qv, gh, gw = bundle
        fp = obu.FrameParams(frame_type=obu.KEY_FRAME, show_frame=True,
                             base_q_idx=qindex,
                             render_width=self.render_w,
                             render_height=self.render_h)
        if self.cfg.enable_dlf_flag:
            self._heuristic_dlf_levels(fp, qindex)
            with stage("dlf"):
                recon = intra_encoder.apply_loop_filter(recon, fp)
        self._ref = recon
        tenc = TileEncoder(self.sp.width, self.sp.height, qindex,
                           update_cdfs=True, frame_is_intra=True)
        with stage("host_ec"):
            tile_data = fast_ec.encode_intra_tile_arrays(tenc, ym, um, qy,
                                                         qu, qv)
        self._ref_cdfs = tenc.cdfs
        self._ref_nmv = tenc.nmv
        return self._assemble(fp, tile_data, recon, pts)

    def _assemble(self, fp, tile_data, recon, pts) -> Packet:
        """The temporal unit (with the sequence header on the first) and
        the recon (device tensors) cropped to the render size and copied
        to the host."""
        tu = obu.temporal_delimiter()
        if not self._seq_hdr_sent:
            tu += obu.write_sequence_header(self.sp)
            self._seq_hdr_sent = True
        tu += obu.write_frame_obu(self.sp, fp, tile_data)
        return Packet(data=tu, pts=pts, frame_type=fp.frame_type,
                      recon=self._host_recon(recon))

    def _host_recon(self, recon):
        """Device planes cropped to the render size, copied to the host
        (key frames always; shown GOP inter and show-existing frames only
        with ``recon_enabled``, as in the reference)."""
        ch, cw = (self.render_h + 1) // 2, (self.render_w + 1) // 2
        return dict(
            y=recon["y"][:self.render_h, :self.render_w].cpu().numpy(),
            u=recon["u"][:ch, :cw].cpu().numpy(),
            v=recon["v"][:ch, :cw].cpu().numpy())

    # -- hierarchical (random access) GOP ------------------------------------
    def _is_key_poc(self, poc: int) -> bool:
        period = self.cfg.intra_period_length
        return poc == 0 or poc in self._h_cuts or poc % (period + 1) == 0

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
        self._packets.append(pkt)
        self._rc.feedback(len(pkt.data) * 8, qindex,
                          pkt.frame_type == obu.KEY_FRAME, layer)

    def _encode_key_job(self, poc: int):
        """A GOP key frame: MCTF against its next two frames, TPL over its
        IPP chain (its qindex and delta-q map), the preset's intra MD, the
        filters (the fused key-filter program when DLF is off and CDEF on,
        else the stage path), packetization; the frame becomes the only
        DPB entry."""
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
                stats = gop_fast.tpl_group_stats(chain, deps,
                                                 device=self.device)
            dep0 = tpl.synthesize(stats, deps)[0]
            qindex, self._arf_q = crf_qindex_calc(
                qindex, tpl.r0_of(stats[0], dep0), 0, self._hier, True)
            qmap = tpl.beta_qmap(stats[0], dep0, qindex)
            if np.all(qmap == qindex):
                qmap = None
        else:
            qindex = max(1, qindex - qindex // self._feat.kf_boost_div)
        decisions, recon, allow_sct = self._mode_decision(y, u, v, qindex,
                                                          qmap)
        prefilt = None
        dlf_wants = bool(self.cfg.enable_dlf_flag)
        if ((dlf_wants or self.sp.enable_cdef)
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
                delta_q=qmap is not None)
        self._h_anchor_src = y
        # key refresh: the map keeps the key in slot 0 only
        self._dpb = {poc: 0}
        self._slot_free = set(range(1, 8))
        self._slot_recon = {0: full}
        self._slot_state = {0: (tenc.cdfs, tenc.nmv)}
        self._slot_mvfield = {}
        self._slot_hint = [poc & ((1 << self.sp.order_hint_bits) - 1)] * 8
        self._h_anchor = poc
        self._finish_packet(pkt, qindex)

    def _base_q_for(self, poc: int) -> int:
        """The configured (CQP/CRF) qindex: the only branch of the
        reference's per-frame base q that the slice reaches."""
        return self._rc.frame_qindex()

    def _encode_minigop(self, p0: int, n: int):
        """Code the mini-GoP after the anchor: MCTF of its base, TPL over
        it (the frames' qindex), then every inter frame's device programs
        are dispatched (the recon chain stays on the device), then each
        is collected and entropy-coded in decode order.  A DPB slot is
        freed after its last use."""
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
        last_use: Dict[int, int] = {}
        for i, ev in enumerate(events):
            if isinstance(ev, gop.CodeEvent):
                last_use[ev.last_poc] = i
                if ev.bwd_poc is not None:
                    last_use[ev.bwd_poc] = i
            else:
                last_use[ev.poc] = i
        records = []
        for i, ev in enumerate(events):
            if isinstance(ev, gop.CodeEvent):
                if tpl_r0 is not None:
                    # the reference's CRF model (rc_process.c): the base
                    # scales its qstep by sqrt(r0), mid layers interpolate
                    # from the base's q toward cq, leaves code at cq
                    q, arf = crf_qindex_calc(
                        base_q, tpl_r0[ev.poc], ev.layer, self._hier,
                        False, arf_q=self._arf_q,
                        ref_layer=max(0, ev.layer - 1),
                        is_leaf=ev.layer >= self._hier)
                    if ev.layer == 0:
                        self._arf_q = arf
                else:
                    q = gop.layer_qindex(base_q, ev.layer, self._hier + 1)
                with stage("dispatch_inter"):
                    records.append(self._dispatch_inter_fast(ev, q))
            else:
                slot = self._dpb[ev.poc]
                records.append(("show", ev.poc, slot,
                                self._slot_recon[slot]))
            for poc, li in list(last_use.items()):
                if li == i and poc != end_poc and poc in self._dpb:
                    slot = self._dpb.pop(poc)
                    self._slot_free.add(slot)
                    self._slot_recon.pop(slot, None)
        for rec in records:
            if rec[0] == "show":
                self._emit_show_existing_fast(rec[1], rec[2], rec[3])
            else:
                self._collect_inter_fast(rec)
        self._h_anchor = end_poc

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
            stats = gop_fast.tpl_group_stats([src_of[p] for p in order],
                                             deps, device=self.device)
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
        src_pack = np.concatenate(
            [y, np.concatenate([u, v], axis=1)], axis=0)
        pend = gop_fast.run_inter_frame(
            src_pack, refs, qindex, self.coded_h, self.coded_w,
            modes=self._feat.intra_modes, ring=self._feat.subpel_ring,
            rad2=self._feat.hme_rad2, rad0=self._feat.hme_rad0,
            cdef_cands=cdef_stage.SEARCH_SET[:self._feat.cdef_candidates],
            dlf_on=bool(self.cfg.enable_dlf_flag),
            cdef_on=self.sp.enable_cdef, hp=self._feat.hp_mv,
            obmc=self._feat.obmc, interintra=self._feat.interintra,
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
        ref_hints = tuple(self._slot_hint[i] for i in idx)
        if ev.store:
            self._slot_free.remove(slot)
            self._dpb[ev.poc] = slot
            self._slot_recon[slot] = pend.recon
            self._slot_hint[slot] = \
                ev.poc & ((1 << self.sp.order_hint_bits) - 1)
        return ("code", ev, pend, qindex, last_slot, slot, tuple(idx),
                ref_hints)

    def _collect_inter_fast(self, rec):
        """The bundled host copy, entropy coding and the packet."""
        _, ev, pend, qindex, last_slot, slot, idx, ref_hints = rec
        with stage("device_md_inter"):
            decisions, recon_dev, header = gop_fast.collect_inter_frame(pend)
        pkt, tenc = self._packetize_fast(decisions, header, qindex, ev,
                                         last_slot, slot, idx, ref_hints)
        if ev.store:
            self._slot_state[slot] = (tenc.cdfs, tenc.nmv)
        pkt.displayed = ev.shown
        if ev.shown and self.recon_enabled:
            pkt.recon = self._host_recon(recon_dev)
        self._finish_packet(pkt, qindex, ev.layer)

    def _emit_show_existing_fast(self, poc: int, slot: int, recon_dev):
        data = obu.temporal_delimiter() + obu.write_show_existing(slot)
        self._packets.append(Packet(
            data=data, pts=poc, frame_type=obu.INTER_FRAME,
            recon=(self._host_recon(recon_dev) if self.recon_enabled
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
        tu = obu.temporal_delimiter()
        if not self._seq_hdr_sent:
            tu += obu.write_sequence_header(self.sp)
            self._seq_hdr_sent = True
        tu += obu.write_frame_obu(self.sp, fp, tile_data)
        return Packet(data=tu, pts=ev.poc, frame_type=obu.INTER_FRAME), tenc

    # region-vote scene-change detector (pd_process.c:274-365): per-region
    # 256-bin histogram AHD against a running average, with fade
    # suppression; a cut when >= 50% of the regions vote
    _SCENE_TH = 3000.0 / 4096.0
    _FADE_TH = 3

    def _detect_scene_cut(self, y: np.ndarray) -> None:
        yy = np.asarray(y).astype(np.int64)
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
        if y.dtype != np.uint8 or u.dtype != np.uint8 or v.dtype != np.uint8:
            raise ValueError(f"picture dtype {y.dtype}/{u.dtype}/{v.dtype} "
                             "does not match encoder_bit_depth=8 (expected "
                             "uint8)")
        return y, u, v

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
