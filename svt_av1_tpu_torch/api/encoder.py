"""Encoder handle for the port: the all-intra half of
svt_av1_tpu/api/encoder.py.

  Encoder(config, device)   ~ svt_av1_enc_init_handle + init
  enc.send_picture(y, u, v) ~ svt_av1_enc_send_picture
  enc.flush()               ~ send_picture(NULL, eos)
  enc.send_pictures(frames) ~ batched svt_av1_enc_send_picture
  enc.get_packet()          ~ svt_av1_enc_get_packet
  enc.stream_header()       ~ svt_av1_enc_stream_header

Slice: 8-bit 4:2:0, all-intra (intra_period_length -2 or 0), CQP/CRF,
presets M5-M13, one tile, no AQ, and DLF, CDEF, LR, superres and film
grain off.  Any other configuration raises NotImplementedError naming the
ROADMAP.md item that brings it; nothing falls back to the JAX package.

``send_picture`` codes one key frame at a time with the preset's whole
tool set (at M5-M8: tx-type search, angle deltas, CfL, palette on screen
content) and packetizes the per-block decisions with the object tile
coder.  ``send_pictures`` runs the batched frame program with the
preset's plain luma modes (as the reference's does) and the array-native
C tile coder.  Mode decision runs on ``device``
(pipeline/intra_encoder.py; default: the current CUDA device); entropy
coding is the port's copy of the host coder (codec/syntax.py,
native/ec_native.c).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, Optional

import numpy as np

from svt_av1_tpu_torch import device as device_mod
from svt_av1_tpu_torch.api.config import EncoderConfig
from svt_av1_tpu_torch.codec import fast_ec, obu
from svt_av1_tpu_torch.codec.syntax import TileEncoder
from svt_av1_tpu_torch.pipeline import intra_encoder
from svt_av1_tpu_torch.pipeline.presets import features_for
from svt_av1_tpu_torch.pipeline.rate_control import (RateControlState,
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


def _align16(x: int) -> int:
    return (x + 15) & ~15


def _unsupported(cfg: EncoderConfig):
    """(reason, ROADMAP.md item) of the first setting outside the slice,
    or None."""
    checks = (
        (cfg.encoder_bit_depth != 8, "10-bit input", "queue A item 7"),
        (cfg.encoder_color_format != 1, "chroma formats other than 4:2:0",
         "queue A item 7"),
        (cfg.intra_period_length not in (-2, 0),
         "GOPs with inter frames", "queue A items 4-6"),
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
        (bool(cfg.enable_dlf_flag) or cfg.cdef_level > 0,
         "DLF and CDEF", "queue A item 3"),
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
                                     bit_depth=8)
        self._feat = features_for(config.enc_mode)
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
        # last recon and end-of-frame CDF state (what an inter frame
        # would predict from; kept as the reference keeps them)
        self._ref: Optional[Dict[str, np.ndarray]] = None
        self._ref_cdfs = None
        self._ref_nmv = None
        fps = (config.frame_rate_numerator
               / max(config.frame_rate_denominator, 1))
        self._rc = RateControlState.create(config, fps)

    # -- API surface ---------------------------------------------------------
    def stream_header(self) -> bytes:
        return obu.write_sequence_header(self.sp)

    def send_picture(self, y, u, v, eos: bool = False):
        """Feed one frame (planar uint8 numpy).  All-intra has no
        lookahead, so the frame is coded before this returns."""
        self._la.append(self._checked(y, u, v))
        self._drain()
        if eos:
            self._eos_sent = True

    def flush(self):
        """Signal EOS without a new picture."""
        self._drain()
        self._eos_sent = True

    def _drain(self):
        while self._la:
            y, u, v = self._la.popleft()
            self._packets.append(self._encode_frame(y, u, v, self._pts))
            self._pts += 1

    def _encode_frame(self, y, u, v, pts) -> Packet:
        """One key frame: palette candidates, the frame program with the
        preset's tools, object packetization."""
        qindex = self._rc.frame_qindex()
        y, u, v = self._pad(y, u, v)
        pal_cands = None
        if self.sp.enable_screen_content:
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
                palette_cands=pal_cands, device=self.device)
        pkt = self._packetize(decisions, recon, qindex, pts,
                              allow_sct=pal_cands is not None)
        self._rc.feedback(len(pkt.data) * 8, qindex, True)
        return pkt

    def _packetize(self, decisions, recon, qindex, pts,
                   allow_sct: bool) -> Packet:
        """Entropy coding + OBU assembly for one key frame from per-block
        decisions (in-loop filters are off in the slice).  allow_sct: the
        frame has palette candidates, so it turns the screen-content
        tools on."""
        fp = obu.FrameParams(frame_type=obu.KEY_FRAME, show_frame=True,
                             base_q_idx=qindex,
                             render_width=self.render_w,
                             render_height=self.render_h)
        fp.allow_screen_content_tools = allow_sct
        self._ref = {k: recon[k] for k in ("y", "u", "v")}
        tenc = TileEncoder(self.sp.width, self.sp.height, qindex,
                           reduced_tx_set=fp.reduced_tx_set,
                           update_cdfs=not fp.disable_cdf_update,
                           frame_is_intra=True)
        tenc.enable_filter_intra = self.sp.enable_filter_intra
        tenc.allow_palette = bool(fp.allow_screen_content_tools)
        tenc.bit_depth = 8
        with stage("host_ec"):
            tile_data = tenc.encode(decisions)
        if not fp.disable_frame_end_update_cdf:
            self._ref_cdfs = tenc.cdfs
            self._ref_nmv = tenc.nmv
        return self._assemble(fp, tile_data, recon, pts)

    def send_pictures(self, frames, eos: bool = False):
        """Batched submit: frames = [(y, u, v), ...] uint8 planes.  Each
        chunk of up to 32 frames runs as one device batch with the
        preset's plain luma modes; the host entropy-codes chunk k while
        the device works on chunk k+1."""
        qindex = self._rc.frame_qindex()
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
                self._emit(pending, qindex)
            pending = launched
        if pending is not None:
            self._emit(pending, qindex)
        if eos:
            self._eos_sent = True

    def _emit(self, pending, qindex: int):
        with stage("device_wait_transfer"):
            results = intra_encoder.encode_intra_frames_finish(pending)
        for bundle, recon in results:
            with stage("host_ec"):
                pkt = self._packetize_arrays(bundle, recon, qindex,
                                             self._pts)
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
        self._ref = {k: recon[k] for k in ("y", "u", "v")}
        tenc = TileEncoder(self.sp.width, self.sp.height, qindex,
                           update_cdfs=True, frame_is_intra=True)
        tile_data = fast_ec.encode_intra_tile_arrays(tenc, ym, um, qy, qu,
                                                     qv)
        self._ref_cdfs = tenc.cdfs
        self._ref_nmv = tenc.nmv
        return self._assemble(fp, tile_data, recon, pts)

    def _assemble(self, fp, tile_data, recon, pts) -> Packet:
        """The temporal unit (with the sequence header on the first) and
        the recon cropped to the render size."""
        tu = obu.temporal_delimiter()
        if not self._seq_hdr_sent:
            tu += obu.write_sequence_header(self.sp)
            self._seq_hdr_sent = True
        tu += obu.write_frame_obu(self.sp, fp, tile_data)
        recon_out = dict(
            y=recon["y"][:self.render_h, :self.render_w],
            u=recon["u"][:(self.render_h + 1) // 2,
                         :(self.render_w + 1) // 2],
            v=recon["v"][:(self.render_h + 1) // 2,
                         :(self.render_w + 1) // 2])
        return Packet(data=tu, pts=pts, frame_type=obu.KEY_FRAME,
                      recon=recon_out)

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
