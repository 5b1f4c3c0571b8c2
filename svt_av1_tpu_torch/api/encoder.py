"""Encoder handle for the port: the all-intra half of
svt_av1_tpu/api/encoder.py.

  Encoder(config, device)   ~ svt_av1_enc_init_handle + init
  enc.send_pictures(frames) ~ batched svt_av1_enc_send_picture
  enc.get_packet()          ~ svt_av1_enc_get_packet
  enc.stream_header()       ~ svt_av1_enc_stream_header

Slice: 8-bit 4:2:0, all-intra (intra_period_length -2 or 0), CQP/CRF,
presets M10-M13, one tile, no AQ, and DLF, CDEF, LR, superres and film
grain off.  Any other configuration raises NotImplementedError naming the
ROADMAP.md item that brings it; nothing falls back to the JAX package.
Mode decision runs on ``device`` (pipeline/intra_encoder.py); entropy
coding is the native C tile coder of svt_av1_tpu, on the host.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, Optional

import numpy as np

from svt_av1_tpu.api.config import EncoderConfig
from svt_av1_tpu.codec import fast_ec, obu
from svt_av1_tpu.codec.syntax import TileEncoder
from svt_av1_tpu.pipeline.presets import features_for
from svt_av1_tpu.pipeline.rate_control import RateControlState, qp_to_qindex
from svt_av1_tpu.utils.profiling import stage

from svt_av1_tpu_torch import device as device_mod
from svt_av1_tpu_torch.pipeline import intra_encoder

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
        (not 10 <= cfg.enc_mode <= 13,
         f"preset M{cfg.enc_mode} (tx search, CfL, angle deltas, "
         "filter-intra, palette, varpart)", "queue A item 2 at M6, item 7"),
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


def _native_coder_error() -> str:
    """The system compiler's message for the native range coder."""
    import subprocess
    import sysconfig
    from svt_av1_tpu import native
    inc = sysconfig.get_paths()["include"]
    cmd = ["cc", "-O2", "-shared", "-fPIC", f"-I{inc}", native._SRC, "-o",
           native._SO]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        return str(e)
    return f"{' '.join(cmd)} -> {proc.returncode}\n{proc.stderr}"


class Encoder:
    def __init__(self, config: EncoderConfig, device=None):
        self.cfg = config.validate()
        bad = _unsupported(config)
        if bad is not None:
            raise NotImplementedError(
                f"{bad[0]}: not ported yet (ROADMAP.md {bad[1]})")
        if not fast_ec.available():
            raise RuntimeError("the native range coder (svt_av1_tpu/native/"
                               "ec_native.c) did not build: "
                               + _native_coder_error())
        self.device = device_mod.resolve(device)
        self.render_w = config.source_width
        self.render_h = config.source_height
        self.coded_w = _align16(config.source_width)
        self.coded_h = _align16(config.source_height)
        self.sp = obu.SequenceParams(width=self.coded_w, height=self.coded_h,
                                     bit_depth=8)
        self._feat = features_for(config.enc_mode)
        self._packets: Deque[Packet] = deque()
        self._pts = 0
        self._eos_sent = False
        self._seq_hdr_sent = False
        fps = (config.frame_rate_numerator
               / max(config.frame_rate_denominator, 1))
        self._rc = RateControlState.create(config, fps)

    # -- API surface ---------------------------------------------------------
    def stream_header(self) -> bytes:
        return obu.write_sequence_header(self.sp)

    def send_picture(self, y, u, v, eos: bool = False):
        raise NotImplementedError(
            "send_picture (GOP / lookahead path): ROADMAP.md queue A items "
            "4-6; use send_pictures for all-intra batches")

    def send_pictures(self, frames, eos: bool = False):
        """Batched submit: frames = [(y, u, v), ...] uint8 planes.  Each
        chunk of up to 32 frames runs as one device batch; the host
        entropy-codes chunk k while the device works on chunk k+1."""
        qindex = self._rc.frame_qindex()
        padded = [self._pad(y, u, v) for (y, u, v) in frames]
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
        tenc = TileEncoder(self.sp.width, self.sp.height, qindex,
                           update_cdfs=True, frame_is_intra=True)
        tile_data = fast_ec.encode_intra_tile_arrays(tenc, ym, um, qy, qu,
                                                     qv)
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

    # -- internals -----------------------------------------------------------
    def _pad(self, y, u, v):
        """Edge-replicate to the coded (16-aligned) size."""
        y, u, v = np.asarray(y), np.asarray(u), np.asarray(v)
        eh, ew = self.render_h, self.render_w
        ch, cw = (eh + 1) // 2, (ew + 1) // 2
        if y.shape != (eh, ew) or u.shape != (ch, cw) or v.shape != (ch, cw):
            raise ValueError(
                f"picture plane shapes {y.shape}/{u.shape}/{v.shape} do not "
                f"match the configured {ew}x{eh} 4:2:0 geometry")
        if y.dtype != np.uint8 or u.dtype != np.uint8 or v.dtype != np.uint8:
            raise ValueError(f"picture dtype {y.dtype}/{u.dtype}/{v.dtype} "
                             "is not uint8")
        if self.coded_w == ew and self.coded_h == eh:
            return y, u, v
        py = self.coded_h - eh
        px = self.coded_w - ew
        y = np.pad(y, ((0, py), (0, px)), mode="edge")
        u = np.pad(u, ((0, py // 2), (0, px // 2)), mode="edge")
        v = np.pad(v, ((0, py // 2), (0, px // 2)), mode="edge")
        return y, u, v
