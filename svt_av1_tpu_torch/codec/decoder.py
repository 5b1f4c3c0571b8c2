"""Verification decoder for the port's streams: key frames, one tile.

The key-frame, single-tile subset of svt_av1_tpu/codec/decoder.py.  OBU
parsing, the frame header and the tile syntax are the port's copies of
the reference's numpy code (``obu.parse_obus``, ``obu.read_frame_header``,
``TileDecoder``), so streams with screen-content tools, tx types, angle
deltas, CfL alphas and palette blocks parse as they do there;
reconstruction is the port's ``reconstruct_from_decisions`` on ``device``
(default: the current CUDA device).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from svt_av1_tpu_torch import device as device_mod
from svt_av1_tpu_torch.codec import obu
from svt_av1_tpu_torch.codec.syntax import TileDecoder
from svt_av1_tpu_torch.pipeline.intra_encoder import (
    apply_loop_filter, reconstruct_from_decisions)
from svt_av1_tpu_torch.utils.bitio import BitReader


class Decoder:
    def __init__(self, device=None):
        self.device = device_mod.resolve(device)
        self.sp: Optional[obu.SequenceParams] = None
        # most recent frame's parsed leaf decisions (test introspection)
        self.last_decisions: dict = None

    def decode_temporal_unit(self, data: bytes
                             ) -> List[Dict[str, np.ndarray]]:
        """The displayed frames of this temporal unit."""
        frames = []
        for obu_type, payload in obu.parse_obus(data):
            if obu_type in (obu.OBU_TEMPORAL_DELIMITER, obu.OBU_PADDING):
                continue
            if obu_type == obu.OBU_SEQUENCE_HEADER:
                self.sp = obu.read_sequence_header(payload)
            elif obu_type == obu.OBU_FRAME:
                if self.sp is None:
                    raise ValueError("frame OBU before any sequence header")
                recon, shown = self._decode_frame(payload)
                if shown:
                    frames.append(recon)
            else:
                raise NotImplementedError(
                    f"OBU type {obu_type}: the port decodes key frames "
                    "only (ROADMAP.md queue A items 3-7)")
        return frames

    def _decode_frame(self, payload: bytes):
        r = BitReader(payload)
        fp = obu.read_frame_header(r, self.sp)
        r.byte_align()
        tile_data = payload[r.byte_pos:]
        coded_w = fp.coded_width(self.sp.width)
        n_tiles = len(obu.tile_cols_layout(coded_w, fp.log2_tile_cols)) \
            * (1 << fp.log2_tile_rows)
        if fp.frame_type != obu.KEY_FRAME or n_tiles > 1:
            raise NotImplementedError(
                "inter frames and tiles: ROADMAP.md queue A items 6-7")
        if (self.sp.bit_depth != 8 or self.sp.enable_cdef
                or self.sp.enable_restoration or fp.superres_denom != 8
                or fp.segmentation is not None or fp.delta_q_present
                or fp.cdef_bits):
            raise NotImplementedError(
                "10-bit, CDEF, LR, superres, segmentation and delta-q: "
                "ROADMAP.md queue A items 3 and 7")
        tdec = TileDecoder(coded_w, self.sp.height, fp.base_q_idx,
                           reduced_tx_set=fp.reduced_tx_set,
                           update_cdfs=not fp.disable_cdf_update,
                           frame_is_intra=True)
        tdec.enable_filter_intra = self.sp.enable_filter_intra
        tdec.allow_palette = bool(fp.allow_screen_content_tools)
        tdec.bit_depth = self.sp.bit_depth
        decisions = tdec.decode(tile_data)
        recon = reconstruct_from_decisions(decisions, coded_w,
                                           self.sp.height, fp.base_q_idx,
                                           device=self.device)
        recon = apply_loop_filter(recon, fp)
        recon["decisions"] = decisions
        self.last_decisions = decisions
        return recon, fp.show_frame
