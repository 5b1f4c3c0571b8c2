"""Verification decoder for the port's streams: key and inter frames, one
tile, the port of svt_av1_tpu/codec/decoder.py for that subset.

OBU parsing, the frame header and the tile syntax are the port's copies of
the reference's numpy code (``obu.parse_obus``, ``obu.read_frame_header``,
``TileDecoder``).  The 8 DPB slots keep their frame's planes on ``device``
(default: the current CUDA device) with its saved CDFs, MV context and
order hint; show_existing_frame outputs a slot.  Key frames reconstruct
through ``reconstruct_from_decisions`` (each block at its own qindex
where the frame codes delta-q), inter frames through
``reconstruct_inter_from_decisions`` (translational, GLOBALMV warp,
compound average / wedge / diffwtd, skip mode, the merged skip leaves,
8x8 split leaves, OBMC and inter-intra), followed by DLF at the header's
levels (mask-aware where block sizes are mixed) and frame-uniform CDEF
(cdef_bits = 0).  Each slot also keeps its frame's saved motion field,
which TMVP (use_ref_frame_mvs) projects.  Shown planes are copied out
once, filtered.  1/8-pel MVs and per-SB CDEF raise, naming their
ROADMAP.md items.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from svt_av1_tpu_torch import device as device_mod
from svt_av1_tpu_torch.api.encoder import _skip_map, _skip_map8
from svt_av1_tpu_torch.codec import mv_pred, obu
from svt_av1_tpu_torch.codec.syntax import TileDecoder
from svt_av1_tpu_torch.codec import constants as cc
from svt_av1_tpu_torch.pipeline import cdef_stage, dlf_stage
from svt_av1_tpu_torch.pipeline.inter_encoder import (
    reconstruct_inter_from_decisions)
from svt_av1_tpu_torch.pipeline.intra_encoder import (
    apply_loop_filter, reconstruct_from_decisions)
from svt_av1_tpu_torch.utils.bitio import BitReader


class Decoder:
    def __init__(self, device=None):
        self.device = device_mod.resolve(device)
        self.sp: Optional[obu.SequenceParams] = None
        # decoded-picture buffer: 8 slots of device planes, each with its
        # saved CDF state, MV context and order hint (spec 7.20)
        self.slots: list = [None] * 8
        self.slot_cdfs: list = [None] * 8
        self.slot_nmv: list = [None] * 8
        self.slot_hints: list = [0] * 8
        # per-slot saved motion fields (spec 7.19; projected by 7.9 when
        # a frame sets use_ref_frame_mvs)
        self.slot_mvfield: list = [None] * 8
        # most recent frame's parsed leaf decisions and frame header (test
        # introspection)
        self.last_decisions: dict = None
        self.last_frame_header: Optional[obu.FrameParams] = None

    def decode_temporal_unit(self, data: bytes
                             ) -> List[Dict[str, np.ndarray]]:
        """The displayed frames of this temporal unit (shown frames and
        show_existing_frame outputs; hidden frames decode silently)."""
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
            elif obu_type == obu.OBU_FRAME_HEADER:
                idx = obu.parse_show_existing(payload)
                if idx is None:
                    raise NotImplementedError(
                        "frame-header OBUs other than show_existing_frame")
                if self.slots[idx] is None:
                    raise ValueError(
                        f"show_existing_frame of empty slot {idx}")
                frames.append({k: v.cpu().numpy()
                               for k, v in self.slots[idx].items()})
            else:
                raise NotImplementedError(
                    f"OBU type {obu_type}: metadata OBUs come with HDR "
                    "metadata (ROADMAP.md queue A item 7)")
        return frames

    def _decode_frame(self, payload: bytes):
        r = BitReader(payload)
        fp = obu.read_frame_header(r, self.sp,
                                   ref_hints_by_slot=self.slot_hints)
        r.byte_align()
        tile_data = payload[r.byte_pos:]
        is_intra = fp.frame_type in (obu.KEY_FRAME, obu.INTRA_ONLY_FRAME)
        coded_w = fp.coded_width(self.sp.width)
        n_tiles = len(obu.tile_cols_layout(coded_w, fp.log2_tile_cols)) \
            * (1 << fp.log2_tile_rows)
        if n_tiles > 1:
            raise NotImplementedError("tiles: ROADMAP.md queue A item 7")
        if (self.sp.bit_depth != 8 or self.sp.enable_restoration
                or fp.superres_denom != 8 or fp.segmentation is not None):
            raise NotImplementedError(
                "10-bit, LR, superres and segmentation: ROADMAP.md queue A "
                "item 7")
        if fp.cdef_bits:
            raise NotImplementedError(
                "per-SB CDEF strengths (cdef_bits > 0): ROADMAP.md queue A "
                "item 7")
        if not is_intra and fp.allow_high_precision_mv:
            raise NotImplementedError(
                "1/8-pel MVs (allow_high_precision_mv): ROADMAP.md queue A "
                "item 7")
        chain = (not is_intra
                 and fp.primary_ref_frame != obu.PRIMARY_REF_NONE)
        init_cdfs = init_nmv = None
        if chain:
            pslot = fp.ref_frame_idx[fp.primary_ref_frame]
            init_cdfs = self.slot_cdfs[pslot]
            init_nmv = self.slot_nmv[pslot]
        tdec = TileDecoder(coded_w, self.sp.height, fp.base_q_idx,
                           reduced_tx_set=fp.reduced_tx_set,
                           update_cdfs=not fp.disable_cdf_update,
                           frame_is_intra=is_intra, init_cdfs=init_cdfs,
                           init_nmv=init_nmv)
        tdec.enable_filter_intra = self.sp.enable_filter_intra
        tdec.allow_palette = bool(fp.allow_screen_content_tools)
        tdec.bit_depth = self.sp.bit_depth
        tdec.enable_masked_compound = self.sp.enable_masked_compound
        tdec.enable_interintra = self.sp.enable_interintra_compound
        tdec.is_motion_mode_switchable = fp.is_motion_mode_switchable
        tdec.reference_select = fp.reference_select
        if not is_intra:
            tdec.set_gm(fp.gm_trans)
            if fp.skip_mode_present:
                tdec.skip_mode_present = True
                tdec.skip_mode_frames = obu.skip_mode_refs(
                    fp.order_hint, fp.ref_hints, self.sp.order_hint_bits)
                tdec.interp_filter = fp.interpolation_filter
            tdec.cur_hint = fp.order_hint
            tdec.ref_hints = {e: fp.ref_hints[e - 1] for e in range(1, 8)}
            tdec.order_hint_bits = self.sp.order_hint_bits
            if fp.use_ref_frame_mvs:
                tdec.tmvp = mv_pred.setup_motion_field(
                    {e: self.slot_mvfield[fp.ref_frame_idx[e - 1]]
                     for e in range(1, 8)}, tdec.ref_hints, fp.order_hint,
                    self.sp.order_hint_bits, tdec.mi_rows, tdec.mi_cols,
                    fp.allow_high_precision_mv)
        if fp.delta_q_present:
            tdec.set_delta_q(fp.delta_q_res)
        decisions = tdec.decode(tile_data)
        if is_intra:
            # mixed block sizes (varpart leaves) raise here, naming their
            # item
            recon = reconstruct_from_decisions(decisions, coded_w,
                                               self.sp.height,
                                               fp.base_q_idx,
                                               device=self.device)
        else:
            refs = {e: self.slots[fp.ref_frame_idx[e - 1]]
                    for e in range(1, 8)
                    if self.slots[fp.ref_frame_idx[e - 1]] is not None}
            if not refs:
                raise ValueError("inter frame with an empty DPB")
            gm_models = {i + 1: m for i, m in enumerate(fp.gm_trans)
                         if m is not None}
            recon = reconstruct_inter_from_decisions(
                decisions, refs, coded_w, self.sp.height, fp.base_q_idx,
                gm=gm_models, interp=fp.interpolation_filter,
                device=self.device)
        if any(d.bsize != cc.BLOCK_16X16 for d in decisions.values()):
            flens = dlf_stage.flens_from_maps(
                dlf_stage.maps_from_decisions(decisions, self.sp.height // 4,
                                              coded_w // 4),
                device=self.device)
            recon = dlf_stage.apply_masked(recon, fp, flens)
        else:
            recon = apply_loop_filter(recon, fp)
        if self.sp.enable_cdef:
            skip16 = _skip_map(decisions, self.sp.height // 16, coded_w // 16)
            skip8 = _skip_map8(decisions, self.sp.height // 8, coded_w // 8)
            recon = cdef_stage.cdef_apply(recon, skip16, fp.cdef_strengths,
                                          fp.cdef_damping,
                                          bd=self.sp.bit_depth, skip8=skip8)
        refresh = fp.refresh_frame_flags
        if fp.frame_type == obu.KEY_FRAME and fp.show_frame:
            refresh = 0xFF
        end_cdfs = (tdec.cdfs if not fp.disable_frame_end_update_cdf
                    else init_cdfs)
        end_nmv = (tdec.nmv if not fp.disable_frame_end_update_cdf
                   else init_nmv)
        stored = {k: recon[k] for k in ("y", "u", "v")}
        field = None
        if refresh:
            hints = ({} if is_intra else
                     {e: fp.ref_hints[e - 1] for e in range(1, 8)})
            side = (mv_pred.ref_frame_side(hints, fp.order_hint,
                                           self.sp.order_hint_bits)
                    if not is_intra else [0] * 8)
            field = mv_pred.save_motion_field(
                decisions, (self.sp.height + 3) >> 2, (coded_w + 3) >> 2,
                side, tuple(hints.get(e, 0) for e in range(1, 8)),
                fp.order_hint, is_intra)
        for i in range(8):
            if refresh & (1 << i):
                self.slots[i] = stored
                self.slot_cdfs[i] = end_cdfs
                self.slot_nmv[i] = end_nmv
                self.slot_hints[i] = fp.order_hint
                self.slot_mvfield[i] = field
        self.last_decisions = decisions
        self.last_frame_header = fp
        if not fp.show_frame:
            return None, False
        out = {k: v.cpu().numpy() for k, v in stored.items()}
        out["decisions"] = decisions
        return out, True
