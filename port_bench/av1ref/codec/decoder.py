"""Verification decoder for the port's streams: key and inter frames, the
port of svt_av1_tpu/codec/decoder.py.

OBU parsing, the frame header and the tile syntax are the port's copies of
the reference's numpy code (``obu.parse_obus``, ``obu.read_frame_header``,
``TileDecoder``).  The 8 DPB slots keep their frame's planes on ``device``
(default: the current CUDA device) with its saved CDFs, MV context and
order hint; show_existing_frame outputs a slot.  Key frames reconstruct
through ``reconstruct_from_decisions`` (filter-intra and every luma
mode, 16x16 / 32x32 / 64x64 leaves, each block at its own qindex where
the frame codes delta-q), inter frames (LAST, GOLDEN and ALTREF
references) through
``reconstruct_inter_from_decisions`` (translational, GLOBALMV warp,
compound average / wedge / diffwtd, skip mode, the merged skip leaves,
8x8 split leaves, OBMC and inter-intra), followed by DLF at the header's
levels (mask-aware where block sizes are mixed), CDEF (frame-uniform,
or per superblock with the cdef_idx each SB codes when cdef_bits > 0),
the superres upscale (spec 7.16) and loop restoration with the units the
tile codes (pipeline/lr_stage.apply_lr, boundary rows from the upscaled
deblocked planes).  Key frames with segmentation (SEG_LVL_ALT_Q) take
each block's segment qindex.
Each slot also keeps its frame's saved motion field, which TMVP
(use_ref_frame_mvs) projects.  A key frame of several tile columns (what
the all-intra array route codes with tile_columns) decodes tile by tile,
each with its own contexts and CDFs, and reconstructs with
tile-clamped intra availability; the frame-end CDFs are tile 0's.
Metadata OBUs (HDR content light level, mastering display) are parsed
into ``metadata`` by type.  Shown planes are copied out once, filtered
(uint8, or uint16 at 10 bits).  10-bit frames, key and inter, reconstruct
and filter at the sequence's bit depth (int16 planes on the device), S-frames
(error resilient, refresh-all) decode as inter frames, and the reduced
still-picture header (AVIF) is read.  What still raises, naming its
ROADMAP.md item: 1/8-pel MVs, superres on inter frames, tile rows, and
tile columns on inter frames (the reference's encoder codes none of these
on the paths the port has).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import dataclasses

import numpy as np

from av1ref import device as device_mod
from av1ref.codec import lr as lr_mod
from av1ref.codec import mv as mv_mod
from av1ref.codec import mv_pred, obu
from av1ref.codec.syntax import TileDecoder
from av1ref.codec import constants as cc
from av1ref.ops import resize
from av1ref.pipeline import cdef_stage, dlf_stage, lr_stage
from av1ref.pipeline.inter_encoder import (
    reconstruct_inter_from_decisions)
from av1ref.pipeline.intra_encoder import (
    apply_loop_filter, host_plane, reconstruct_from_decisions)
from av1ref.utils.bitio import BitReader


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
    true extent (an 8x8 unit is skipped iff all its mi are skip)."""
    m = np.zeros((gh8, gw8), bool)
    for d in decisions.values():
        nw = max(1, int(cc.block_size_wide[d.bsize]) >> 3)
        nh = max(1, int(cc.block_size_high[d.bsize]) >> 3)
        by, bx = d.r4 // 2, d.c4 // 2
        m[by:by + nh, bx:bx + nw] = d.skip
    return m


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
        # parsed metadata OBUs by metadata_type (HDR CLL / MDCV)
        self.metadata: dict = {}
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
                frames.append({k: host_plane(v)
                               for k, v in self.slots[idx].items()})
            elif obu_type == obu.OBU_METADATA:
                mtype, fields = obu.parse_metadata(payload)
                self.metadata[mtype] = fields
            else:
                raise NotImplementedError(f"OBU type {obu_type}")
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
        bd = self.sp.bit_depth
        if n_tiles > 1:
            return self._decode_frame_tiled(fp, tile_data, coded_w, n_tiles)
        if not is_intra and fp.superres_denom != 8:
            raise NotImplementedError(
                "superres on inter frames (scaled-reference motion "
                "compensation): ROADMAP.md queue A item 7")
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
            if fp.allow_high_precision_mv:
                tdec.mv_precision = mv_mod.MV_SUBPEL_HIGH
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
        if fp.segmentation is not None:
            tdec.set_segmentation(fp.segmentation)
        if fp.cdef_bits:
            tdec.set_cdef(fp.cdef_bits)
        lr_info = None
        if self.sp.enable_restoration:
            w, h = self.sp.width, self.sp.height
            cw, ch = (w + 1) >> 1, (h + 1) >> 1
            csize = fp.lr_unit_size >> (1 if fp.lr_uv_half else 0)
            lr_info = [
                lr_mod.PlaneLrInfo(fp.lr_types[0], fp.lr_unit_size, w, h),
                lr_mod.PlaneLrInfo(fp.lr_types[1], csize, cw, ch),
                lr_mod.PlaneLrInfo(fp.lr_types[2], csize, cw, ch),
            ]
            tdec.set_lr(lr_info)
        if fp.delta_q_present:
            tdec.set_delta_q(fp.delta_q_res)
        decisions = tdec.decode(tile_data)
        if is_intra:
            recon = reconstruct_from_decisions(decisions, coded_w,
                                               self.sp.height,
                                               fp.base_q_idx, bd=bd,
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
                bd=bd, gm=gm_models, interp=fp.interpolation_filter,
                device=self.device)
        if any(d.bsize != cc.BLOCK_16X16 for d in decisions.values()):
            flens = dlf_stage.flens_from_maps(
                dlf_stage.maps_from_decisions(decisions, self.sp.height // 4,
                                              coded_w // 4),
                device=self.device)
            recon = dlf_stage.apply_masked(recon, fp, flens, bd=bd)
        else:
            recon = apply_loop_filter(recon, fp)
        deblocked = recon
        if self.sp.enable_cdef:
            skip16 = _skip_map(decisions, self.sp.height // 16, coded_w // 16)
            skip8 = _skip_map8(decisions, self.sp.height // 8, coded_w // 8)
            if fp.cdef_bits:
                recon = cdef_stage.cdef_apply(
                    recon, skip16, fp.cdef_strength_list, fp.cdef_damping,
                    bd=bd, sb_idx=tdec.cdef_idx, skip8=skip8)
            else:
                recon = cdef_stage.cdef_apply(
                    recon, skip16, fp.cdef_strengths, fp.cdef_damping,
                    bd=bd, skip8=skip8)
        if fp.superres_denom != 8:
            recon = resize.upscale_frame(recon, self.sp.width, bd)
            deblocked = resize.upscale_frame(deblocked, self.sp.width, bd)
        if lr_info is not None:
            recon = lr_stage.apply_lr(recon, deblocked, lr_info, bd=bd)
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
        out = {k: host_plane(v) for k, v in stored.items()}
        out["decisions"] = decisions
        return out, True

    def _decode_frame_tiled(self, fp, tile_data: bytes, coded_w: int,
                            n_tiles: int):
        """A key frame of several tile columns: split the tile group
        (4-byte tile sizes), decode each tile with its own contexts and
        CDFs, merge the decisions, reconstruct with tile-clamped intra
        availability, then DLF and frame-uniform CDEF at the header's
        values.  The frame refreshes every slot with tile 0's frame-end
        CDFs (context_update_tile_id = 0)."""
        if fp.frame_type != obu.KEY_FRAME or fp.log2_tile_rows:
            raise NotImplementedError(
                "tile rows, and tile columns on frames other than key "
                "frames: ROADMAP.md queue A item 7")
        if fp.cdef_bits or fp.superres_denom != 8 or any(
                t != lr_mod.RESTORE_NONE for t in fp.lr_types):
            raise NotImplementedError(
                "per-SB CDEF, superres or loop restoration with tile "
                "columns: ROADMAP.md queue A item 7")
        if tile_data[0] & 0x80:
            raise ValueError("tile_start_and_end_present_flag in an "
                             "OBU_FRAME")
        pos = 1
        tiles = []
        for _ in range(n_tiles - 1):
            sz = int.from_bytes(tile_data[pos:pos + 4], "little") + 1
            pos += 4
            tiles.append(tile_data[pos:pos + sz])
            pos += sz
        tiles.append(tile_data[pos:])
        layout = obu.tile_cols_layout(coded_w, fp.log2_tile_cols)
        decisions = {}
        t0 = None
        for (s, e), data in zip(layout, tiles):
            tdec = TileDecoder(min(e * 64, coded_w) - s * 64, self.sp.height,
                               fp.base_q_idx,
                               reduced_tx_set=fp.reduced_tx_set,
                               update_cdfs=not fp.disable_cdf_update,
                               frame_is_intra=True)
            tdec.enable_filter_intra = self.sp.enable_filter_intra
            tdec.allow_palette = bool(fp.allow_screen_content_tools)
            tdec.bit_depth = self.sp.bit_depth
            if t0 is None:
                t0 = tdec
            for (r4, c4), d in tdec.decode(data).items():
                decisions[(r4, c4 + s * 16)] = dataclasses.replace(
                    d, c4=c4 + s * 16)
        end_cdfs = end_nmv = None
        if not fp.disable_frame_end_update_cdf:
            end_cdfs, end_nmv = t0.cdfs, t0.nmv
        recon = reconstruct_from_decisions(
            decisions, coded_w, self.sp.height, fp.base_q_idx,
            bd=self.sp.bit_depth, device=self.device,
            tile_starts=tuple(s * 4 for s, _ in layout))
        recon = apply_loop_filter(recon, fp)
        if self.sp.enable_cdef:
            recon = cdef_stage.cdef_apply(
                recon, _skip_map(decisions, self.sp.height // 16,
                                 coded_w // 16),
                fp.cdef_strengths, fp.cdef_damping, bd=self.sp.bit_depth)
        stored = {k: recon[k] for k in ("y", "u", "v")}
        for i in range(8):
            self.slots[i] = stored
            self.slot_cdfs[i] = end_cdfs
            self.slot_nmv[i] = end_nmv
            self.slot_hints[i] = fp.order_hint
            self.slot_mvfield[i] = None
        self.last_decisions = decisions
        self.last_frame_header = fp
        if not fp.show_frame:
            return None, False
        out = {k: host_plane(v) for k, v in stored.items()}
        out["decisions"] = decisions
        return out, True
